"""One client, closed loop: the next request goes out when the last one has
returned, as a CLI, gradio or ``/v1/image`` user waits for one image at a
time.

The request kind (``requests/<kind>.py``, its ``Session``) loads the
workload's inputs, draws the order of its requests from the seed (every
seed sends the same set of requests, in another order, so the work does
not depend on it), warms up the shapes they use and sends each one. The
window runs from its first request to the return of the last one started
within ``seconds``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict


def run(params: Dict, seed: int, seconds: float, root: str, session,
        sync: Callable[[], None], trace: bool) -> Dict:
    """Set-up's last part (the inputs and the warm-up), then the window.
    Returns the end of set-up, the window's seconds and one record a
    window request."""
    session.load(root)
    items = session.draw(seed)
    session.warm_up(items)
    sync()
    setup_end = time.perf_counter()
    records = []
    start = time.perf_counter()
    for i, item in enumerate(items):
        t0 = time.perf_counter()
        if t0 - start >= seconds:
            break
        traced = session.reader.start_request(i, trace)
        try:
            out, timings = session.send(item)
            error = None
        except Exception as exc:  # a failed request counts as failed, the loop goes on
            out, timings, error = None, {}, f"{type(exc).__name__}: {exc}"
        t1 = time.perf_counter()
        cap = session.reader.finish_request()
        records.append({"item": item, "wall_s": t1 - t0, "timings": timings, "out": out,
                        "captures": cap, "error": error, "traced": traced})
        end = t1
    else:
        raise RuntimeError(f"{len(items)} requests did not fill {seconds} s")
    return {"setup_end": setup_end, "window_s": end - start, "records": records}
