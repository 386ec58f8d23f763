"""boxes_per_request: the boxes SAM's mask decoder decoded a request, the
mean over the window's completed requests (the harness counts them at
``sam.decode_masks``; program counter)."""


def read(ctx):
    rows = [r for r in ctx.records if r["error"] is None and r["out"] is not None]
    if not rows:
        return None
    return sum(r["captures"]["boxes"] for r in rows) / len(rows)
