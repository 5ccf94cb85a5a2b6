"""Milliseconds of a pass's gather of the image to every rank: rank 0's
span around each pass's ``parallel/mesh.gather_pixels``, synchronized at
both ends, its mean over the timed part of the traced window."""


def read(r):
    s = r.spans.get("gather")
    if not s:
        return None
    return 1e3 * sum(s) / len(s)
