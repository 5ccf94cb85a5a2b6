"""The comparisons that decide ``correct``: what the window produced against
the plain reference (``reference/``), which works everything out again
from the scene's arrays and the keys. Each kind of mix (``kinds/``) picks
its comparison from these and its limits from ``limits/<cell>.json``:

* ``progressive``: each image the window left (the last finished one and
  the one in progress), at the sample of pixels the driver drew from the
  seed: the program's running mean against the reference's float64 mean
  of the same samples. ``pixels_off_pct``: the share of those pixels lit
  on either side (BDPT leaves most pixels black in an image of few
  samples) where a channel differs by more than ``RTOL`` of the pixel's
  largest reference channel plus ``ATOL``, the largest over the images. A
  path that flips between the two float32 renderings (a hit on a shared
  edge) moves one pixel whatever the size of its sample, so the share
  counts flips, where a sum of differences would follow the size of the
  one brightest flipped sample.
* ``train``: set-up's first steps, which ran through the window's own
  call, against the reference following the same steps. ``loss_gap``: the
  largest |loss - reference| / |reference| over the steps. ``grad_gap``
  and ``change_gap``: over the parameter leaves, the largest gap between
  the program's and the reference's norm of a leaf's first gradient (as
  the update took it) or of its change over the steps, over the larger of
  the reference's norm of that leaf and of the median leaf. A leaf whose
  reference norm is under a thousandth of the median leaf's is nought to
  rounding (it moves by round-off alone) and is not compared.

The control puts the reference computed in bfloat16 in the program's
place (each kind's ``control_readings``).
"""

from __future__ import annotations

import statistics

import torch

from .reference import integrators, inverse, scene


def _geometry(arrays, dtype):
    f = {k: (v if k in ("tris", "tri_mats") else v.to(dtype))
         for k, v in arrays.items()}
    return scene.make_geometry(f["verts"], f["tris"], f["tri_mats"],
                               f["albedo"], f["emission"])


def reference_images(outputs, config, traffic, arrays, dtype):
    """The reference's mean at the checked pixels of each image."""
    g = _geometry(arrays, dtype)
    dev = arrays["verts"].device
    idx = outputs["idx"].to(dev)
    out = []
    for key, n, _ in outputs["images"]:
        out.append(integrators.render_samples(
            g, config["camera"], traffic["size"], traffic["size"],
            config["render"]["integrator"], key.to(dev), range(n), idx,
            dtype, config["render"].get("num_bounces", 3)).cpu())
    return out


RTOL = 1e-2
ATOL = 1e-4


def image_gaps(got, want):
    """-> (pixels_off_pct, image_rel_l1), each the largest over the
    images; the second, sum |got - want| / sum |want|, is logged only."""
    share = rel = 0.0
    for a, b in zip(got, want):
        a, b = a.double(), b.double()
        tol = RTOL * b.abs().amax(-1, keepdim=True) + ATOL
        off = ((a - b).abs() > tol).any(-1)
        lit = (a != 0).any(-1) | (b != 0).any(-1)
        share = max(share, 100.0 * float(off.sum()) / max(int(lit.sum()), 1))
        den = float(b.abs().sum())
        gap = float((a - b).abs().sum())
        rel = max(rel, gap / den if den else gap)
    return share, rel


def compare_images(got, want) -> dict:
    return {"pixels_off_pct": image_gaps(got, want)[0]}


def _leaf_norms(by_param: dict) -> dict:
    return {f"{k}.{c}": float(v[:, j].double().norm())
            for k, v in by_param.items() for j, c in enumerate("xyz")}


def _gap(got: dict, want: dict) -> float:
    """The largest norm gap over the counted leaves of ``want``."""
    m = statistics.median(want.values())
    worst = 0.0
    for k, w in want.items():
        if w < 1e-3 * m:
            continue
        worst = max(worst, abs(got[k] - w) / max(w, m))
    return worst


def reference_steps(outputs, config, traffic, arrays, dtype) -> dict:
    dev = arrays["verts"].device
    r = inverse.follow(arrays, config["camera"], traffic["size"],
                       [k.to(dev) for k in outputs["keys"]],
                       outputs["target_key"].to(dev), traffic["lr"], dtype,
                       config["render"].get("num_bounces", 3))
    return dict(losses=r["losses"], grads=_leaf_norms(r["first_grad"]),
                change=_leaf_norms(r["change"]))


def compare_steps(got: dict, want: dict) -> dict:
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   want["losses"]))
    return {"loss_gap": loss,
            "grad_gap": _gap(got["grads"], want["grads"]),
            "change_gap": _gap(got["change"], want["change"])}


def program_steps(outputs) -> dict:
    """The program's leaves as the reference names them (the empty sphere
    leaves of a scene without spheres dropped)."""
    def norms(ts):
        return {n: float(t.double().norm()) for n, t in
                zip(outputs["names"], ts) if t is not None and t.numel()}
    return dict(losses=outputs["losses"], grads=norms(outputs["grads"]),
                change=norms(outputs["change"]))


def verdict(numbers: dict, limits: dict):
    """-> (correct, {name: {"value", "limit"}}): every number finite and
    at most its limit; a number without a limit fails."""
    out, ok = {}, True
    for k, v in numbers.items():
        lim = limits.get(k)
        out[k] = {"value": v, "limit": lim}
        ok = ok and lim is not None and v == v and v <= lim
    return ok, out
