"""Render configuration.

The reference configures everything at compile time: a #define block
(IMAGE 512x512, NUM_SAMPLES=100, NUM_BOUNCES=3, kernel.cu:28-35) plus
hard-coded scene and camera in main() (kernel.cu:590-648). This dataclass is
the replacement (SURVEY.md §5.6): one frozen, hashable config object.

Note the reference's sample loop runs sampleNum = 1..NUM_SAMPLES-1, i.e.
NUM_SAMPLES=100 accumulates 99 samples (kernel.cu:709-710). Our ``spp`` is
the honest count of samples actually accumulated.

The PyTorch port keeps the JAX package's fields, defaults and accepted
values unchanged, so a config means the same thing in both packages.
``check_supported`` rejects every value the port does not implement yet,
among them any ``packet_engine`` but 'auto' (the engine follows the
tensors: the CUDA kernel on CUDA tensors, its plain version on CPU tensors)
and any non-default value of the knobs that tune only the TPU kernels'
schedule (``SCHEDULE_KNOBS``).
"""

from __future__ import annotations

from dataclasses import dataclass, fields


@dataclass(frozen=True)
class RenderConfig:
    width: int = 512
    height: int = 512
    spp: int = 99                   # reference-equivalent default (see above)
    num_bounces: int = 3            # kernel.cu:33
    integrator: str = "bdpt"        # 'bdpt' (live, kernel.cu:549) | 'pt_nee'
    traversal: str = "packets"      # 'packets' | 'bvh' | 'brute'
    leaf_size: int = 4
    samples_per_call: int = 1       # progressive granularity (checkpoint unit)
    sample_batch: int = 1           # samples whose bounce rays are traced as
    #                                 one jointly sorted batch (not ported)
    # packet-traversal knobs (ops/packets.py)
    tile_size: int | None = None    # rays per packet tile; None = auto by
    #                                 cluster size (render/renderer.py)
    tile_size_vis: int | None = None  # tile size of visibility traces
    #                                 (BDPT; not ported)
    vis_dropout: bool = False       # occluded-lane dropout in visibility
    #                                 traces (not ported)
    cluster_size: int | None = None  # triangles per scene cluster; None =
    #                                  adaptive (renderer.adaptive_cluster_size)
    max_clusters: int = 4095        # shortlist cap per tile; rays whose hit
    #                                 may lie in a dropped cluster fall back
    #                                 to the fine BVH
    packet_sort: bool = True        # sort rays by octant + origin Morton code
    packet_rounds: int = 1          # straggler rounds (one only)
    packet_first_round: int = 2     # round-1 candidate budget (not ported)
    packet_rounds_bdpt: int = 1     # straggler rounds of BDPT's traces
    #                                 (not ported)
    packet_engine: str = "auto"     # 'auto' only (module docstring)
    two_level_cull: bool | str | None = None  # False = flat cull;
    #                                 'super' = supercluster shortlists;
    #                                 True = capped two-level cull (not
    #                                 ported); None = auto (ops/packets.route)
    super_factor: int = 8           # clusters per supercluster
    super_slots: int = 16           # two-level expansion slots (not ported)
    super_list: int = 255           # supers per 'super' shortlist
    sort_window: int = 0            # ray-sort window (0 = one global sort;
    #                                 windows are not ported)
    warm_start: int | None = None   # TPU kernel schedule (not ported)
    ray_groups: int | None = None   # TPU kernel schedule (not ported)
    intersector: str = "bw"         # triangle test: 'bw' (Baldwin-Weber
    #                                 precomputed form) | 'mt' (the reference's
    #                                 Moller-Trumbore, modelLoader.h:49-123);
    #                                 the packet engine runs 'bw' only
    # quirk flags (defaults = reference behavior; SURVEY.md §7 ledger)
    orthonormal_frame: bool = False
    light_normal_mode: str = "fixed"
    branch_pdf_correction: bool = False
    jitter: bool = False
    # accumulation
    compensated_accum: bool = True  # Kahan compensation (reference uses f64)
    # primary rays are identical every sample when the camera is a pinhole
    # (radius == 0) and jitter is off — the reference's exact live config
    # (kernel.cu:646, no sub-pixel jitter). With this flag the renderer
    # traces them once per batch instead of once per sample. render() sets
    # it for such a camera; only valid under the pinhole/no-jitter condition.
    reuse_primary_hit: bool = False

    @property
    def num_pixels(self):
        return self.width * self.height

    def __post_init__(self):
        for name in ("width", "height"):
            v = getattr(self, name)
            if v <= 0 or v & (v - 1):
                raise ValueError(f"{name}={v}: must be a power of two "
                                 "(Morton indexing)")
        choices = (("integrator", ("bdpt", "pt_nee")),
                   ("traversal", ("packets", "bvh", "brute")),
                   ("light_normal_mode", ("fixed", "true")),
                   ("packet_engine", ("auto", "pallas", "xla",
                                      "pallas_interpret")),
                   ("intersector", ("bw", "mt")))
        for name, allowed in choices:
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name}={getattr(self, name)!r}: expected "
                                 f"one of {allowed}")


# knobs of the JAX package's TPU kernel schedule, capped two-level cull and
# BDPT traces; the port raises unless they keep their defaults
SCHEDULE_KNOBS = ("tile_size_vis", "packet_first_round", "packet_rounds_bdpt",
                  "super_slots", "warm_start", "ray_groups")


def check_supported(cfg: RenderConfig) -> None:
    """Raise NotImplementedError, naming the knob, for a value the port
    does not implement: everything outside the PT+NEE packet path with the
    flat or super cull and one round. The scene-dependent limit (the auto
    cull's capped two-level choice past K = 2048 clusters when the scene
    does not allow super shortlists) is checked where K and C are known
    (ops/packets.route)."""
    if cfg.traversal != "packets":
        raise NotImplementedError(
            f"traversal={cfg.traversal!r}: the port renders through the "
            "packet engine only")
    if cfg.integrator != "pt_nee":
        raise NotImplementedError(
            f"integrator={cfg.integrator!r}: the port renders pt_nee only")
    if cfg.packet_rounds > 1:
        raise NotImplementedError(
            f"packet_rounds={cfg.packet_rounds}: one round only")
    if cfg.sample_batch > 1:
        raise NotImplementedError(
            f"sample_batch={cfg.sample_batch}: one sample per trace only")
    if cfg.sort_window > 0:
        raise NotImplementedError(
            f"sort_window={cfg.sort_window}: one global ray sort only")
    if cfg.two_level_cull not in (None, False, "super"):
        raise NotImplementedError(
            f"two_level_cull={cfg.two_level_cull!r}: the capped two-level "
            "cull is not ported (flat, 'super' or auto only)")
    if cfg.super_factor < 1:
        raise ValueError(f"super_factor={cfg.super_factor}: must be >= 1")
    if cfg.vis_dropout:
        raise NotImplementedError("vis_dropout=True: not ported")
    if cfg.intersector != "bw":
        raise NotImplementedError(
            f"intersector={cfg.intersector!r}: the packet engine runs the "
            "Baldwin-Weber test only")
    if cfg.packet_engine != "auto":
        raise NotImplementedError(
            f"packet_engine={cfg.packet_engine!r}: the port's engine is "
            "'auto' only (the CUDA kernel on CUDA tensors, its plain version "
            "on CPU tensors)")
    defaults = {f.name: f.default for f in fields(RenderConfig)}
    for name in SCHEDULE_KNOBS:
        if getattr(cfg, name) != defaults[name]:
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)!r}: not ported (only the "
                f"default, {defaults[name]!r})")
