"""The dense cluster kernels K1 (``dense_resident``), K2 (``dense``) and K3
(``dense_super``), and the glue's fused multiply-add (``fma``) and RNG hash
(``threefry``): each module's wrapper launches its CUDA kernel on CUDA
tensors and counts the launches in ``launches``; its plain version runs on
CPU tensors and counts its calls in ``calls``. The FMA wrapper also counts
in ``expanded`` the launches that needed an operand expanded on the card
first."""


def kernel_counts() -> dict:
    """The kernel wrappers' launches and the plain versions' calls so far in
    this process."""
    from . import dense as k2
    from . import dense_resident as k1
    from . import dense_super as k3
    from . import fma, threefry

    return dict(
        k1_launches=k1.dense_intersect_resident.launches,
        k2_launches=k2.dense_intersect.launches,
        k3_launches=k3.dense_intersect_super.launches,
        plain_calls=(k1.dense_intersect_resident_plain.calls
                     + k2.dense_intersect_plain.calls
                     + k3.dense_intersect_super_plain.calls),
        fma_launches=fma.fma.launches,
        fma_expanded=fma.fma.expanded,
        fma_plain_calls=fma.fma_plain.calls,
        threefry_launches=threefry.threefry.launches,
        threefry_plain_calls=threefry.threefry_plain.calls)
