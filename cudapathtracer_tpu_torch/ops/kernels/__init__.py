"""The dense cluster kernels K1 (``dense_resident``), K2 (``dense``) and K3
(``dense_super``): each module's wrapper launches its CUDA kernel on CUDA
tensors and counts the launches in ``launches``; its plain version runs on
CPU tensors and counts its calls in ``calls``."""


def kernel_counts() -> dict:
    """The kernel wrappers' launches and the plain versions' calls so far in
    this process."""
    from . import dense as k2
    from . import dense_resident as k1
    from . import dense_super as k3

    return dict(
        k1_launches=k1.dense_intersect_resident.launches,
        k2_launches=k2.dense_intersect.launches,
        k3_launches=k3.dense_intersect_super.launches,
        plain_calls=(k1.dense_intersect_resident_plain.calls
                     + k2.dense_intersect_plain.calls
                     + k3.dense_intersect_super_plain.calls))
