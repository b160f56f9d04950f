"""``render_image`` / ``render_image_f32`` route like raytpu's Pallas entry
points: K1 (``csrc/mega.cu``) for scenes of <= 72 primitives and <= 8
lights, K2a + K2b (``mega2.py``) up to 9,600 triangles, K3 + K4
(``packed.py``) up to 1M, K8 + K10 (``chunked.py``) past their sphere, plane
and light caps up to 32,768 triangles.  The eager path is
``raytpu_torch.render.renderer``.  ``launch_counts`` reads every kernel
wrapper's count, the probes' (``raytpu_torch.probes``) included."""

from raytpu_torch.render.cuda_kernel import render_image, render_image_f32  # noqa: F401
from raytpu_torch.render.renderer import generate_rays, render_image_ssaa  # noqa: F401


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, K1 to K11b and the probes P1, P2;
    K6's second kernel, its light sum, as K6sum."""
    from raytpu_torch.probes import probe_dma_smem, probe_smem
    from raytpu_torch.render import chunked, cuda_kernel, mega2, mega3, packed, soft

    return {"K1": cuda_kernel.MEGA_LAUNCHES, "K2a": mega2.MEGA2_CLOSEST_LAUNCHES,
            "K2b": mega2.MEGA2_SHADE_LAUNCHES, "K3": packed.PACKED_CLOSEST_LAUNCHES,
            "K4": packed.PACKED_ANYHIT_LAUNCHES, "K5": soft.SOFT_TRANS_LAUNCHES,
            "K6": soft.SOFT_DRAY_LAUNCHES, "K6sum": soft.SOFT_DRAY_SUM_LAUNCHES,
            "K7": soft.SOFT_DPRIM_LAUNCHES,
            "K8": chunked.CHUNKED_MIN_T_LAUNCHES, "K9": chunked.CHUNKED_ANYHIT_LAUNCHES,
            "K10": chunked.CHUNKED_SHADE_LAUNCHES, "K11a": mega3.MEGA3_CLOSEST_LAUNCHES,
            "K11b": mega3.MEGA3_SHADE_LAUNCHES, "P1": probe_smem.P1_LAUNCHES,
            "P2": probe_dma_smem.P2_LAUNCHES}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from raytpu_torch.probes import probe_dma_smem, probe_smem
    from raytpu_torch.render import chunked, cuda_kernel, mega2, mega3, packed, soft

    cuda_kernel.MEGA_LAUNCHES = 0
    mega2.MEGA2_CLOSEST_LAUNCHES = mega2.MEGA2_SHADE_LAUNCHES = 0
    packed.PACKED_CLOSEST_LAUNCHES = packed.PACKED_ANYHIT_LAUNCHES = 0
    soft.SOFT_TRANS_LAUNCHES = soft.SOFT_DRAY_LAUNCHES = soft.SOFT_DPRIM_LAUNCHES = 0
    soft.SOFT_DRAY_SUM_LAUNCHES = 0
    chunked.CHUNKED_MIN_T_LAUNCHES = chunked.CHUNKED_ANYHIT_LAUNCHES = 0
    chunked.CHUNKED_SHADE_LAUNCHES = 0
    mega3.MEGA3_CLOSEST_LAUNCHES = mega3.MEGA3_SHADE_LAUNCHES = 0
    probe_smem.P1_LAUNCHES = probe_dma_smem.P2_LAUNCHES = 0
