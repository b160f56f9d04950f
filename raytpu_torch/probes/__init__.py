"""Measurement probes, the port's counterparts of raytpu's ``probes/``
TPU kernels, as hand-written CUDA kernels (``render/csrc/probes.cu``):

  probe_smem      P1, the bare per-(ray, triangle) fold loop over triangles
                  in shared memory or read as a broadcast from device memory
  probe_dma_smem  P2, a worklist-driven ring of asynchronous copies into
                  shared memory (K11's design)

Each runs as a module (``python -m raytpu_torch.probes.probe_smem``) on the
CUDA card by default; ``--device cpu`` runs the plain versions.
"""
