"""repro_torch — tunable precision emulation via automatic BLAS offloading,
ported to PyTorch and CUDA for an NVIDIA H100.

A second package beside the JAX reference ``repro``: it imports torch
and numpy and nothing of JAX or of ``repro``.  Entry points run on the
card unless the caller passes ``device="cpu"``.

Package map:
  * ``repro_torch.core``    — Ozaki INT8 split-GEMM engine, precision
    policies, the backend registry and eager matmul offload;
  * ``repro_torch.kernels`` — the CUDA split-GEMM kernels (built from
    ``kernels/csrc`` at first use), their plain versions and the tile
    rule;
  * ``repro_torch.apps``    — the MuST Green's-function contour study;
  * ``repro_torch.configs`` — the LM presets (``smollm_360m`` and the
    test sizes);
  * ``repro_torch.models``  — the decoder-only LM, its serving programs
    and the reference's seeded draws (``models.prng``);
  * ``repro_torch.serve``   — the continuous-batching engine (paged or
    dense KV cache, chunked prefill, fifo/edf admission);
  * ``repro_torch.train``   — synthetic data, AdamW and npz checkpoints
    (the reference's file format);
  * ``repro_torch.launch``  — the trainer, ``python -m
    repro_torch.launch.train``;
  * ``repro_torch.shard``   — meshes of processes (one rank per mesh
    position, gloo or NCCL), the LM's axis rules and the gradient
    all-reduce of the dp×tp train step;
  * ``repro_torch.tune``    — precision plans: calibrate, solve, the
    plan artifact, ``python -m repro_torch.tune``;
  * ``repro_torch.obs``     — telemetry: metrics registry, spans, JSONL
    runs, the numerics drift probe, live ``/metrics``, cost attribution,
    ``python -m repro_torch.obs``;
  * ``repro_torch.analysis`` — the roofline model, priced by the H100.
"""

__version__ = "0.1.0"
