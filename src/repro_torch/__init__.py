"""repro_torch: the two-level concurrent graph engine in PyTorch + CUDA.

A port of the JAX package `repro` (which stays the reference) to one
NVIDIA Hopper GPU.  It mirrors `repro`'s layout and public names, so one
parity test can drive both packages:

  repro_torch.graph       - CSR, block-ELL tiles, destination-sorted pairs
  repro_torch.algorithms  - delta-based accumulative algorithms
  repro_torch.core        - priority pairs, DO queues, global queue, push,
                            schedule policies (host and device backends),
                            GraphSession, the engine shim and paper API
  repro_torch.kernels     - hand-written CUDA kernels: the fused superstep,
                            the multi-job block SpMM, the pair reduction
  repro_torch.models      - the LM architectures (dense, GQA, MoE, RG-LRU,
                            xLSTM, codebook and patch-prefix frontends)
  repro_torch.configs     - the ten architectures' configs and smoke sizes
  repro_torch.serve       - request admission and the LM ServeEngine
  repro_torch.train       - AdamW, LR schedules, the train step, checkpoints
  repro_torch.data        - deterministic step-indexed batches, prefetch
  repro_torch.tree        - JAX-order pytrees (the reference's leaf order)
  repro_torch.launch      - the serving and training drivers, meshes
  repro_torch.convert     - carry a reference run's graph/state, weights,
                            caches and train state into the port

Every entry point takes an explicit ``device``: ``None`` means CUDA and
raises when no CUDA device is present (pass ``device="cpu"`` to run the
plain PyTorch versions on the CPU).
"""

__version__ = "0.2.0"
