"""repro_torch.launch: command-line drivers and meshes.

  serve  - batched prefill + decode of an LM behind the two-level request
           scheduler (`python -m repro_torch.launch.serve`)
  train  - the fault-tolerant training loop (`python -m
           repro_torch.launch.train`)
  mesh   - named device axes (`make_host_mesh`, `make_production_mesh`)
"""
