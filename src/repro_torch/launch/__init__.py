"""repro_torch.launch: command-line drivers.

  serve  - batched prefill + decode of an LM behind the two-level request
           scheduler (`python -m repro_torch.launch.serve`)
"""
