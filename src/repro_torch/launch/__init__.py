"""repro_torch.launch: command-line drivers and meshes.

  serve  - batched prefill + decode of an LM behind the two-level request
           scheduler (`python -m repro_torch.launch.serve`)
  train  - the fault-tolerant training loop (`python -m
           repro_torch.launch.train`)
  mesh   - named device axes (`make_host_mesh`, `make_production_mesh`)
  specs  - a cell: one (architecture x shape) step, its arguments and
           placements
  dryrun - what one device of a production mesh holds, computes and
           sends, from the step run on the meta device in a fake world
           (`python -m repro_torch.launch.dryrun`); `report` renders its
           records, `hillclimb` re-runs a cell under a named variant,
           `cost` holds the collective and roofline accounting
"""
