"""Rank side of tests/test_torch_train_dist.py (imports no JAX): the
compressed data-parallel gradient on a gloo world, each rank on its own
contiguous shard of the batch."""

import numpy as np
import torch

from repro_torch.dist.compression import make_compressed_grad_fn
from repro_torch.launch.mesh import make_mesh


def loss_fn(params, batch):
    return torch.mean((batch @ params["w"]) ** 2)


def compressed_grads(rank: int, w: np.ndarray, batch: np.ndarray,
                     err: np.ndarray) -> dict:
    n = torch.distributed.get_world_size()
    mesh = make_mesh((n,), ("data",), [torch.device("cpu")] * n)
    fn = make_compressed_grad_fn(mesh, loss_fn)
    shard = np.array_split(batch, n)[rank]
    loss, grads, new_err = fn({"w": torch.from_numpy(w)},
                              {"w": torch.from_numpy(err)},
                              torch.from_numpy(shard))
    return {"loss": float(loss), "grads": grads["w"].numpy(),
            "err": new_err["w"].numpy()}
