"""repro_torch.serve: concurrent request admission, and the LM serving engine.

  ConcurrentServeScheduler, RequestStream, Request - the two-level policy
                                                     applied to admission
  ServeEngine                                      - prefill + decode of an
                                                     LM over its KV cache
"""

from repro_torch.serve.concurrent import (ConcurrentServeScheduler, Request,
                                          RequestStream)
from repro_torch.serve.engine import ServeEngine

__all__ = ["ConcurrentServeScheduler", "Request", "RequestStream",
           "ServeEngine"]
