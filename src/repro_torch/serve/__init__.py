"""repro_torch.serve: concurrent request admission over a GraphSession.

  ConcurrentServeScheduler, RequestStream, Request - the two-level policy
                                                     applied to admission
"""

from repro_torch.serve.concurrent import (ConcurrentServeScheduler, Request,
                                          RequestStream)

__all__ = ["ConcurrentServeScheduler", "Request", "RequestStream"]
