"""The device batch plane — one verify scheduler for every producer (see
`scheduler.py` for the contract)."""

from tendermint_tpu_torch.batchplane.scheduler import (BatchPlane,
                                                       CLASS_CONSENSUS,
                                                       CLASS_FASTSYNC,
                                                       CLASS_LIGHT,
                                                       CLASS_MEMPOOL,
                                                       CLASS_PRIORITY,
                                                       DEFAULT_WAIT,
                                                       Submission)

__all__ = ["BatchPlane", "CLASS_CONSENSUS", "CLASS_FASTSYNC",
           "CLASS_LIGHT", "CLASS_MEMPOOL", "CLASS_PRIORITY", "DEFAULT_WAIT",
           "Submission"]
