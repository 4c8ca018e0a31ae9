"""The training log (own copy of aanet_tpu/utils/logging_util.py's role):
the logger ``aanet_torch.train``, with a file handler for ``log_file``."""
from __future__ import annotations

import logging
import os
from typing import Optional


def get_logger(log_file: Optional[str] = None) -> logging.Logger:
    """The ``aanet_torch.train`` logger at INFO, writing also to
    ``log_file`` (once, however often it is asked for)."""
    logger = logging.getLogger("aanet_torch.train")
    logger.setLevel(logging.INFO)
    if log_file and not any(getattr(h, "baseFilename", None) == os.path.abspath(log_file)
                            for h in logger.handlers):
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        handler = logging.FileHandler(log_file)
        handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(handler)
    return logger
