"""Console logging, a copy of ``feartracker_tpu/utils/logging.py``: plain
``logging`` with the ``FEAR_DEBUG`` environment switch to DEBUG."""

from __future__ import annotations

import logging
import os


def create_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s[%(process)d] %(levelname)s %(message)s")
        )
        logger.addHandler(handler)
        level = logging.DEBUG if os.environ.get("FEAR_DEBUG") else logging.INFO
        logger.setLevel(level)
        logger.propagate = False
    return logger
