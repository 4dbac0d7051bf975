"""Logging setup: colored console on process 0 + per-process log files.

Counterpart of `butd_detr_tpu/utils/logging.py` (reference
utils/logger.py:35-91, setup_logger): rank 0 logs to stdout with a colored
level prefix; every rank appends to ``log.txt[.rankN]`` under the log
directory. One logger per (output, rank, name): a second call with the same
arguments returns the first call's logger, with no second set of handlers.
"""

import functools
import logging
import os
import sys
from typing import Optional


class _ColorFormatter(logging.Formatter):
    COLORS = {
        logging.WARNING: "\x1b[33m",
        logging.ERROR: "\x1b[31m",
        logging.CRITICAL: "\x1b[31;1m",
        logging.DEBUG: "\x1b[36m",
    }
    RESET = "\x1b[0m"

    def format(self, record):
        msg = super().format(record)
        color = self.COLORS.get(record.levelno)
        return f"{color}{msg}{self.RESET}" if color else msg


@functools.lru_cache()
def setup_logger(
    output: Optional[str] = None,
    distributed_rank: int = 0,
    name: str = "butd_detr_tpu_torch",
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    fmt = logging.Formatter(
        "[%(asctime)s %(name)s] %(levelname)s: %(message)s",
        datefmt="%m/%d %H:%M:%S",
    )

    if distributed_rank == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(
            _ColorFormatter(
                "[%(asctime)s %(name)s] %(levelname)s: %(message)s",
                datefmt="%m/%d %H:%M:%S",
            )
        )
        logger.addHandler(ch)

    if output is not None:
        filename = (
            output if output.endswith(".txt") or output.endswith(".log")
            else os.path.join(output, "log.txt")
        )
        if distributed_rank > 0:
            filename = f"{filename}.rank{distributed_rank}"
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        fh = logging.FileHandler(filename)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)

    return logger
