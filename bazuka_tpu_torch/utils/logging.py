"""In-process log ring buffer served at GET /logs
(reference: src/lib.rs:6-19, src/node/api/get_logs.rs).
A copy of `bazuka_tpu/utils/logging.py` with a logger and a ring buffer
of its own (`"bazuka_tpu_torch"`), so `GET /logs` of one package never
shows the other's lines.
"""

from __future__ import annotations

import logging
import time
from collections import deque

GLOBAL_LOGS: deque = deque(maxlen=1000)


def report_log(msg: str):
    GLOBAL_LOGS.append(f"{time.strftime('%H:%M:%S')} {msg}")


class RingBufferHandler(logging.Handler):
    def emit(self, record):
        try:
            GLOBAL_LOGS.append(self.format(record))
        except Exception:
            pass


logger = logging.getLogger("bazuka_tpu_torch")
if not logger.handlers:
    _h = RingBufferHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
