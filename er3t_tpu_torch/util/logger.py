"""Structured logging (copy of ``er3t_tpu/util/logger.py:9-61``):
``Er3tLogger`` with console and optional file handlers, a FRAMEWORK level
between INFO and WARNING, and tic/toc throughput timers.
"""

from __future__ import annotations

import logging
import time

__all__ = ['Er3tLogger', 'get_logger', 'FRAMEWORK']

FRAMEWORK = 25
logging.addLevelName(FRAMEWORK, 'FRAMEWORK')


class Er3tLogger(logging.Logger):
    """Logger with a FRAMEWORK level and simple throughput timers."""

    def __init__(self, name='er3t_tpu', verbose=True, fname=None,
                 level=logging.INFO):
        super().__init__(name, level)
        fmt = logging.Formatter(
            '%(asctime)s [%(levelname)s] %(name)s: %(message)s', '%H:%M:%S')
        if verbose:
            h = logging.StreamHandler()
            h.setFormatter(fmt)
            self.addHandler(h)
        if fname:
            fh = logging.FileHandler(fname)
            fh.setFormatter(fmt)
            self.addHandler(fh)
        self._timers: dict[str, float] = {}

    def framework(self, msg, *args, **kw):
        if self.isEnabledFor(FRAMEWORK):
            self._log(FRAMEWORK, msg, args, **kw)

    def tic(self, tag='default'):
        self._timers[tag] = time.time()

    def toc(self, tag='default', n_items=None, unit='items'):
        dt = time.time() - self._timers.get(tag, time.time())
        if n_items:
            self.framework('%s: %.2fs (%.3g %s/s)', tag, dt, n_items / max(dt, 1e-9), unit)
        else:
            self.framework('%s: %.2fs', tag, dt)
        return dt


_default: Er3tLogger | None = None


def get_logger() -> Er3tLogger:
    global _default
    if _default is None:
        _default = Er3tLogger()
    return _default
