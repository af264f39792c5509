"""Logging / tracing / banner utilities.

Parity with the reference's observability (SURVEY.md §5): the PRINT_LEVEL
env-gated logging (src/cuda/cuda_utils.cu:44-63), the STARTCLOCK/CLOCK
per-phase wall timers (src/miraculix/Vector.matrix.D.cc:51,89-221), and the
compile banner with build info (cuda_utils.cu:65-82).  Adds a
jax.profiler trace hook — the device-side replacement for clock() deltas.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, Iterator, List, Optional, Tuple


def print_level() -> int:
    """Env-gated verbosity (reference PRINT_LEVEL / get_print_level)."""
    try:
        return int(os.environ.get("MIRACULIX_TPU_PRINT_LEVEL",
                                  os.environ.get("PRINT_LEVEL", "0")))
    except ValueError:
        return 0


def debug_info(msg: str, level: int = 1) -> None:
    """Print when verbosity >= level (reference debug_info)."""
    if print_level() >= level:
        print(f"[miraculix_tpu] {msg}", file=sys.stderr, flush=True)


def print_compile_info() -> None:
    """Startup banner (reference print_compile_info: date, commit, device)."""
    import jax

    from .. import __version__

    devs = jax.devices()
    print(
        f"miraculix_tpu {__version__} | jax {jax.__version__} | "
        f"backend {jax.default_backend()} | {len(devs)} device(s): "
        f"{devs[0].device_kind if devs else 'none'}",
        file=sys.stderr,
    )


class PhaseTimer:
    """Named phase wall timers (reference STARTCLOCK/CLOCK macros).

    >>> t = PhaseTimer()
    >>> with t.phase("pack"): ...
    >>> t.report()
    """

    def __init__(self, verbose: Optional[bool] = None):
        self.phases: List[Tuple[str, float]] = []
        self.verbose = print_level() >= 2 if verbose is None else verbose

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.phases.append((name, dt))
            if self.verbose:
                debug_info(f"{name}: {dt * 1e3:.2f} ms", level=0)

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.phases:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self) -> str:
        lines = [f"  {n:<24s} {dt * 1e3:10.2f} ms"
                 for n, dt in self.totals().items()]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(dirname: str = "/tmp/miraculix_tpu_trace") -> Iterator[None]:
    """Structured device profiling via jax.profiler (view with TensorBoard
    or xprof) — the reference has no structured profiler (SURVEY.md §5)."""
    import jax

    jax.profiler.start_trace(dirname)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        debug_info(f"profile written to {dirname}", level=0)


def check_device_memory(required_bytes: int, safety: float = 1.1) -> bool:
    """Pre-flight free-memory guard (reference ``checkDevMemory``,
    src/cuda/cuda_utils.cu:163-186): warn when a planned allocation exceeds
    what the device reports as available.  Returns True when the allocation
    looks safe (or memory stats are unavailable)."""
    import jax

    try:
        stats = jax.devices()[0].memory_stats() or {}
    except Exception:
        return True
    limit = stats.get("bytes_limit")
    in_use = stats.get("bytes_in_use", 0)
    if not limit:
        return True
    free = limit - in_use
    if required_bytes * safety > free:
        debug_info(
            f"requested {required_bytes / 1e9:.2f} GB exceeds free device "
            f"memory {free / 1e9:.2f} GB (limit {limit / 1e9:.2f} GB)",
            level=0,
        )
        return False
    return True
