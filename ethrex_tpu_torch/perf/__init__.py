"""Performance observability of the node: the stage-attribution profiler
(`profiler`) and the chain-path telemetry (`chain_path`), copies of the
same modules of `ethrex_tpu/perf/`.

Everything here is telemetry and sits behind the never-raise contract:
a failing hook degrades to missing numbers, never a failed prove or
import.
"""

from . import profiler  # noqa: F401
