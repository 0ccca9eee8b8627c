"""The metrics' readers: ``benchmark/metrics/<name>.py``, each with a
``read(ctx)`` that returns the metric's value from the run's context, or
None where it finds nothing to read."""

import importlib.util
import os

__all__ = ["METRICS", "reader_of"]

METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "metrics")


def reader_of(name):
    """The ``read`` function of benchmark/metrics/<name>.py."""
    path = os.path.join(METRICS, name + ".py")
    mod_name = "benchmark_metric_" + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
