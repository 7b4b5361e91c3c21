"""A metric of the host-bound cells that reads what a metric of the main
path reads: ``<name>.host_bound`` moves ``encode_MBps.host_bound`` where
``<name>`` moves ``encode_MBps``."""

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_base_" + name.replace(".", "_"), os.path.join(HERE, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
