"""Coverage-over-time benchmark plugin (own copy of
``mythril_tpu/laser/plugin/plugins/benchmark.py``; reference:
laser/plugin/plugins/benchmark.py).  Records wall-clock samples of the
executed-instruction count; plotting is optional (without
``matplotlib`` the series stays on the plugin and nothing is written).
No analysis path loads it: a caller loads it onto a ``LaserEVM``."""

import logging
import time
from typing import Dict, List

from mythril_tpu_torch.laser.plugin.builder import PluginBuilder
from mythril_tpu_torch.laser.plugin.interface import LaserPlugin

log = logging.getLogger(__name__)


class BenchmarkPluginBuilder(PluginBuilder):
    plugin_name = "benchmark"

    def __call__(self, *args, **kwargs):
        return BenchmarkPlugin()


class BenchmarkPlugin(LaserPlugin):
    def __init__(self, name=None):
        self.nr_of_executed_insns = 0
        self.begin = None
        self.end = None
        self.coverage_series: Dict[float, int] = {}
        self.name = name

    def initialize(self, symbolic_vm) -> None:
        self._reset()

        @symbolic_vm.laser_hook("execute_state")
        def execute_state_hook(_):
            current_time = time.time() - self.begin
            self.nr_of_executed_insns += 1
            self.coverage_series[current_time] = self.nr_of_executed_insns

        @symbolic_vm.laser_hook("start_sym_exec")
        def start_sym_exec_hook():
            self.begin = time.time()

        @symbolic_vm.laser_hook("stop_sym_exec")
        def stop_sym_exec_hook():
            self.end = time.time()
            self._write_to_graph()

    def _reset(self):
        self.nr_of_executed_insns = 0
        self.begin = time.time()
        self.end = None
        self.coverage_series = {}

    @property
    def states_per_second(self) -> float:
        if not self.begin:
            return 0.0
        elapsed = (self.end or time.time()) - self.begin
        return self.nr_of_executed_insns / elapsed if elapsed else 0.0

    def _write_to_graph(self):
        try:
            import matplotlib.pyplot as plt  # noqa: WPS433

            keys = list(self.coverage_series.keys())
            values = list(self.coverage_series.values())
            plt.plot(keys, values)
            plt.xlabel("Duration (seconds)")
            plt.ylabel("Executed instructions")
            plt.savefig(f"{self.name or 'benchmark'}.png")
        except ImportError:
            log.debug("matplotlib unavailable; benchmark series kept in memory")
