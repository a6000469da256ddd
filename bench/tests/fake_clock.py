"""A clock for the CPU tests' whole runs: drivers loaded through
``run.load_module`` while it is installed read a clock that moves ``tick``
seconds a reading (and a sleep's length), so what a run serves, its steps,
waves and counters depend on the program's outputs alone, not on how busy
the machine is."""
import types

import run


def install(monkeypatch, tick: float = 1e-3) -> None:
    load = run.load_module

    def load_clocked(path):
        mod = load(path)
        if path.parent.name == "drivers":
            now = [1000.0]

            def clock():
                now[0] += tick
                return now[0]

            def sleep(s):
                now[0] += max(0.0, s)

            mod._clock = clock
            mod.time = types.SimpleNamespace(sleep=sleep, perf_counter=clock)
        return mod

    monkeypatch.setattr(run, "load_module", load_clocked)
