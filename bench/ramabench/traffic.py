"""The one traffic generator: a configuration file and a traffic file in,
the run's instances, in the order the client takes them, out.

A traffic file is data (``bench/traffic/<name>.json``):

``count``
    how many instances of the configuration's sizes the run solves in
    turn, round and round. Instance ``i`` is drawn from seed
    ``seed + i``, so every seed gives the same sizes.
``mode``
    what ``api.solve`` is asked for.

The configuration's ``instance`` names the generator
(``bench/generators/<generator>.py``, found by
:func:`ramabench.manifest.generator`), the free edge slots after the
instance's edges (``chord_slots_per_repulsive_edge``, times the solver's
repulsive edges a round), and the generator's settings: every other key,
passed to its ``make`` by keyword, as it stands.
"""
from __future__ import annotations

from dataclasses import dataclass

from ramabench import manifest


@dataclass
class Plan:
    host: list           # HostInstance, in the order the client takes them
    mode: str


def make_plan(config: dict, traffic: dict, seed: int,
              max_neg: int = 256) -> Plan:
    """The instances of one run of ``traffic`` on ``config``.
    ``max_neg`` is the solver's repulsive edges a round, which sizes the
    chord slots that the configuration asks for."""
    if seed < 0:
        raise ValueError(f"--seed must be a whole number >= 0, got {seed}")
    settings = dict(config["instance"])
    make = manifest.generator(settings.pop("generator")).make
    chords = settings.pop("chord_slots_per_repulsive_edge", 0) * max_neg
    host = [make(seed=seed + i, chord_slots=chords, **settings)
            for i in range(traffic["count"])]
    return Plan(host=host, mode=traffic["mode"])
