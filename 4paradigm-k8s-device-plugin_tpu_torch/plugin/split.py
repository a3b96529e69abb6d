"""Split strategies: the reference's MIG strategies (mig-strategy.go), as
``vtpu``'s split.py names them.

- ``none``  → time-share: every card split into ``--device-split-count``
              vdevices under one ``4paradigm.com/vtpu`` resource (reference
              mig-strategy.go:62-71).
- ``core``  → hard partition: one vdevice per MIG instance, under
              ``4paradigm.com/vtpu-core``; requires MIG-enabled cards of one
              model, as MIG 'single' validates a homogeneous node
              (reference mig-strategy.go:78-135).
- ``mixed`` → whole cards as time-share vtpus and MIG cards as
              ``…/vtpu-core`` instances, each set under its own plugin and
              socket (reference mig-strategy.go:167-210).

Each ``PluginSpec`` becomes one gRPC server on its own unix socket
(``plugin/server.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..discovery.base import ChipBackend
from ..utils import logging as log
from .config import Config
from .vdevice import VDevice, split_chip, split_chip_by_core


@dataclass
class PluginSpec:
    resource_name: str
    socket_name: str
    vdevices: List[VDevice]
    time_shared: bool           # False → whole instances/cards, no share


def _socket_for(resource_name: str) -> str:
    return resource_name.replace("/", ".") + ".sock"


def _time_share(cfg: Config, chips) -> PluginSpec:
    vdevs: List[VDevice] = []
    for chip in chips:
        vdevs.extend(split_chip(chip, cfg.device_split_count,
                                cfg.device_memory_scaling,
                                cfg.device_cores_scaling))
    return PluginSpec(cfg.resource_name, _socket_for(cfg.resource_name),
                      vdevs, time_shared=cfg.device_split_count > 1)


def _by_instance(cfg: Config, chips) -> PluginSpec:
    vdevs: List[VDevice] = []
    for chip in chips:
        vdevs.extend(split_chip_by_core(chip, cfg.device_memory_scaling))
    name = cfg.resource_name + "-core"
    return PluginSpec(name, _socket_for(name), vdevs, time_shared=False)


def build_plugin_specs(cfg: Config, backend: ChipBackend) -> List[PluginSpec]:
    chips = backend.chips()
    if not chips:
        return []
    strategy = cfg.split_strategy
    if strategy == "none":
        return [_time_share(cfg, chips)]
    mig = [c for c in chips if c.mig_enabled]
    if strategy == "core":
        if not mig:
            raise RuntimeError(
                "split-strategy=core requires MIG-enabled cards (found "
                f"{chips[0].model} with MIG off); use 'none', or enable "
                "MIG and create instances")
        if len({c.model for c in mig}) != 1:
            raise RuntimeError(
                "split-strategy=core requires a homogeneous node")
        return [_by_instance(cfg, mig)]
    if strategy == "mixed":
        whole = [c for c in chips if not c.mig_enabled]
        specs = ([_time_share(cfg, whole)] if whole else []) + \
            ([_by_instance(cfg, mig)] if mig else [])
        log.info("mixed split: %d time-share vdevices, %d MIG vdevices",
                 sum(len(s.vdevices) for s in specs if s.time_shared),
                 sum(len(s.vdevices) for s in specs if not s.time_shared))
        return specs
    raise ValueError(f"unknown split strategy {strategy!r}")
