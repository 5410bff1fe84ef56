"""YAML run configuration: parsing, run directories and object factory.

Counterpart of ``dlmc_quant_tpu/utils/config.py``, with the same YAML
schema (``name``, ``random_seed``, ``arch``, ``dataloaders``,
``quantization``, ``optimizer``, ``lr_scheduler``, ``loss``, ``metrics``,
``trainer``), ``-c/--config`` and ``-r/--resume``: a checkpoint directory
of an earlier run, whose run's ``config.yaml`` (the directory's parent's)
is read, updated by ``-c`` if given.  ``-d/--device`` picks the device:
``cuda`` (the default; raises without a card) or ``cpu``.
"""

from __future__ import annotations

import argparse
import random
from datetime import datetime
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence

import yaml

DEVICES = ("cuda", "cpu")


def read_yaml(path) -> Dict:
    with open(path) as f:
        return yaml.safe_load(f)


def write_yaml(obj, path) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(obj, f, default_flow_style=False, sort_keys=False)


class ConfigParser:
    """Parsed run configuration, run directories and object factory.

    ref: parse_config.py:13-154.  With ``save_to_disk`` the run gets
    ``<save_dir>/models/<name>/<run_id>`` (holding a copy of the config)
    and ``<save_dir>/log/<name>/<run_id>``; ``save_dir`` comes from the
    config, ``saved`` by default.
    """

    def __init__(self, config: Dict, device: str = "cuda",
                 run_id: Optional[str] = None, save_to_disk: bool = True,
                 resume: Optional[str] = None):
        if device not in DEVICES:
            raise ValueError(f"device {device!r}: the port runs on one of "
                             f"{DEVICES}")
        self._config = dict(config)
        self.device = device
        self.resume = resume
        self._config.setdefault("random_seed", random.randint(0, 2 ** 31 - 1))
        if save_to_disk:
            save_root = Path(self._config.get("save_dir", "saved"))
            name = self._config.get("name", "run")
            run_id = run_id or datetime.now().strftime(r"%m%d_%H%M%S")
            self._save_dir = save_root / "models" / name / run_id
            self._log_dir = save_root / "log" / name / run_id
            self._save_dir.mkdir(parents=True, exist_ok=True)
            self._log_dir.mkdir(parents=True, exist_ok=True)
            write_yaml(self._config, self._save_dir / "config.yaml")
        else:
            self._save_dir = self._log_dir = None

    @classmethod
    def from_args(cls, args: Optional[Sequence[str]] = None,
                  save_to_disk: bool = True) -> "ConfigParser":
        """CLI: ``-c/--config``, ``-r/--resume`` (one of them at least) and
        ``-d/--device``.  ref: parse_config.py:66-94"""
        parser = argparse.ArgumentParser(description="dlmc_quant_torch")
        parser.add_argument("-c", "--config", default=None, type=str,
                            help="config yaml path")
        parser.add_argument("-r", "--resume", default=None, type=str,
                            help="checkpoint directory to resume from")
        parser.add_argument("-d", "--device", default="cuda", choices=DEVICES,
                            help="device to run on (default: cuda)")
        ns = parser.parse_args(args)
        if ns.resume is not None:
            config = read_yaml(Path(ns.resume).parent / "config.yaml")
            if ns.config is not None:
                config.update(read_yaml(ns.config))
        elif ns.config is not None:
            config = read_yaml(ns.config)
        else:
            parser.error("either -c/--config or -r/--resume is required")
        return cls(config, ns.device, save_to_disk=save_to_disk,
                   resume=ns.resume)

    def init_obj(self, name: str, registry: Callable[..., Any], *args,
                 **kwargs):
        """``registry(cfg['type'], *args, **cfg['args'], **kwargs)`` for a
        lookup callable ``registry(name, **kw)``.  ref: parse_config.py:96-109
        """
        spec = self[name]
        cfg_args = dict(spec.get("args") or {})
        overlap = set(cfg_args) & set(kwargs)
        if overlap:
            raise ValueError(f"config args overwritten: {overlap}")
        cfg_args.update(kwargs)
        return registry(spec["type"], *args, **cfg_args)

    def __getitem__(self, name: str):
        return self._config[name]

    def get(self, name: str, default=None):
        return self._config.get(name, default)

    def __contains__(self, name: str):
        return name in self._config

    @property
    def config(self) -> Dict:
        return self._config

    @property
    def save_dir(self) -> Optional[Path]:
        return self._save_dir

    @property
    def log_dir(self) -> Optional[Path]:
        return self._log_dir

    @property
    def seed(self) -> int:
        return int(self._config["random_seed"])
