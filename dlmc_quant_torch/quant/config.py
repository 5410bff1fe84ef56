"""Quantization configuration grammar.

Preserves the reference's YAML schema (SURVEY.md §5):

.. code-block:: yaml

    quantization:
      quantization_type: null | RootQ | FSPTQ
      momentum: 0.001            # RootQ EMA momentum
      weight:
        enable: true
        type: minmax_channel     # observer name or 'LSQ'
        recon_type: null         # FSPTQ: null | adaround
        args: {n_bits: 8, signed: true}
      input:
        enable: true
        type: minmax_tensor
        args: {n_bits: 8, signed: false}
      exclude_layers: [conv_stem, head]          # regexes, kept FP32
      override_options:
        - layers: ['.*linear.*']                  # regexes
          options:
            weight: {args: {n_bits: 4}}           # deep-merged

Counterpart of ``dlmc_quant_tpu/quant/config.py``, kept line for line so
the same YAML resolves to the same per-layer configs in both packages.
The scheme is an immutable, hashable object; each quantized layer
resolves its effective config from its ``named_modules()`` path
(``"stage0.reparam"``), which is the same string as the JAX package's
module-scope path.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Tuple

from dlmc_quant_torch.ops.numerics import get_qrange


def _freeze(obj):
    """Recursively convert dicts/lists to hashable tuples."""
    if isinstance(obj, Mapping):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


def _thaw(obj):
    if isinstance(obj, tuple) and all(
            isinstance(i, tuple) and len(i) == 2 and isinstance(i[0], str)
            for i in obj):
        return {k: _thaw(v) for k, v in obj}
    if isinstance(obj, tuple):
        return [_thaw(v) for v in obj]
    return obj


@dataclasses.dataclass(frozen=True)
class TensorQConfig:
    """Quantizer config for one tensor role (weight or input).

    ``type`` is an observer name from ``ops.observers`` ('minmax_tensor',
    'l2loss_channel', 'l2norm_output', ...) or the literal 'LSQ' for
    LSQ-style init (2·mean|x|/√qmax; ref: modules/base.py:83-84,118-119).
    """
    enable: bool = False
    type: str = "minmax_tensor"
    n_bits: int = 8
    signed: bool = True
    recon_type: Optional[str] = None           # FSPTQ: None | 'adaround'
    extra_args: Tuple = ()                     # frozen observer kwargs

    @property
    def qrange(self):
        return get_qrange(self.signed, self.n_bits)

    @property
    def qmin(self) -> int:
        return self.qrange[0]

    @property
    def qmax(self) -> int:
        return self.qrange[1]

    @property
    def per_channel(self) -> bool:
        return "channel" in self.type

    @property
    def per_pixel(self) -> bool:
        return "pixel" in self.type

    @property
    def observer_kwargs(self) -> Dict[str, Any]:
        kw = dict(_thaw(self.extra_args) or {})
        kw.update(n_bits=self.n_bits, signed=self.signed)
        return kw

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> "TensorQConfig":
        if not d:
            return cls(enable=False)
        args = dict(d.get("args") or {})
        n_bits = int(args.pop("n_bits", 8))
        signed = bool(args.pop("signed", True))
        args.pop("ch_axis", None)  # layout-specific; layers pick their own
        return cls(
            enable=bool(d.get("enable", False)),
            type=str(d.get("type", "minmax_tensor")),
            n_bits=n_bits,
            signed=signed,
            recon_type=d.get("recon_type"),
            extra_args=_freeze(args),
        )

    def to_dict(self) -> Dict[str, Any]:
        args = dict(_thaw(self.extra_args) or {})
        args.update(n_bits=self.n_bits, signed=self.signed)
        return {"enable": self.enable, "type": self.type,
                "recon_type": self.recon_type, "args": args}


@dataclasses.dataclass(frozen=True)
class LayerQConfig:
    """Effective (weight, input) quantizer pair for one layer."""
    weight: TensorQConfig = TensorQConfig()
    input: TensorQConfig = TensorQConfig()
    momentum: float = 0.001                    # RootQ EMA (ref: RootQ/base.py:65)

    @classmethod
    def from_dict(cls, d: Mapping) -> "LayerQConfig":
        return cls(
            weight=TensorQConfig.from_dict(d.get("weight")),
            input=TensorQConfig.from_dict(d.get("input")),
            momentum=float(d.get("momentum", 0.001)),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {"weight": self.weight.to_dict(), "input": self.input.to_dict(),
                "momentum": self.momentum}


def _deep_merge(base: Dict, override: Mapping) -> Dict:
    """Deep-copy merge of override dicts into a base layer config.

    ref: dlmc/utils/quantize.py:112-118 (per-layer override merging).
    """
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v) if isinstance(v, (dict, list)) else v
    return out


@dataclasses.dataclass(frozen=True)
class QuantScheme:
    """Whole-model quantization scheme: estimator family, default layer
    config, regex excludes, and per-layer overrides.

    Immutable and hashable.  ``resolve(path)`` returns the effective
    ``LayerQConfig`` for a layer's module path, or ``None`` if the layer
    stays FP32.  ref: dlmc/utils/quantize.py:61-143
    """
    quantization_type: Optional[str] = None    # None | 'RootQ' | 'FSPTQ'
    default: LayerQConfig = LayerQConfig()
    exclude_layers: Tuple[str, ...] = ()
    override_options: Tuple[Tuple[Tuple[str, ...], Tuple], ...] = ()

    def resolve(self, path: str) -> Optional[LayerQConfig]:
        """Effective config for layer ``path`` ('block1.conv2' style).

        Exclusion regexes keep the layer FP32; override regexes deep-merge
        option dicts onto the default (first matching override wins, as in
        the reference's single-pass loop; ref: quantize.py:119-128).
        Regexes tolerate a leading '(module.)?' like the reference's
        get_layers filter (ref: access.py:44-48) by using ``re.search``
        anchored at the start.
        """
        for pat in self.exclude_layers:
            if re.match(pat, path) or re.fullmatch(pat, path):
                return None
        cfg_dict = self.default.to_dict()
        for patterns, options in self.override_options:
            if any(re.match(p, path) or re.fullmatch(p, path)
                   for p in patterns):
                cfg_dict = _deep_merge(cfg_dict, _thaw(options))
                break
        cfg = LayerQConfig.from_dict(cfg_dict)
        if not (cfg.weight.enable or cfg.input.enable):
            return None
        return cfg

    def with_type(self, quantization_type: Optional[str]) -> "QuantScheme":
        return dataclasses.replace(self, quantization_type=quantization_type)


def scheme_from_dict(d: Optional[Mapping]) -> Optional[QuantScheme]:
    """Build a QuantScheme from the YAML 'quantization' section.

    Accepts the exact reference grammar; returns None for a null section
    (FP32 model).
    """
    if not d:
        return None
    overrides = []
    for ov in d.get("override_options") or []:
        overrides.append((tuple(ov.get("layers") or ()),
                          _freeze(ov.get("options") or {})))
    return QuantScheme(
        quantization_type=d.get("quantization_type"),
        default=LayerQConfig.from_dict(d),
        exclude_layers=tuple(d.get("exclude_layers") or ()),
        override_options=tuple(overrides),
    )
