"""Loss functions.  Counterpart of ``dlmc_quant_tpu/training/losses.py``:
the two that the FSPTQ entry uses."""

from __future__ import annotations

import torch
import torch.nn.functional as F

# losses of the JAX package that are not ported yet
_NOT_PORTED = ("nll", "native_cross_entropy", "smoothlabel_ce_loss",
               "kl_loss", "kutosis_loss")


def cross_entropy(logits, labels):
    """Softmax cross-entropy from raw logits, mean over the batch."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def l2_loss(output, target):
    """Mean over the batch of each row's summed squared error: the
    reconstruction objective."""
    diff = (output - target).reshape(output.shape[0], -1)
    return (diff * diff).sum(dim=1).mean()


LOSSES = {"cross_entropy": cross_entropy, "l2_loss": l2_loss}


def get_loss(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"loss {name!r} is not ported yet (ROADMAP Queue A, QAT + "
            "trainers (item 6))")
    try:
        return LOSSES[name]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; known: "
                         f"{sorted(LOSSES)}") from None
