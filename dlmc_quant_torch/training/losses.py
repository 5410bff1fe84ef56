"""Loss functions.  Counterpart of ``dlmc_quant_tpu/training/losses.py``
(ref: trainer/loss/loss.py:4-52)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nll(logits, labels):
    """NLL over log-probabilities (the caller gives a log_softmax)."""
    return -logits.gather(1, labels[:, None]).mean()


def cross_entropy(logits, labels):
    """Softmax cross-entropy from raw logits, mean over the batch."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


native_cross_entropy = cross_entropy


def smoothlabel_ce_loss(logits, labels, smoothing: float = 0.1):
    """Label-smoothed cross-entropy."""
    n = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    soft = F.one_hot(labels.long(), n).to(logp.dtype) * (1.0 - smoothing) \
        + smoothing / n
    return -(soft * logp).sum(dim=-1).mean()


def kl_loss(student_logits, teacher_logits, temperature: float = 1.0):
    """KL(teacher ‖ student) on logits softened by ``temperature``."""
    t = temperature
    p_t = F.softmax(teacher_logits / t, dim=-1)
    logp_s = F.log_softmax(student_logits / t, dim=-1)
    logp_t = F.log_softmax(teacher_logits / t, dim=-1)
    return (p_t * (logp_t - logp_s)).sum(dim=-1).mean() * t * t


def l2_loss(output, target):
    """Mean over the batch of each row's summed squared error: the
    reconstruction objective."""
    diff = (output - target).reshape(output.shape[0], -1)
    return (diff * diff).sum(dim=1).mean()


def kurtosis(w, target: float = 1.8):
    """One tensor's kurtosis regularizer ``(kurt(w) − target)²``."""
    mu = w.mean()
    sigma2 = ((w - mu) ** 2).mean()
    k = ((w - mu) ** 4).mean() / (sigma2 ** 2 + 1e-12)
    return (k - target) ** 2


def kutosis_loss(weights, target: float = 1.8):
    """Mean kurtosis regularizer over conv weights (the reference's name,
    kept for its YAML)."""
    terms = [kurtosis(w, target) for w in weights]
    return torch.stack(terms).mean() if terms else torch.zeros(())


LOSSES = {
    "nll": nll,
    "cross_entropy": cross_entropy,
    "native_cross_entropy": native_cross_entropy,
    "smoothlabel_ce_loss": smoothlabel_ce_loss,
    "kl_loss": kl_loss,
    "l2_loss": l2_loss,
    "kutosis_loss": kutosis_loss,
}


def get_loss(name: str):
    try:
        return LOSSES[name]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; known: "
                         f"{sorted(LOSSES)}") from None
