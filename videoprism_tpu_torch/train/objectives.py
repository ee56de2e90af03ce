"""Training objectives (port of ``videoprism_tpu.train.objectives``):
symmetric contrastive (CLIP InfoNCE, SigLIP) and softmax classification,
with the JAX package's metric names.  Losses and metrics are 0-d fp32
tensors; the accuracies are fractions of the batch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def clip_contrastive_loss(
    video_embeddings: torch.Tensor,
    text_embeddings: torch.Tensor,
    log_temperature: torch.Tensor,
    *,
    max_temperature_scale: float = 100.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
  """Symmetric InfoNCE over l2-normalized embeddings; the matched pairs
  are the diagonal and ``logit_scale = min(exp(log_temperature), max)``.
  Returns (scalar loss, metrics)."""
  b = video_embeddings.shape[0]
  logit_scale = torch.clamp(torch.exp(log_temperature),
                            max=max_temperature_scale)
  logits = (video_embeddings.float() @ text_embeddings.float().T
            ) * logit_scale
  labels = torch.arange(b, device=logits.device)
  nll_v2t = F.cross_entropy(logits, labels)
  nll_t2v = F.cross_entropy(logits.T, labels)
  loss = 0.5 * (nll_v2t + nll_t2v)
  return loss, {
      'loss': loss,
      'nll_v2t': nll_v2t,
      'nll_t2v': nll_t2v,
      'accuracy_v2t': (logits.argmax(-1) == labels).float().mean(),
      'accuracy_t2v': (logits.argmax(0) == labels).float().mean(),
      'logit_scale': logit_scale,
  }


def siglip_loss(
    video_embeddings: torch.Tensor,
    text_embeddings: torch.Tensor,
    temperature_state: torch.Tensor,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
  """Pairwise sigmoid contrastive loss (SigLIP):
  ``-(1/B) sum_ij log_sigmoid(z_ij (t v_i.x_j + b))``, z = +1 on the
  diagonal and -1 elsewhere, ``temperature_state = [log t, b]``."""
  if tuple(temperature_state.shape) != (2,):
    raise ValueError(
        'siglip_loss wants temperature_state=[log_temperature, bias] '
        f'(shape [2]), got shape {tuple(temperature_state.shape)}')
  b = video_embeddings.shape[0]
  logit_scale = torch.exp(temperature_state[0])
  logit_bias = temperature_state[1]
  logits = (video_embeddings.float() @ text_embeddings.float().T
            ) * logit_scale + logit_bias
  signs = 2.0 * torch.eye(b, device=logits.device) - 1.0
  loss = -F.logsigmoid(signs * logits).sum() / b
  labels = torch.arange(b, device=logits.device)
  return loss, {
      'loss': loss,
      'accuracy_v2t': (logits.argmax(-1) == labels).float().mean(),
      'accuracy_t2v': (logits.argmax(0) == labels).float().mean(),
      'logit_scale': logit_scale,
      'logit_bias': logit_bias,
  }


CONTRASTIVE_OBJECTIVES = {
    'infonce': clip_contrastive_loss,
    'siglip': siglip_loss,
}


def _unknown(objective: str) -> ValueError:
  return ValueError(
      f'unknown contrastive objective {objective!r} (expected one of '
      f'{sorted(CONTRASTIVE_OBJECTIVES)})')


def contrastive_loss(objective: str, video_embeddings: torch.Tensor,
                     text_embeddings: torch.Tensor,
                     temperature_state: torch.Tensor
                     ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
  """Dispatch by objective name ('infonce' | 'siglip')."""
  if objective not in CONTRASTIVE_OBJECTIVES:
    raise _unknown(objective)
  return CONTRASTIVE_OBJECTIVES[objective](video_embeddings, text_embeddings,
                                           temperature_state)


def init_temperature_state(objective: str,
                           init_log_temperature: float | None = None,
                           init_bias: float = -10.0, *,
                           device: torch.device | str = 'cpu'
                           ) -> torch.Tensor:
  """The init of the ``TrainState.log_temperature`` slot: CLIP's
  log(1/0.07) for InfoNCE (a scalar); [log 10, -10] for SigLIP."""
  if objective == 'infonce':
    t = (float(np.log(1 / 0.07)) if init_log_temperature is None
         else init_log_temperature)
    return torch.tensor(t, dtype=torch.float32, device=device)
  if objective == 'siglip':
    t = (float(np.log(10.0)) if init_log_temperature is None
         else init_log_temperature)
    return torch.tensor([t, init_bias], dtype=torch.float32, device=device)
  raise _unknown(objective)


def softmax_cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
  """Mean softmax cross-entropy for integer labels [B]; ``label_smoothing``
  eps moves eps of the target mass uniformly over the classes.  Accuracy
  scores the hard label."""
  log_probs = torch.log_softmax(logits.float(), dim=-1)
  nll = -log_probs.gather(-1, labels.long()[:, None]).mean()
  if label_smoothing:
    nll = (1.0 - label_smoothing) * nll + label_smoothing * -log_probs.mean()
  acc = (logits.argmax(-1) == labels).float().mean()
  return nll, {'loss': nll, 'accuracy': acc}


def soft_cross_entropy_loss(
    logits: torch.Tensor, label_probs: torch.Tensor
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
  """Mean cross-entropy against a target distribution [B, C]; accuracy
  scores against the distribution's argmax."""
  log_probs = torch.log_softmax(logits.float(), dim=-1)
  nll = -(label_probs.float() * log_probs).sum(-1).mean()
  acc = (logits.argmax(-1) == label_probs.argmax(-1)).float().mean()
  return nll, {'loss': nll, 'accuracy': acc}
