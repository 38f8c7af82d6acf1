"""Next-token loss with the EOS-from-padding trick (ported from
progen_tpu/train/loss.py).

* data rows are ``(seq_len + 1,)`` wide (a BOS column first); inputs are
  ``data[:, :-1]``, targets ``data[:, 1:]``;
* token id 0 is padding; the loss mask keeps every non-pad target PLUS the
  FIRST pad position, so the model learns to emit 0 as end-of-sequence;
* the loss is the masked mean of the per-token NLL within each row, then
  the plain mean over rows (not a token mean over the batch).
"""

from __future__ import annotations

import torch


def eos_from_pad_mask(targets: torch.Tensor, ignore_index: int = 0) -> torch.Tensor:
    """Bool mask over targets: non-pad positions plus the first pad."""
    nonpad = targets != ignore_index
    first_pad = torch.cumsum((~nonpad).int(), dim=-1) == 1
    return nonpad | first_pad


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  ignore_index: int = 0) -> torch.Tensor:
    """Per-row masked-mean NLL: ``(B, L, V) x (B, L) -> (B,)``, in f32
    whatever the logits' dtype."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    nll = torch.gather(logprobs, -1, targets.long().unsqueeze(-1)).squeeze(-1)
    mask = eos_from_pad_mask(targets, ignore_index)
    return -(nll * mask).sum(-1) / mask.sum(-1)


def batch_loss(logits: torch.Tensor, targets: torch.Tensor,
               ignore_index: int = 0) -> torch.Tensor:
    """Scalar training loss: mean over rows of the per-row masked CE."""
    return cross_entropy(logits, targets, ignore_index).mean()
