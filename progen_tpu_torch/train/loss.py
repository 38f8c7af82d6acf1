"""Next-token loss with the EOS-from-padding trick (ported from
progen_tpu/train/loss.py).

* data rows are ``(seq_len + 1,)`` wide (a BOS column first); inputs are
  ``data[:, :-1]``, targets ``data[:, 1:]``;
* token id 0 is padding; the loss mask keeps every non-pad target PLUS the
  FIRST pad position, so the model learns to emit 0 as end-of-sequence;
* the loss is the masked mean of the per-token NLL within each row, then
  the plain mean over rows (not a token mean over the batch).

Under a sequence split (``group``: the mesh's ``seq`` group; each rank holds
a contiguous slice of every row's targets) the mask needs the whole row's
first pad, and a row's NLL sum and mask count are summed over the slices
before the division: each rank then holds the whole row's loss, and its
gradient reaches only its own slice's share.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def eos_from_pad_mask(targets: torch.Tensor, ignore_index: int = 0,
                      pads_before: torch.Tensor | int = 0) -> torch.Tensor:
    """Bool mask over targets: non-pad positions plus the first pad;
    ``pads_before`` ``(B, 1)``: pads in the row before this slice."""
    nonpad = targets != ignore_index
    first_pad = torch.cumsum((~nonpad).int(), dim=-1) + pads_before == 1
    return nonpad | first_pad


def _seq_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, differentiable only through this rank's
    own term: the value is the whole sum, bit-equal on every rank."""
    total = t.detach().clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return t - t.detach() + total


def _pads_before(targets: torch.Tensor, ignore_index: int, group) -> torch.Tensor:
    """``(B, 1)`` pads of each row in the slices before this rank's."""
    pads = (targets == ignore_index).sum(-1, keepdim=True).int()
    every = [torch.empty_like(pads) for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, pads.contiguous(), group=group)
    return sum(every[:dist.get_rank(group)], torch.zeros_like(pads))


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  ignore_index: int = 0, group=None) -> torch.Tensor:
    """Per-row masked-mean NLL: ``(B, L, V) x (B, L) -> (B,)``, in f32
    whatever the logits' dtype; over the whole row when ``group`` splits
    the sequence."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    nll = torch.gather(logprobs, -1, targets.long().unsqueeze(-1)).squeeze(-1)
    if group is None or dist.get_world_size(group) == 1:
        mask = eos_from_pad_mask(targets, ignore_index)
        return -(nll * mask).sum(-1) / mask.sum(-1)
    mask = eos_from_pad_mask(targets, ignore_index,
                             _pads_before(targets, ignore_index, group))
    count = _seq_sum(mask.sum(-1), group).detach()
    return -_seq_sum((nll * mask).sum(-1), group) / count


def batch_loss(logits: torch.Tensor, targets: torch.Tensor,
               ignore_index: int = 0, group=None) -> torch.Tensor:
    """Scalar training loss: mean over rows of the per-row masked CE."""
    return cross_entropy(logits, targets, ignore_index, group).mean()
