"""Sampling CLI of the port: prefill a prime, decode in early-exit chunks,
print the samples.

    python -m progen_tpu_torch.sample --config small --seed 0 --prime MKV \\
        --num_samples 4 --top_k 25 --temperature 1.0 --seq_len 1024 \\
        --chunk 64 [--params weights.npz] [--device cuda]

Without ``--params`` the weights are drawn from ``--seed``.  ``--params``
takes an ``.npz`` of flat flax keys (``compat/convert.py``).  The device is
``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import torch

from progen_tpu_torch.compat.convert import load_npz
from progen_tpu_torch.core.device import resolve_device
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.tokenizer import decode_tokens, encode_tokens
from progen_tpu_torch.decode.sampler import make_chunked_sampler
from progen_tpu_torch.models.configs import CONFIGS
from progen_tpu_torch.models.progen import ProGen


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="small", choices=sorted(CONFIGS))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prime", default="")
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--top_k", type=int, default=25)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--seq_len", type=int, default=None,
                   help="decode length, at most the config's seq_len "
                        "(the default)")
    p.add_argument("--chunk", type=int, default=64,
                   help="decode steps between early-exit checks")
    p.add_argument("--params", default=None,
                   help=".npz of flat flax parameter keys")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> list[str]:
    """Run the CLI; returns the decoded samples it printed."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = CONFIGS[args.config]
    seq_len = min(args.seq_len or config.seq_len, config.seq_len)
    model = ProGen(config, make_policy(), device=device,
                   seed=args.seed)
    if args.params:
        load_npz(args.params, model)
    model.eval()

    prime_tokens = encode_tokens(args.prime)
    # add_bos prepends the BOS/pad column; an empty prime is that column alone
    prime = torch.tensor([prime_tokens or [0]], dtype=torch.long,
                         device=device).repeat(args.num_samples, 1)
    add_bos = bool(prime_tokens)
    prime_length = len(prime_tokens) + 1
    generator = torch.Generator(device=device).manual_seed(args.seed)
    sampler = make_chunked_sampler(model, chunk_size=args.chunk)
    sampled = sampler(prime, seq_len, generator=generator, top_k=args.top_k,
                      add_bos=add_bos, temperature=args.temperature)

    texts = []
    for row in sampled.cpu().numpy():
        text = decode_tokens(row[prime_length:])
        texts.append(text)
        print("\n", args.prime, "\n", "*" * 40, "\n", text)
    return texts


if __name__ == "__main__":
    main()
