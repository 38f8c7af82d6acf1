"""Sampling CLI of the port: prefill a prime, decode in early-exit chunks,
print the samples.

    python -m progen_tpu_torch.sample --config small --seed 0 --prime MKV \\
        --num_samples 4 --top_k 25 --temperature 1.0 --seq_len 1024 \\
        --chunk 64 [--params weights.npz] [--device cuda]

With ``--serve`` the primes (``--prime "MKV|MAL|..."``, or ``--num_samples``
copies of one prime) go through the continuous-batching ``ServingEngine``
instead, each BOS-prefixed with its own seed (``--seed + i``), and every
completion is printed as one JSON line:

    python -m progen_tpu_torch.sample --serve --prime "MKV|MALW" --slots 8 \
        --chunk 32 [--paged --page_size 16] [--quantize weights+pages]

Without ``--params`` the weights are drawn from ``--seed``.  ``--params``
takes an ``.npz`` of flat flax keys (``compat/convert.py``).  The device is
``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json

import torch

from progen_tpu_torch.compat.convert import load_npz
from progen_tpu_torch.core.device import resolve_device
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.tokenizer import decode_tokens, encode_tokens
from progen_tpu_torch.decode.engine import Request, ServingEngine
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
    p.add_argument("--serve", action="store_true",
                   help="serve the primes through the ServingEngine")
    p.add_argument("--slots", type=int, default=8, help="engine: slots")
    p.add_argument("--paged", action="store_true",
                   help="engine: keep the SGU gate cache in a page pool")
    p.add_argument("--page_size", type=int, default=16)
    p.add_argument("--quantize", default=None,
                   choices=["weights", "weights+pages"],
                   help="engine: int8 weights, and 8-bit gate pages")
    return p.parse_args(argv)


def serve(args, model, seq_len: int) -> list[dict]:
    """Answer the primes through the engine; prints and returns one record
    per completion, in uid order."""
    primes = (args.prime.split("|") if "|" in args.prime
              else [args.prime] * args.num_samples)
    engine = ServingEngine(model, num_slots=args.slots, chunk_size=args.chunk,
                           max_len=seq_len, paged=args.paged,
                           page_size=args.page_size, quantize=args.quantize)
    for i, prime in enumerate(primes):
        tokens = [0] + encode_tokens(prime)  # BOS-prefixed, like add_bos
        engine.submit(Request(
            uid=i, tokens=tokens, max_new_tokens=seq_len - len(tokens),
            top_k=args.top_k or None, temperature=args.temperature,
            seed=args.seed + i))
    records = []
    for comp in sorted(engine.run_until_idle(), key=lambda c: c.uid):
        records.append({
            "uid": comp.uid, "prime": primes[comp.uid],
            "text": decode_tokens(comp.tokens),
            "tokens": [int(t) for t in comp.tokens],
            "finish_reason": comp.finish_reason, "status": comp.status,
            "latency_s": comp.latency})
        print(json.dumps(records[-1]), flush=True)
    return records


def main(argv=None) -> list:
    """Run the CLI; returns the decoded samples it printed (with
    ``--serve``: the completion records)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = CONFIGS[args.config]
    seq_len = min(args.seq_len or config.seq_len, config.seq_len)
    model = ProGen(config, make_policy(), device=device,
                   seed=args.seed)
    if args.params:
        load_npz(args.params, model)
    model.eval()
    if args.serve:
        return serve(args, model, seq_len)

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
