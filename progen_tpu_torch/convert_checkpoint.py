"""Migration CLI of the port: a reference Haiku checkpoint pickle -> the
port's checkpoint store (``compat/reference.py``).

    python -m progen_tpu_torch.convert_checkpoint --pkl ./ckpts/ckpt_1646000000.pkl \\
        --checkpoint_path ./ckpts_torch

then ``python -m progen_tpu_torch.train --checkpoint_path ./ckpts_torch
--data_path ...`` resumes at the pickle's record cursor (fresh Adam moments,
for ``--grad_accum_every``) and ``python -m progen_tpu_torch.sample
--checkpoint_path ./ckpts_torch`` decodes.  Prints one JSON line.  Needs no
card.
"""

from __future__ import annotations

import argparse
import json

from progen_tpu_torch.compat.reference import convert_reference_checkpoint


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pkl", required=True,
                   help="reference ckpt_{unixtime}.pkl (a pickled package)")
    p.add_argument("--checkpoint_path", default="./ckpts",
                   help="the port's checkpoint store to write")
    p.add_argument("--grad_accum_every", type=int, default=4,
                   help="the accumulation the store is resumed with (the train "
                        "CLI's default)")
    args = p.parse_args(argv)
    meta = convert_reference_checkpoint(args.pkl, args.checkpoint_path,
                                        grad_accum_every=args.grad_accum_every)
    print(json.dumps({"converted_params": meta["num_params"],
                      "checkpoint_path": args.checkpoint_path,
                      "next_seq_index": meta["next_seq_index"], "run_id": meta["run_id"]}),
          flush=True)
    return meta


if __name__ == "__main__":
    main()
