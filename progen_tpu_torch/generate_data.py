"""Data-prep CLI of the port: a TOML data config's FASTA -> sharded GZIP
tfrecords, as the JAX package's ``generate_data.py`` writes them.

    python -m progen_tpu_torch.generate_data --data_dir ./configs/data \\
        --name default --seed 0 [--num_workers N]

Reads ``{data_dir}/{name}.toml`` (keys ``read_from``, ``write_to``,
``max_seq_len``, ``num_samples``, ``fraction_valid_data``,
``num_sequences_per_file``, ``prob_invert_seq_annotation``,
``sort_annotations``, ``annotations``) and writes through the port's
pure-Python ``write_tfrecord``: the shards are byte-identical to the JAX
package's for the same FASTA and seed.  Local paths only.
"""

from __future__ import annotations

import argparse
import tomllib
from pathlib import Path

from progen_tpu_torch.data.fasta import generate_tfrecords


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", default="./configs/data")
    p.add_argument("--name", default="default")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=None,
                   help="multiprocessing pool size for formatting and shard "
                        "compression (default: all cores; 0/1 = serial)")
    return p.parse_args(argv)


def main(argv=None) -> dict[str, int]:
    args = parse_args(argv)
    config_path = Path(args.data_dir) / f"{args.name}.toml"
    if not config_path.exists():
        raise SystemExit(f"config does not exist at {config_path}")
    config = tomllib.loads(config_path.read_text())
    counts = generate_tfrecords(
        read_from=config["read_from"],
        write_to=config["write_to"],
        max_seq_len=config.get("max_seq_len", 1024),
        num_samples=config.get("num_samples"),
        fraction_valid_data=config.get("fraction_valid_data", 0.025),
        num_sequences_per_file=config.get("num_sequences_per_file", 1000),
        prob_invert_seq_annotation=config.get("prob_invert_seq_annotation", 0.5),
        sort_annotations=config.get("sort_annotations", True),
        annotations=tuple(config.get("annotations", ["tax"])),
        seed=args.seed,
        num_workers=args.num_workers,
    )
    print(f"wrote {counts['train']} train / {counts['valid']} valid sequences "
          f"to {config['write_to']}")
    return counts


if __name__ == "__main__":
    main()
