"""Convert a reference .pt checkpoint to the JAX package's .npz.

    python -m atmvfi_tpu_torch.cli.convert_checkpoint in.pt out.npz \
        [--variant base] [--no_verify]

Reads the .pt (`convert.load_checkpoint`: wrapped or raw, cached buffers
dropped), checks its key set and shapes against the port's own
`Network(get_config(variant))`, and writes the params-only .npz
(`convert.save_npz`) with the scalar and dict entries of its meta.
"""
from __future__ import annotations

import argparse

from atmvfi_tpu_torch.cli.export_checkpoint import check_state_dict


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--variant", choices=["base", "lite"], default="base")
    p.add_argument("--no_verify", action="store_true")
    args = p.parse_args(argv)

    from atmvfi_tpu_torch import convert

    sd, meta = convert.load_checkpoint(args.src)
    if not args.no_verify:
        n = check_state_dict(sd, args.variant)
        print(f"verified {n} parameters against {args.variant}")
    meta_small = {k: v for k, v in meta.items()
                  if isinstance(v, (str, int, float, dict))}
    convert.save_npz(args.dst, sd, meta=meta_small or None)
    print(f"wrote {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
