"""Export a JAX-package .npz checkpoint to the reference's wrapped .pt.

    python -m atmvfi_tpu_torch.cli.export_checkpoint in.npz out.pt \
        [--variant base]

Reads the .npz with numpy (`convert.load_npz`), checks its key set and
shapes against the port's own `Network(get_config(variant))`, and
writes the .pt with `convert.save_checkpoint`, the meta carried over.
"""
from __future__ import annotations

import argparse


def check_state_dict(sd: dict, variant: str) -> int:
    """Raise SystemExit unless `sd` has the keys and shapes of the
    port's `variant` network; returns the number of tensors."""
    from atmvfi_tpu_torch.models import Network, get_config

    want = Network(get_config(variant)).state_dict()
    missing, extra = set(want) - set(sd), set(sd) - set(want)
    if missing or extra:
        raise SystemExit(f"structure mismatch: missing {sorted(missing)[:5]}"
                         f" extra {sorted(extra)[:5]}")
    for k, v in want.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise SystemExit(f"shape mismatch at {k}: "
                             f"{tuple(sd[k].shape)} vs {tuple(v.shape)}")
    return len(want)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("src", help="JAX-package .npz checkpoint")
    p.add_argument("dst", help="output .pt (reference wrapped format)")
    p.add_argument("--variant", choices=["base", "lite"], default="base")
    p.add_argument("--no_verify", action="store_true")
    args = p.parse_args(argv)

    from atmvfi_tpu_torch import convert

    sd, meta = convert.load_npz(args.src)
    if not args.no_verify:
        n = check_state_dict(sd, args.variant)
        print(f"verified {n} parameters against {args.variant}")
    convert.save_checkpoint(args.dst, sd, meta=meta)
    print(f"wrote {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
