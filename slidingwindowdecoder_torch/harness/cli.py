"""Command-line entry point of the port (the JAX package's
``harness/cli.py``: the same seven subcommands, flags and defaults, plus
``--device``).

The reference is driven by editing notebook cells; this CLI exposes the
main experiment drivers with typed flags:

  python -m slidingwindowdecoder_torch.harness.cli sliding-window \
      --N 144 --p 0.004 --rounds 12 --shots 10000 -W 3 -F 1
  python -m slidingwindowdecoder_torch.harness.cli gdg-window --N 144 ...
  python -m slidingwindowdecoder_torch.harness.cli code-capacity --N 288 ...
  python -m slidingwindowdecoder_torch.harness.cli shyps --r 3 --window ...

``--device`` (default ``cuda``; raises without a card) goes to every
driver and decoder; ``--device cpu`` runs the plain PyTorch versions on
the CPU. The ``--json`` file (or, with ``--quiet``, the printed line)
holds the JAX CLI's keys, every value a plain number, string, list or
dict.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="slidingwindowdecoder_torch")
    sub = ap.add_subparsers(dest="command", required=True)

    def common(p):
        p.add_argument("--shots", type=int, default=10000)
        p.add_argument("--seed", type=int, default=None)
        p.add_argument("--json", type=str, default=None, help="result file")
        p.add_argument("--quiet", action="store_true")
        p.add_argument("--device", type=str, default="cuda",
                       help="torch device (cuda raises without a card; cpu runs the "
                            "plain versions)")

    sw = sub.add_parser("sliding-window", help="BB circuit-level SW BP+OSD (osd.py)")
    sw.add_argument("--N", type=int, default=144)
    sw.add_argument("--p", type=float, default=0.004)
    sw.add_argument("--rounds", type=int, default=12)
    sw.add_argument("-W", type=int, default=3)
    sw.add_argument("-F", type=int, default=1)
    sw.add_argument("--max-iter", type=int, default=200)
    sw.add_argument("--method", type=int, default=1)
    sw.add_argument("--osd-method", default="osd_cs")
    sw.add_argument("--osd-order", type=int, default=10)
    sw.add_argument("--shorten", action="store_true")
    sw.add_argument("--x-basis", action="store_true")
    common(sw)

    gw = sub.add_parser("gdg-window", help="BB circuit-level SW GDG (guessing.py)")
    gw.add_argument("--N", type=int, default=144)
    gw.add_argument("--p", type=float, default=0.005)
    gw.add_argument("--rounds", type=int, default=12)
    gw.add_argument("-W", type=int, default=3)
    gw.add_argument("-F", type=int, default=1)
    gw.add_argument("--max-iter", type=int, default=200)
    gw.add_argument("--last-win-osd", action="store_true")
    gw.add_argument("--low-error-mode", action="store_true")
    common(gw)

    cc = sub.add_parser("code-capacity", help="data-qubit noise (simulation.py)")
    cc.add_argument("--N", type=int, default=144)
    cc.add_argument("--p", type=float, default=0.02)
    cc.add_argument("--decoder", choices=["bposd", "gdg", "bpgd"], default="bposd")
    cc.add_argument("--osd-order", type=int, default=10)
    cc.add_argument("--scaling-factor", type=float, default=0.625)
    cc.add_argument("--batch", type=int, default=4096)
    common(cc)

    gl = sub.add_parser(
        "global", help="BB circuit-level whole-block BP+OSD (IBM.ipynb)"
    )
    gl.add_argument("--N", type=int, default=144)
    gl.add_argument("--p", type=float, default=0.004)
    gl.add_argument("--rounds", type=int, default=12)
    gl.add_argument("--max-iter", type=int, default=200)
    gl.add_argument("--osd-method", default="osd_cs")
    gl.add_argument("--osd-order", type=int, default=10)
    gl.add_argument("--shorten", action="store_true")
    gl.add_argument("--x-basis", action="store_true")
    gl.add_argument("--batch", type=int, default=8192)
    common(gl)

    ph = sub.add_parser(
        "phenomenological",
        help="iid data + syndrome flips (Syndrome code.ipynb)",
    )
    ph.add_argument("--N", type=int, default=288)
    ph.add_argument("--p", type=float, default=0.03)
    ph.add_argument("--p-synd", type=float, default=1e-3)
    ph.add_argument("--decoder", choices=["bposd", "gdg"], default="bposd")
    ph.add_argument("--osd-order", type=int, default=10)
    ph.add_argument("--batch", type=int, default=4096)
    common(ph)

    dp = sub.add_parser(
        "depolarizing", help="BP4(+OSD | CAMEL) under Depolarize(p) (Misc.ipynb)"
    )
    dp.add_argument("--N", type=int, default=882,
                    help="882 = QC-GHP [[882,24]]; else BB code by N")
    dp.add_argument("--p", type=float, default=0.1)
    dp.add_argument("--max-iter", type=int, default=100)
    dp.add_argument("--osd-method", default="osd_cs")
    dp.add_argument("--osd-order", type=int, default=10)
    dp.add_argument("--camel", action="store_true")
    dp.add_argument("--batch", type=int, default=2048)
    common(dp)

    sh = sub.add_parser("shyps", help="SHYPS memory experiment (SHYPS.ipynb)")
    sh.add_argument("--r", type=int, default=3)
    sh.add_argument("--p", type=float, default=0.001)
    sh.add_argument("--rounds", type=int, default=4)
    sh.add_argument("--window", action="store_true")
    sh.add_argument("-W", type=int, default=3)
    sh.add_argument("-F", type=int, default=1)
    sh.add_argument("--osd-order", type=int, default=0)
    common(sh)

    args = ap.parse_args(argv)
    verbose = not args.quiet

    try:
        return _dispatch(ap, args, verbose)
    except ValueError as exc:
        ap.exit(2, f"error: {exc}\n")


def _plain(value):
    """``value`` with every tensor, numpy array and numpy scalar turned
    into plain numbers and lists (no ``str`` of an array reaches the
    JSON)."""
    import numpy as np
    import torch

    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, torch.Tensor):
        value = value.cpu().numpy()
    if isinstance(value, (np.ndarray, np.generic)):
        return value.tolist()
    return value


def _dispatch(ap, args, verbose):
    dev = args.device

    if args.command == "sliding-window":
        from .circuit_level import sliding_window_decoder

        res = sliding_window_decoder(
            N=args.N, p=args.p, num_repeat=args.rounds, num_shots=args.shots,
            max_iter=args.max_iter, W=args.W, F=args.F, method=args.method,
            z_basis=not args.x_basis, shorten=args.shorten,
            osd_method=args.osd_method, osd_order=args.osd_order,
            seed=args.seed, verbose=verbose, device=dev,
        )
    elif args.command == "gdg-window":
        from .circuit_level import sliding_window_gdg

        res = sliding_window_gdg(
            N=args.N, p=args.p, num_repeat=args.rounds, num_shots=args.shots,
            max_iter=args.max_iter, W=args.W, F=args.F,
            last_win_osd=args.last_win_osd, low_error_mode=args.low_error_mode,
            seed=args.seed, verbose=verbose, device=dev,
        )
        res.pop("total_e_hat_osd", None)
        res.pop("total_e_hat", None)  # the port's driver returns it; the JAX one does not
    elif args.command == "code-capacity":
        from ..codes import bb_code_by_n
        from ..decoders import BPGD, BPOSD, GDG
        from .code_capacity import data_qubit_noise_decoding

        code, _, _ = bb_code_by_n(args.N)
        import numpy as np

        priors = np.full(code.N, args.p)
        if args.decoder == "bposd":
            dec = BPOSD(code.hx, priors, max_iter=100,
                        ms_scaling_factor=args.scaling_factor,
                        osd_method="osd_cs", osd_order=args.osd_order, device=dev)
        elif args.decoder == "gdg":
            dec = GDG(code.hx, priors, max_iter=24,
                      ms_scaling_factor=args.scaling_factor,
                      gdg_factor=args.scaling_factor, max_step=40,
                      max_tree_depth=4, max_side_depth=20,
                      max_tree_branch_step=30, max_side_branch_step=20,
                      new_n=code.N, low_error_mode=True, device=dev)
        else:
            dec = BPGD(code.hx, priors, max_iter=24,
                       ms_scaling_factor=args.scaling_factor,
                       gd_factor=args.scaling_factor, max_step=40,
                       new_n=code.N, device=dev)
        res = data_qubit_noise_decoding(
            code, args.p, args.shots, {args.decoder: dec},
            batch_size=args.batch, seed=args.seed, verbose=verbose,
        )
    elif args.command == "global":
        from .circuit_level import global_decoder

        res = global_decoder(
            N=args.N, p=args.p, num_repeat=args.rounds, num_shots=args.shots,
            max_iter=args.max_iter, z_basis=not args.x_basis,
            osd_method=args.osd_method, osd_order=args.osd_order,
            shorten=args.shorten, batch_size=args.batch, seed=args.seed,
            verbose=verbose, device=dev,
        )
    elif args.command == "phenomenological":
        from ..codes import bb_code_by_n
        from ..decoders import BPOSD, GDG
        from .phenomenological import decode_phenomenological

        code, _, _ = bb_code_by_n(args.N)
        if args.decoder == "bposd":
            builders = {
                "bposd": lambda pcm, pr: BPOSD(
                    pcm, pr, max_iter=100, osd_method="osd_cs",
                    osd_order=args.osd_order, device=dev,
                )
            }
        else:
            builders = {
                "gdg": lambda pcm, pr: GDG(pcm, pr, max_iter=100,
                                           ensemble_bucket=256, device=dev)
            }
        res = decode_phenomenological(
            code, args.p, args.p_synd, args.shots, builders,
            batch_size=args.batch, seed=args.seed, verbose=verbose,
        )
    elif args.command == "depolarizing":
        from .depolarizing import depolarizing_decoding

        if args.N == 882:
            from ..codes import (
                create_cyclic_permuting_matrix,
                create_QC_GHP_codes,
            )

            code = create_QC_GHP_codes(
                63, create_cyclic_permuting_matrix(7, [27, 54, 0]), [0, 1, 6]
            )
        else:
            from ..codes import bb_code_by_n

            code, _, _ = bb_code_by_n(args.N)
        res = depolarizing_decoding(
            code, args.p, args.shots, max_iter=args.max_iter,
            osd_method=args.osd_method, osd_order=args.osd_order,
            camel=args.camel, batch_size=args.batch, seed=args.seed,
            verbose=verbose, device=dev,
        )
    elif args.command == "shyps":
        from .shyps import decode_shyps

        res = decode_shyps(
            r=args.r, p=args.p, num_repeat=args.rounds, num_shots=args.shots,
            osd_order=args.osd_order, window=args.window, W=args.W, F=args.F,
            seed=args.seed, verbose=verbose, device=dev,
        )
        res.pop("e_hat", None)  # the port's driver returns it; the JAX one does not
    else:  # pragma: no cover
        ap.error(f"unknown command {args.command}")

    res = _plain(res)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=2)
    elif not verbose:
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
