"""Runs one phase of chip_smoke.py, optionally on the port of another checkout.

    python3 vivid_tpu_torch/tools/smoke_phase.py train_sr [--port DIR]
    CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 vivid_tpu_torch/tools/smoke_phase.py shell \
        [--sr-model vivid-sr.pkl]

The phase's code is this checkout's `chip_smoke.py` (its `phase_<name>`,
after `phase_device`); `--port DIR` puts DIR, the root of another checkout,
first on the import path, so that the phase drives that checkout's
`vivid_tpu_torch`, its kernels built from its own `csrc/`. One measurement on
two trees: the parent commit's kernels against the change's, say, where the
parent's smoke lacks the measurement. Run it as a file, not with `-m`, so
that the package is imported only after `--port` has taken effect. Prints
the phase's lines and exits 0 when the phase passed.
"""

import argparse
import importlib.util
import inspect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phase", help="a phase of chip_smoke.py: train, train_sr, ...")
    ap.add_argument("--port", default=ROOT,
                    help="root of the checkout whose vivid_tpu_torch the phase drives")
    ap.add_argument("--sr-model", default=None,
                    help="a vivid-sr snapshot, for a phase that takes one (shell)")
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.abspath(args.port)]
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke   # a phase's spawned processes import it by name
    spec.loader.exec_module(smoke)
    import vivid_tpu_torch
    print(f"port: {os.path.dirname(os.path.dirname(vivid_tpu_torch.__file__))}", flush=True)
    card = smoke.phase_device()
    phase = getattr(smoke, f"phase_{args.phase}")
    params = inspect.signature(phase).parameters
    kwargs = {"sr_model": args.sr_model} if args.sr_model and "sr_model" in params else {}
    phase(*([card] if "card" in params else []), **kwargs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
