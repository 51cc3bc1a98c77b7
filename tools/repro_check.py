#!/usr/bin/env python3
"""Whether one seed gives the same image twice on the GPU, per attention
route.

    python tools/repro_check.py [--family sdxl] [--routes rule,xla] [--n 3]
    XLA_FLAGS=--xla_gpu_deterministic_ops=true \\
        python tools/repro_check.py --routes rule

Writes the family's seeded random full-width checkpoint once into
``--workdir`` (kept for the next run, so the second command above reuses
it; delete the directory after), then for each route generates one seed
``--n`` times in one process at the family's bench size and prints how many
distinct uint8 images came out.  "rule" is the attention shape rule as
shipped; "xla" sends every attention call to ``attention_xla``.  Prints the
card's name and power limit and ``XLA_FLAGS``; refuses to run off the GPU.
The last image's time shows the route took effect (XLA's softmax is the
slower one on the card).
"""
import argparse
import contextlib
import hashlib
import json
import os
import sys
import time

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@contextlib.contextmanager
def forced_route(route):
    """"rule": the shape rule as shipped; "xla": every call on XLA."""
    import jax
    from mlimgsynth_tpu.ops import attention as A
    real = A.attention_route
    if route != "rule":
        A.attention_route = lambda d, dtype, platform: route
    jax.clear_caches()
    try:
        yield
    finally:
        A.attention_route = real


def checkpoint(family, workdir):
    """{session option: path} of the family's synthetic checkpoint, written
    on the first call."""
    index = os.path.join(workdir, f"{family}.json")
    if os.path.exists(index):
        with open(index) as f:
            return json.load(f)
    from mlimgsynth_tpu import testing
    from mlimgsynth_tpu.api import _model_types
    mt_name = chip_smoke.FAMILIES[family][0]
    os.makedirs(workdir, exist_ok=True)
    paths = testing.write_synthetic_model(workdir, mt_name,
                                          _model_types()[mt_name])
    with open(index, "w") as f:
        json.dump(paths, f)
    return paths


def image_digests(session, n, seed=0):
    """Short SHA-256 digests of ``n`` uint8 images of one seed from
    ``session``, and the seconds the last one took (the first compiles)."""
    out = []
    for _ in range(n):
        session.option_set("seed", seed)   # a generation advances the seed
        t0 = time.perf_counter()
        u8 = chip_smoke.to_u8(session.generate())
        dt = time.perf_counter() - t0
        out.append(hashlib.sha256(u8.tobytes()).hexdigest()[:12])
    return out, dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--family", choices=sorted(chip_smoke.FAMILIES),
                    default="sdxl")
    ap.add_argument("--routes", default="rule,xla",
                    help="comma-separated: rule, xla")
    ap.add_argument("--n", type=int, default=3)
    ap.add_argument("--workdir",
                    default=os.path.join(chip_smoke.WORK, "repro"))
    args = ap.parse_args(argv)
    try:
        chip_smoke.phase_device()
    except chip_smoke.SmokeError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    from mlimgsynth_tpu.utils.compcache import enable
    enable()
    mt_name, size, steps, cfg = chip_smoke.FAMILIES[args.family]
    paths = checkpoint(args.family, args.workdir)
    # one session: its weights stay on the card, and each route retraces
    # the cleared programs
    s = chip_smoke.make_session(paths, mt_name, size, steps, cfg, 0)
    flags = os.environ.get("XLA_FLAGS", "")
    for route in args.routes.split(","):
        with forced_route(route):
            d, dt = image_digests(s, args.n)
        print(f"[repro] {args.family} {size}px {steps} steps, attention "
              f"{route}, XLA_FLAGS '{flags}': {len(set(d))} distinct of "
              f"{len(d)} images of one seed ({', '.join(d)}), last "
              f"{dt:.4f} s/image; nvidia-smi: "
              f"{chip_smoke.nvidia_smi().splitlines()[0]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
