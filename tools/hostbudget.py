"""Host-stage budget per BASELINE config.

For FLAC/NJAD configs the e2e ceiling may be the HOST pipeline. This
measures each host stage's per-core xRT at the shape its config feeds
it, with the interleaved median-of-pairs protocol (a shared host's
clock wanders), and derives the core count each config needs to keep
the aggregate at >=1000x RT.

Stages:
  njad      — native/src/njad.cc requantizer (config 3: 20-bit @ 88.2k),
              threads 1 vs 2 (channel-parallel; on a 1-core box the A/B
              pins that threading costs nothing, not that it gains)
  flac88    — native/src/flac.cc encode, 20-bit @ 88.2k (config 3)
  flac352   — 24-bit @ 352.8k (configs 1/5 FLAC output)
  pack24    — the s24 drain of configs 1/2: device byte-plane pack
              (pipeline/transfer.pack24_jitted), copy to host, and
              interleave to wire bytes (unpack24_host)

    python tools/hostbudget.py [--seconds 4] [--pairs 5] [--write]

--write refreshes HOSTBUDGET.md at the repo root.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import sys
import time

_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_ROOT))

import numpy as np


def _music(n: int, rate: int, bits: int, rng) -> np.ndarray:
    """Pink-ish stereo int32 at `bits` — the material FLAC compression
    decisions are hardest on (tools/flacbench.py)."""
    w = rng.standard_normal(n + 1024)
    k = np.exp(-np.arange(256) / 48.0)
    x = np.convolve(w, k / k.sum(), mode="same")[:n]
    x = 0.3 * x / np.abs(x).max()
    s = np.round(x * (2 ** (bits - 1) - 1)).astype(np.int32)
    return np.stack([s, np.roll(s, 7)], axis=1)


def _median_pairs(fa, fb, pairs: int):
    """Interleaved A,B reps; returns (median_a, median_b, median ratio
    a/b per pair)."""
    ta, tb = [], []
    for _ in range(pairs):
        t0 = time.perf_counter(); fa(); ta.append(time.perf_counter() - t0)
        t0 = time.perf_counter(); fb(); tb.append(time.perf_counter() - t0)
    ratios = [a / b for a, b in zip(ta, tb)]
    return (statistics.median(ta), statistics.median(tb),
            statistics.median(ratios))


def stage_runners(secs: float, rng):
    """name -> (run(), threads_env | None) for every budgeted host
    stage, at the shape its BASELINE config feeds it. Shared by main()
    and the CI floor test (tests/test_hostbudget_floor.py) so the
    measured table and the regression gate cannot drift apart."""
    import jax

    from dsd2dxd_tpu.native import lib as native
    from dsd2dxd_tpu.pipeline.transfer import pack24_jitted, unpack24_host

    n88 = int(secs * 88200)
    xf = (_music(n88, 88200, 20, rng).astype(np.float32)
          / float(1 << 19)).astype(np.float32)

    def run_njad():
        st = native.njad_new(2)
        native.njad_quantize(st, xf, 20)
        native.njad_free(st)

    def flac_encode(x, rate, bps):
        enc = native.flac_new(rate, 2, bps, 8192)
        native.flac_feed(enc, x)
        native.flac_drain(enc)
        native.flac_finish(enc)
        native.flac_drain(enc)
        native.flac_free(enc)

    x88 = _music(n88, 88200, 20, rng)
    n352 = int(secs * 352800)
    x352 = _music(n352, 352800, 24, rng)
    # the engine's drain input: a (frames, C) int32 tile on the device
    pcm = jax.device_put(_music(n352, 352800, 24, rng))
    pack = pack24_jitted(0)

    def run_pack24():
        unpack24_host(np.asarray(pack(pcm)))

    return {
        "njad": (run_njad, "DSDKIT_NJAD_THREADS"),
        "flac88": (lambda: flac_encode(x88, 88200, 20),
                   "DSDKIT_FLAC_THREADS"),
        "flac352": (lambda: flac_encode(x352, 352800, 24),
                    "DSDKIT_FLAC_THREADS"),
        "pack24": (run_pack24, None),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    secs = args.seconds
    rows = {}

    def measure(name, fn, audio_s, threads_env=None):
        """Median xRT over pairs*2 reps; optional threads=1-vs-2 A/B."""
        fn()  # warm: builds the native lib, compiles the device pack
        if threads_env is None:
            ts = []
            for _ in range(args.pairs * 2):
                t0 = time.perf_counter(); fn(); ts.append(
                    time.perf_counter() - t0)
            xrt = audio_s / statistics.median(ts)
            rows[name] = {"xrt_per_core": round(xrt, 1)}
            print(f"{name:10s} {xrt:8.1f}x RT/core")
        else:
            def with_threads(n):
                def run():
                    os.environ[threads_env] = str(n)
                    try:
                        fn()
                    finally:
                        os.environ.pop(threads_env, None)
                return run
            t1, t2, ratio = _median_pairs(with_threads(1), with_threads(2),
                                          args.pairs)
            xrt = audio_s / t1
            rows[name] = {"xrt_per_core": round(xrt, 1),
                          "t1_over_t2": round(ratio, 3)}
            print(f"{name:10s} {xrt:8.1f}x RT/core   "
                  f"threads1/threads2 = {ratio:.3f} "
                  f"({os.cpu_count()}-core box)")

    for name, (fn, threads_env) in stage_runners(secs, rng).items():
        measure(name, fn, secs, threads_env=threads_env)

    import jax

    out = {"seconds": secs, "pairs": args.pairs, "cores": os.cpu_count(),
           "backend": jax.default_backend(), "stages": rows}
    print(json.dumps(out))
    if args.write:
        _write_md(out)
    return 0


def _write_md(out) -> None:
    njad = out["stages"]["njad"]["xrt_per_core"]
    f88 = out["stages"]["flac88"]["xrt_per_core"]
    f352 = out["stages"]["flac352"]["xrt_per_core"]
    pack = out["stages"]["pack24"]["xrt_per_core"]

    def cores(x):  # cores to keep a stage at >=1000x RT
        return max(1, int(np.ceil(1000.0 / x)))

    md = f"""# Host-stage budget (measured {time.strftime('%Y-%m-%d')} on a \
{out['cores']}-core CPU host, JAX backend {out['backend']}, \
interleaved median-of-pairs)

Per-core xRT of each HOST pipeline stage at the shape its BASELINE
config feeds it (device stages overlap these via the engine's
triple-overlap pipeline, so a config's host ceiling is its slowest
host stage divided by the cores given to it). Refresh with
`python tools/hostbudget.py --write`.

| Stage | Shape | xRT/core | cores for >=1000x |
|---|---|---|---|
| NJAD requantize | 20-bit @ 88.2k stereo | {njad:.0f}x | {cores(njad)} \
(channel-parallel, so <= {cores(njad)} only when channels >= that; \
stereo caps the speedup at 2x/stream — beyond that, streams scale) |
| FLAC encode | 20-bit @ 88.2k stereo | {f88:.0f}x | {cores(f88)} |
| FLAC encode | 24-bit @ 352.8k stereo | {f352:.0f}x | {cores(f352)} |
| pack s24 wire (device pack + copy + interleave) | 24-bit @ 352.8k stereo | {pack:.0f}x | {cores(pack)} |

## Per-config host ceilings

- **Config 1/2 (WAV / raw s24)**: the s24 drain at {pack:.0f}x/core is
  the only host stage; ~{cores(pack)} core(s) keep it at >=1000x. With
  JAX backend `cpu` its device pack runs on these same host cores, so
  this row overstates the host cost of a GPU run.
- **Config 3 (DSD128 -> 88.2k FLAC 20-bit NJAD)**: serial-per-core chain
  NJAD ({njad:.0f}x) -> FLAC ({f88:.0f}x). NJAD parallelizes
  across channels (2x for stereo, byte-identical — native/src/njad.cc),
  FLAC across blocks (DSDKIT_FLAC_THREADS). Aggregate >=1000x needs
  ~{cores(njad)} core(s) for NJAD + ~{cores(f88)} core(s) for FLAC when
  stages overlap (they do: NJAD runs on the drain thread, FLAC fans out
  blocks).
- **Config 5 (batch -> 24-bit FLAC)**: FLAC at {f352:.0f}x/core needs
  ~{cores(f352)} cores/stream; the CLI's cores/2 pool runs streams in
  parallel, so a batch saturates any core count with whole-stream
  parallelism first (SURVEY §2.6 file-level DP).

Threading A/Bs on this host (threads1/threads2 time ratios):
{out['stages']['njad'].get('t1_over_t2')}, \
{out['stages']['flac88'].get('t1_over_t2')}, \
{out['stages']['flac352'].get('t1_over_t2')} (>1 means the second
thread helps; on a 1-core host the ratio only shows that threading
costs nothing).
"""
    (_ROOT / "HOSTBUDGET.md").write_text(md)
    (_ROOT / "HOSTBUDGET.json").write_text(json.dumps(out, indent=1))
    print("wrote HOSTBUDGET.md / HOSTBUDGET.json")


if __name__ == "__main__":
    sys.exit(main())
