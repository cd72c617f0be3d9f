"""Command-line interface.

The reference's user surface is the OpenCL host CLI
(``./host -p <PER/64> -n <frames> -i <iters> -c <code> -e|-h``,
OpenCL/host/src/main.cpp:157-170) plus hand-edited MATLAB scripts. This CLI
covers both tiers:

  sim         FER sweep (the MATLAB sim drivers + FPGA data_out statistics)
  throughput  decoder throughput measurement (main.cpp:652-658 formula)
  scaling     mesh scaling-efficiency sweep (north star BASELINE.md:28)
  stream      UDP loopback streaming demo (encoder_VITA_in_UDP_out datapath)
  codes       list the registry
  census      4/6/8-cycle census of a code (Hcyclefinder)
  gen         construct a girth-8 code and save it (.npz)
  golden      generate + verify golden vector files (the MATLAB<->OpenCL
              cross-validation protocol)

Run as ``python -m ldpc_erasure_codes_tpu.utils.cli <cmd> ...``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_profile(s: str):
    """'102x6,30x5' -> [(102, 6), (30, 5)]."""
    out = []
    for part in s.split(","):
        cnt, deg = part.lower().split("x")
        out.append((int(cnt), int(deg)))
    return out


def cmd_sim(args) -> int:
    from ldpc_erasure_codes_tpu.codes import get_code
    from ldpc_erasure_codes_tpu.sim import (
        ChannelConfig,
        DecoderConfig,
        SimConfig,
        format_report,
        run_fer_sweep,
    )

    code = get_code(args.code)
    cfg = SimConfig(
        code=args.code,
        gf_order=args.gf,
        batch=args.batch,
        symbol_words=args.symbol_words,
        channel=ChannelConfig(kind=args.channel, per=0.0),
        decoder=DecoderConfig(
            kind=args.decoder,
            max_iters=args.max_iters,
            peel_iters=args.peel_iters,
            emax=args.emax,
            early_stop_k=args.early_stop_k,
        ),
        seed=args.seed,
        track_values=not args.pattern_only,
        steps_per_call=args.steps_per_call,
    )
    pers = [float(p) for p in args.pers.split(",")]
    points = run_fer_sweep(
        code,
        cfg,
        pers,
        target_errors=args.target_errors,
        max_frames=args.max_frames,
    )
    print(format_report(args.code, cfg, points))
    if args.json:
        for p in points:
            print(json.dumps(vars(p)))
    return 0


def make_throughput_step(code, arrays, *, batch: int, per: float, max_iters: int):
    """Jitted throughput step: on-device channel draw + the platform's wide
    value decode (``ops.peel_wide.peel_decode_packed``).

    The returned step's outputs DEPEND on the codeword values (an XOR digest
    of the decoded symbols, as bench.py): mask evolution is value-
    independent, so a mask-only output would let XLA dead-code-eliminate the
    entire wide value decode and report phantom Gbps (the measurement-
    integrity pitfall documented in VALIDATION.md). Regression-tested by
    tests/test_cli.py::test_throughput_step_consumes_values.
    """
    import jax
    import jax.numpy as jnp

    from ldpc_erasure_codes_tpu import channel as ch
    from ldpc_erasure_codes_tpu.ops.peel_wide import peel_decode_packed

    @jax.jit
    def step(key, cw):
        mask = ch.iid_erasures(key, (batch, code.n), per)
        recv = ch.apply_erasures(cw, mask)
        values, erased, _ = peel_decode_packed(
            arrays, recv, mask, max_iters=max_iters, early_stop_k=code.k
        )
        digest = jnp.bitwise_xor.reduce(
            jnp.bitwise_xor.reduce(values, axis=1), axis=0
        )
        return jnp.sum(erased[:, : code.k], dtype=jnp.int32), digest

    return step


def cmd_throughput(args) -> int:
    import jax
    import jax.numpy as jnp

    from ldpc_erasure_codes_tpu.codes import get_code
    from ldpc_erasure_codes_tpu.ops import device_arrays, make_packed_encoder

    code = get_code(args.code)
    arrays = device_arrays(code)
    b, w = args.batch, args.symbol_words
    key = jax.random.key(0)
    src = jax.random.bits(key, (b, code.k, w), dtype=jnp.uint32)
    cw = jax.block_until_ready(make_packed_encoder(code)(src))
    step = make_throughput_step(
        code, arrays, batch=b, per=args.per, max_iters=args.max_iters
    )
    jax.block_until_ready(step(jax.random.fold_in(key, 999), cw))
    t0 = time.perf_counter()
    out = None
    for i in range(args.reps):
        out = step(jax.random.fold_in(key, i), cw)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    fps = b * args.reps / dt
    gbps = fps * code.k * 32 * w / 1e9
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "code": args.code,
                "per": args.per,
                "frames_per_sec": fps,
                "info_gbps": gbps,
                "symbol_bits": 32 * w,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )
    return 0


def cmd_plot(args) -> int:
    """FER curve sweep -> semilogy PNG (MPA vs hybrid vs analytic RS)."""
    from ldpc_erasure_codes_tpu.codes import get_code
    from ldpc_erasure_codes_tpu.sim import (
        DecoderConfig,
        SimConfig,
        format_report,
        run_fer_sweep,
    )
    from ldpc_erasure_codes_tpu.sim.plot import plot_fer_curves

    code = get_code(args.code)
    pers = [float(p) for p in args.pers.split(",")]
    common = dict(
        code=args.code,
        batch=args.batch,
        track_values=False,
        steps_per_call=args.steps_per_call,
    )
    peel_cfg = SimConfig(
        **common,
        decoder=DecoderConfig(kind="peel", max_iters=50, early_stop_k=True),
    )
    peel_pts = run_fer_sweep(
        code, peel_cfg, pers,
        target_errors=args.target_errors, max_frames=args.max_frames,
    )
    print(format_report(f"{args.code} MPA", peel_cfg, peel_pts), flush=True)
    hyb_cfg = SimConfig(
        **common,
        decoder=DecoderConfig(
            kind="hybrid", max_iters=50, emax=args.emax, ge_subbatch=args.batch // 8
        ),
    )
    hyb_pts = run_fer_sweep(
        code, hyb_cfg, pers,
        target_errors=args.target_errors, max_frames=args.max_frames,
    )
    print(format_report(f"{args.code} hybrid", hyb_cfg, hyb_pts), flush=True)
    rs = (code.rs_n, code.rs_k) if code.rs_n else None
    plot_fer_curves(
        peel_pts,
        title=f"{args.code}: FER vs raw erasure rate",
        rs_analytic=rs,
        extra_series={"LDPC hybrid MPA+ML": hyb_pts},
        out_path=args.out,
    )
    print(f"wrote {args.out}")
    return 0


def cmd_scaling(args) -> int:
    """Scaling-efficiency measurement over the device mesh (north star:
    >=80% codewords/s efficiency at >=2 hosts, BASELINE.md:28). On a single
    host this sweeps sub-meshes of the local devices; under a multi-process
    launch (jax.distributed) the mesh spans all hosts."""
    from ldpc_erasure_codes_tpu.codes import get_code
    from ldpc_erasure_codes_tpu.parallel.scaling import measure_scaling
    from ldpc_erasure_codes_tpu.sim import DecoderConfig, SimConfig

    code = get_code(args.code)
    cfg = SimConfig(
        code=args.code,
        batch=args.batch,
        track_values=False,
        decoder=DecoderConfig(
            kind=args.decoder, max_iters=args.max_iters, early_stop_k=True
        ),
        steps_per_call=args.steps_per_call,
    )
    counts = (
        [int(c) for c in args.devices.split(",")] if args.devices else None
    )
    points = measure_scaling(
        code, cfg, args.per, device_counts=counts, reps=args.reps
    )
    for p in points:
        print(
            json.dumps(
                {
                    "devices": p.devices,
                    "frames": p.frames,
                    "seconds": round(p.seconds, 4),
                    "frames_per_sec": round(p.frames_per_sec, 1),
                    "efficiency": round(p.efficiency, 4),
                }
            )
        )
    return 0


def cmd_stream(args) -> int:
    """End-to-end UDP loopback streaming demo: encode -> lossy reordered
    datagrams -> reorder buffer -> batched device decode -> bit-exact
    verification (reference datapath:
    OpenCL/device/ldpc_erasure_encoder_VITA_in_UDP_out.cl:84-136)."""
    from ldpc_erasure_codes_tpu.utils.udp import loopback_demo

    r = loopback_demo(
        args.code,
        blocks=args.blocks,
        symbol_words=args.symbol_words,
        loss=args.loss,
        shuffle=not args.in_order,
        seed=args.seed,
        assembler=args.assembler,
        vita=args.vita,
    )
    out = {
        "blocks": r.blocks,
        "packets_sent": r.packets_sent,
        "packets_received": r.packets_received,
        "blocks_recovered": r.blocks_recovered,
        "blocks_failed": r.blocks_failed,
        "packets_per_sec": round(r.packets_per_sec, 1),
        "payload_gbps": round(r.payload_gbps, 3),
        "transfer_complete": r.transfer_complete,
        "assembler": r.stats,
    }
    if r.vita_stats is not None:
        out["vita"] = r.vita_stats
    print(json.dumps(out))
    return 0 if r.blocks_recovered + r.blocks_failed == r.blocks else 1


def cmd_codes(_args) -> int:
    from ldpc_erasure_codes_tpu.codes import get_code, list_codes

    for name in list_codes():
        c = get_code(name)
        print(
            f"{name}: n={c.n} k={c.k} rate={c.k/c.n:.3f} dmax={c.dmax} "
            f"gf={c.gf_order} rs=({c.rs_n},{c.rs_k}) "
            f"triangular={c.is_triangular}"
        )
    return 0


def cmd_census(args) -> int:
    from ldpc_erasure_codes_tpu.codes import cycle_census, get_code, load_code

    code = load_code(args.code) if args.code.endswith(".npz") else get_code(args.code)
    cen = cycle_census(code)
    n4, n6, n8 = cen.totals()
    print(
        f"{code.name}: 4-cycles={n4} 6-cycles={n6} 8-cycles={n8} "
        f"girth>=8: {cen.girth_at_least_8}"
    )
    return 0


def cmd_gen(args) -> int:
    from ldpc_erasure_codes_tpu.codes import (
        cycle_census,
        gen_column_wise,
        gen_row_wise,
        save_code,
    )

    prof_c = _parse_profile(args.profile_c)
    prof_v = _parse_profile(args.profile_v)
    t0 = time.time()
    if args.kind == "row":
        code = gen_row_wise(prof_c, prof_v, seed=args.seed, max_tries=args.max_tries)
    else:
        code = gen_column_wise(
            prof_c,
            prof_v,
            systematic=not args.non_systematic,
            seed=args.seed,
            max_tries=args.max_tries,
        )
    cen = cycle_census(code)
    print(
        f"built {code.name} in {time.time()-t0:.1f}s; census 4/6/8 = "
        f"{cen.totals()}; triangular={code.is_triangular}"
    )
    if args.out:
        save_code(code, args.out)
        print(f"saved to {args.out}")
    return 0


def cmd_golden(args) -> int:
    from ldpc_erasure_codes_tpu.utils import golden

    if args.rs:
        n, k = (int(x) for x in args.rs.split(","))
        gs = golden.generate_golden_rs(
            n, k, args.dir, frames=args.frames, per=args.per, seed=args.seed
        )
        print(f"wrote {gs.frames} golden RS frames to {gs.directory}")
        passed, report = golden.verify_golden_rs(
            n, k, args.dir, words=args.symbol_words
        )
        print(report)
        return 0 if passed else 1

    from ldpc_erasure_codes_tpu.codes import get_code

    code = get_code(args.code)
    if args.gf == 256:
        code = code.lift_to_gf256() if code.gf_order == 2 else code
        gs = golden.generate_golden_nb(
            code, args.dir, frames=args.frames, per=args.per, seed=args.seed
        )
        print(f"wrote {gs.frames} golden NB frames to {gs.directory}")
        passed, report = golden.verify_golden_nb(
            code, args.dir, words=args.symbol_words
        )
    else:
        gs = golden.generate_golden(
            code, args.dir, frames=args.frames, per=args.per, seed=args.seed
        )
        print(f"wrote {gs.frames} golden frames to {gs.directory}")
        passed, report = golden.verify_golden(
            code, args.dir, words=args.symbol_words
        )
    print(report)
    return 0 if passed else 1


def cmd_verify(args) -> int:
    """PASSED/FAILED decode verification battery (utils/verify.py): every
    production decode tier end-to-end, decoded values/masks bit-exact
    against the encoded input — the reference's verify_output() contract
    (OpenCL/host/src/main.cpp:298-305,413-425)."""
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        # main() enabled the persistent cache before argument parsing; the
        # CPU backend runs without it (utils/cache.py).
        jax.config.update("jax_compilation_cache_dir", None)

    from ldpc_erasure_codes_tpu.utils.verify import run_battery

    results = run_battery(quick=args.quick)
    for r in results:
        print(json.dumps(r), flush=True)
    ok = all(r["status"] == "PASSED" for r in results)
    print(f"VERIFY: {'ALL PASSED' if ok else 'FAILURES'}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(
                {
                    "backend": jax.default_backend(),
                    "all_passed": ok,
                    "tiers": results,
                },
                f,
                indent=1,
            )
    return 0 if ok else 1


def main(argv: list[str] | None = None) -> int:
    # Persistent compile cache: repeated CLI invocations (sim sweeps,
    # throughput runs) reuse compiled executables across processes.
    from ldpc_erasure_codes_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    p = argparse.ArgumentParser(prog="ldpc_erasure_codes_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("sim", help="FER sweep")
    ps.add_argument("--code", default="n2000_k1000")
    ps.add_argument("--decoder", default="hybrid", choices=["peel", "hybrid", "ml"])
    ps.add_argument("--gf", type=int, default=2, choices=[2, 256])
    ps.add_argument("--pers", default="0.3,0.35", help="comma-separated PERs")
    ps.add_argument("--channel", default="iid", choices=["iid", "per64", "gilbert_elliott"])
    ps.add_argument("--batch", type=int, default=512)
    ps.add_argument("--symbol-words", type=int, default=0)
    ps.add_argument("--max-iters", type=int, default=50)
    ps.add_argument("--peel-iters", type=int, default=10)
    ps.add_argument("--emax", type=int, default=128)
    ps.add_argument("--early-stop-k", action="store_true")
    ps.add_argument("--target-errors", type=int, default=100)
    ps.add_argument("--max-frames", type=int, default=1_000_000)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--json", action="store_true")
    ps.add_argument(
        "--pattern-only",
        action="store_true",
        help="FER fast path: evolve erasure patterns only, skip symbol values",
    )
    ps.add_argument(
        "--steps-per-call",
        type=int,
        default=8,
        help="batches per device dispatch (amortizes launch latency)",
    )
    ps.set_defaults(fn=cmd_sim)

    pt = sub.add_parser("throughput", help="decoder throughput")
    pt.add_argument("--code", default="n2040_k1530")
    pt.add_argument("--per", type=float, default=0.1406)
    pt.add_argument("--batch", type=int, default=512)
    pt.add_argument("--symbol-words", type=int, default=256)
    pt.add_argument("--max-iters", type=int, default=50)
    pt.add_argument("--reps", type=int, default=20)
    pt.set_defaults(fn=cmd_throughput)

    pc = sub.add_parser("codes", help="list registry codes")
    pc.set_defaults(fn=cmd_codes)

    psc = sub.add_parser("scaling", help="mesh scaling-efficiency sweep")
    psc.add_argument("--code", default="n2000_k1000")
    psc.add_argument("--decoder", default="peel", choices=["peel", "hybrid", "ml"])
    psc.add_argument("--per", type=float, default=0.3)
    psc.add_argument("--batch", type=int, default=256, help="per-device batch")
    psc.add_argument("--max-iters", type=int, default=20)
    psc.add_argument("--steps-per-call", type=int, default=4)
    psc.add_argument("--reps", type=int, default=4)
    psc.add_argument("--devices", default="", help="comma list, e.g. 1,2,4,8")
    psc.set_defaults(fn=cmd_scaling)

    pst = sub.add_parser("stream", help="UDP loopback streaming demo")
    pst.add_argument("--code", default="n2000_k1000")
    pst.add_argument("--blocks", type=int, default=8)
    pst.add_argument("--symbol-words", type=int, default=2)
    pst.add_argument("--loss", type=float, default=0.1)
    pst.add_argument("--in-order", action="store_true")
    pst.add_argument("--assembler", default="auto", choices=["auto", "python"])
    pst.add_argument(
        "--vita", action="store_true",
        help="source symbols arrive as a VITA-49 stream over UDP first "
        "(the reference encoder's ingest)",
    )
    pst.add_argument("--seed", type=int, default=0)
    pst.set_defaults(fn=cmd_stream)

    pp = sub.add_parser("plot", help="FER curve sweep -> PNG")
    pp.add_argument("--code", default="n2040_k1530")
    pp.add_argument("--pers", default="0.1406,0.1562,0.1719,0.1875,0.2031")
    pp.add_argument("--batch", type=int, default=4096)
    pp.add_argument("--steps-per-call", type=int, default=16)
    pp.add_argument("--target-errors", type=int, default=100)
    pp.add_argument("--max-frames", type=int, default=1_000_000)
    pp.add_argument("--emax", type=int, default=256)
    pp.add_argument("--out", default="fer_curve.png")
    pp.set_defaults(fn=cmd_plot)

    pn = sub.add_parser("census", help="cycle census")
    pn.add_argument("--code", default="n2000_k1000")
    pn.set_defaults(fn=cmd_census)

    pg = sub.add_parser("gen", help="construct a girth-8 code")
    pg.add_argument("--kind", default="row", choices=["row", "col"])
    pg.add_argument("--profile-c", required=True, help="e.g. 102x6")
    pg.add_argument("--profile-v", required=True, help="e.g. 204x3")
    pg.add_argument("--non-systematic", action="store_true")
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--max-tries", type=int, default=200)
    pg.add_argument("--out", default="")
    pg.set_defaults(fn=cmd_gen)

    pvf = sub.add_parser(
        "verify", help="PASSED/FAILED decode verification battery"
    )
    pvf.add_argument("--quick", action="store_true")
    pvf.add_argument("--cpu", action="store_true")
    pvf.add_argument("--out", default=None)
    pvf.set_defaults(fn=cmd_verify)

    pv = sub.add_parser("golden", help="golden-vector generate + verify")
    pv.add_argument("--code", default="n2000_k1000")
    pv.add_argument("--gf", type=int, default=2, choices=[2, 256])
    pv.add_argument("--rs", default="", help="RS golden instead: 'n,k'")
    pv.add_argument("--dir", required=True)
    pv.add_argument("--frames", type=int, default=4)
    pv.add_argument("--per", type=float, default=0.2)
    pv.add_argument("--symbol-words", type=int, default=8)
    pv.add_argument("--seed", type=int, default=0)
    pv.set_defaults(fn=cmd_golden)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
