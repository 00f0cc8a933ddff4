"""Time `select_aggregate`'s two launches with programmatic dependent
launch (PDL) and without, in turns, on one GPU; optionally for several
checkouts or variants of the kernel sources.

    python3 tools/select_aggregate/pdl_turns.py [--turns N]
    python3 tools/select_aggregate/pdl_turns.py --variants \\
        tools/select_aggregate/runs.json 1 .

At S 100, K 20, P 206,922 (rows contiguous, and at a stride of 206,924:
16-byte loads), and S 8,193, K 257, P 206,922 (f32, eps 0, ~30% of the
devices unavailable, the leaves and deltas of `chip_smoke.agg_inputs`),
the selection kernel then `fedavg_indexed`
(`rewafl_select.ops.aggregate_launches`) with `pdl` on and off: both
results are checked equal to each other and the mask to the plain
version's, then each is timed, on, off, off, on: one call's device time
graph-replayed (`chip_smoke.time_ms`: CUDA events around a replayed
graph of 10 calls, median of 25), L2-cold after 256 MB are written
(`chip_smoke.time_cold_ms`, median of 50: the L2 is left dirty), after
256 MB are read instead (the L2 left clean), and warm with one call a
graph as the L2-cold timings replay it (what a one-call graph adds).
Also fedavg_indexed alone on the call's slots, graph-replayed.

Each ROOT (the repository itself when none is given; another commit:
`git archive` unpacked into a git-ignored directory such as
`build/parent`) runs in a fresh process that builds its own kernels
into its own `build/`. With `--variants FILE RUN`, `FILE` maps a run
number to variants: name -> a list of [source under
src/repro_torch/kernels/csrc/, old, new] string replacements applied to
a copy of the first ROOT's `src/` and `chip_smoke.py` under
`build/select_aggregate_variants/<name>/` (git-ignored); each run's
replacements match the sources of the tree they were written against
(`tools/select_aggregate/runs.json`: runs 1–4, PERF.md §6). Roots and
variants run in turns, forwards then backwards, `--turns` times (1 with
variants, else 3). Prints ptxas's registers and spills of fedavg_indexed
once a build, one line a run, the medians, and the card's name and
power limit.
"""
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHILD = """
import json, statistics, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke
from repro_torch.kernels import _build
from repro_torch.kernels.fedavg import ops as fops
from repro_torch.kernels.rewafl_select import ops, ref
_build.build_all(["fedavg", "rewafl_select"])
dev = torch.device("cuda")
kw = dict(T_round=60.0, alpha=1.0, beta=1.0)
out = {"ok": True, "rows": {}}


def time_one_ms(fn, flush, reps=50):
    buf = torch.empty(chip_smoke.FLUSH_BYTES // 4, device=dev)
    fn()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        fn()
    ev = []
    for _ in range(reps):
        if flush:
            buf.sum()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


for S, K, P, pad in ((100, 20, 206_922, 0), (100, 20, 206_922, 2), (8193, 257, 206_922, 0)):
    avail, ui, rnd, deltas, w = chip_smoke.agg_inputs(S, K, P, "unavail30", 11, dev)
    if pad:   # rows at a stride of P + pad
        deltas = torch.nn.functional.pad(deltas, (0, pad))[:, :P]

    def run(pdl):
        return lambda: ops.aggregate_launches(avail, ui, None, deltas, w, pdl=pdl,
                                              k_exploit=K, k_explore=0, **kw)

    (m_on, a_on), (m_off, a_off) = run(True)(), run(False)()
    pmask, pagg = ref.select_aggregate(rnd, K, avail, 0.0, ui, deltas, w, **kw)
    torch.cuda.synchronize()
    out["ok"] &= (torch.equal(m_on, pmask) and torch.equal(m_off, pmask)
                  and torch.equal(a_on, a_off)
                  and (a_on - pagg).abs().max().item() <= chip_smoke.AGG_ATOL)
    idx, live = ops.select_topk(avail, ui, None, k_exploit=K, k_explore=0, **kw)
    t = {}
    for pdl in (True, False, False, True):
        key = "on" if pdl else "off"
        t.setdefault(key, []).append((chip_smoke.time_ms(run(pdl)),
                                      chip_smoke.time_cold_ms(run(pdl)),
                                      time_one_ms(run(pdl), True),
                                      time_one_ms(run(pdl), False)))
    t["kernel_ms"] = chip_smoke.time_ms(
        lambda: fops.weighted_aggregate_indexed(deltas, idx, live, w))
    out["rows"][f"S {S}, K {K}, P {P}" + (f", ld {P + pad}" if pad else "")] = t
    del deltas
    torch.cuda.empty_cache()
out["ptxas"] = [l.strip() for l in _build.ptxas_report("fedavg").splitlines()
                if "Used" in l or "spill" in l or "fedavg_indexed" in l]
print(json.dumps(out))
"""


def make_variants(root: str, path: str, run: str) -> list:
    """A copy of root's src/ and chip_smoke.py a variant of `run`, with its
    replacements applied to the kernel sources."""
    out = []
    for name, reps in json.load(open(path))[run].items():
        dst = os.path.join(root, "build", "select_aggregate_variants", name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(os.path.join(root, "src"), os.path.join(dst, "src"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(root, "chip_smoke.py"), dst)
        for src, old, new in reps:
            cu = os.path.join(dst, "src/repro_torch/kernels/csrc", src)
            text = open(cu).read()
            if text.count(old) != 1:
                sys.exit(f"variant {name}: {old!r} occurs {text.count(old)} times in {src}")
            open(cu, "w").write(text.replace(old, new))
        out.append(dst)
    return out


def main() -> None:
    args = sys.argv[1:]
    turns = None
    if args[:1] == ["--turns"]:
        turns, args = int(args[1]), args[2:]
    variants = []
    if args[:1] == ["--variants"]:
        path, run, args = args[1], args[2], args[3:]
        variants = make_variants(os.path.abspath(args[0] if args else ROOT), path, run)
    order = [os.path.abspath(r) for r in args] or [ROOT]
    if variants:
        order += variants
    turns = turns or (1 if variants else 3)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    runs, shown = {}, set()
    for t in range(turns):
        for root in order + order[::-1]:
            res = subprocess.run([sys.executable, "-c", CHILD, root], capture_output=True,
                                 text=True, cwd=root)
            if res.returncode != 0:
                sys.exit(f"{root}: exited {res.returncode}\n{res.stderr[-3000:]}")
            out = json.loads(res.stdout.strip().splitlines()[-1])
            name = os.path.relpath(root, ROOT)
            if root not in shown:
                shown.add(root)
                for line in out["ptxas"]:
                    print(f"ptxas {name}: {line}", flush=True)
            for shape, r in out["rows"].items():
                for key in ("on", "off"):
                    for ms, cold, rcold, one in r[key]:
                        runs.setdefault((name, shape, key), []).append(
                            (ms, cold, rcold, one))
                        print(f"{name} {shape} turn {t} PDL {key:3s}: "
                              f"{'checked' if out['ok'] else 'DIFFERS from the plain version'}; "
                              f"{ms:.5f} ms graph-replayed, {cold:.5f} ms L2-cold "
                              f"(written), {rcold:.5f} ms L2-cold (read), {one:.5f} ms "
                              f"one call a graph (warm); fedavg_indexed alone "
                              f"{r['kernel_ms']:.5f} ms", flush=True)
            if not out["ok"]:
                sys.exit(f"{name}: differs from the plain version")
    for (name, shape, key), v in runs.items():
        med = [statistics.median(x[i] for x in v) for i in range(4)]
        print(f"median {name} {shape} PDL {key:3s} over {len(v)}: {med[0]:.5f} ms "
              f"graph-replayed (range {min(x[0] for x in v):.5f}-"
              f"{max(x[0] for x in v):.5f}), L2-cold {med[1]:.5f} (written) "
              f"{med[2]:.5f} (read), one call a graph {med[3]:.5f}", flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
