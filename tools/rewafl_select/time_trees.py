"""Check and time the rewafl_select kernel of several checkouts of this
repository, or of variants of its source, in turns on one GPU.

    python3 tools/rewafl_select/time_trees.py build/parent . . build/parent
    python3 tools/rewafl_select/time_trees.py --variants tools/rewafl_select/runs.json 9 .
    python3 tools/rewafl_select/time_trees.py --sizes 100,256,1024 \
        --variants tools/rewafl_select/runs.json 13 .

Each ROOT is a checkout (for another commit: `git archive <commit>`
unpacked into a git-ignored directory such as `build/parent`), timed in
the order given. With `--variants FILE RUN`, `FILE` maps a run number to
its variants: name -> a list of [old, new] string replacements applied
to `src/repro_torch/kernels/csrc/rewafl_select.cu` of the first ROOT;
each variant is a copy of that root's `src/` and `chip_smoke.py` under
`build/rewafl_variants/<name>/` (git-ignored), and the roots and variants
are timed in turns, forwards and then backwards.

For each, a fresh process builds that checkout's kernel into its own
`build/`, holds it bitwise against the plain version at K 20, eps 0 and
0.1, and times it with that checkout's `chip_smoke.time_select` (CUDA
events around a replayed CUDA graph of 10 calls, median of 25) at the FL
path's call, K 20, at the fleet sizes `--sizes` names (S 100 and 1e6
unless given; the check runs at those and at 100 and 1e6); the same
leaves, drawn from one seed, everywhere. Prints ptxas's
registers and spills of each build once, one line a root and fleet
size, and the card's name and power limit.
"""
import json
import os
import shutil
import subprocess
import sys

CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
sizes = [int(s) for s in sys.argv[2].split(",")]
import torch
import chip_smoke
from repro_torch.kernels import _build
from repro_torch.kernels.rewafl_select import ops, ref
_build.build_all(["rewafl_select"])
dev = torch.device("cuda")
ok = True
for S in sorted({100, 1_000_000, *sizes}):
    avail, ui, rnd = chip_smoke.select_inputs(S, "unavail30", 5, dev)
    for kx, kr in ((20, 0), (18, 2)):
        kw = dict(k_exploit=kx, k_explore=kr, T_round=60.0, alpha=1.0, beta=1.0)
        got, want = ops.select_topk(avail, ui, rnd, **kw), ref.select_topk(avail, ui, rnd, **kw)
        ok &= all(torch.equal(a, b) for a, b in zip(got, want))
times = {S: chip_smoke.time_select(dev, S) for S in sizes}
regs = [l.strip() for l in _build.ptxas_report("rewafl_select").splitlines()
        if "Function properties" in l or "Used" in l]
print(json.dumps({"ok": ok, "times": times, "ptxas": regs}))
"""


def make_variants(root: str, path: str, run: str) -> list:
    """One copy of root's src/ and chip_smoke.py a variant of `run`, with
    its replacements applied to the selection kernel's source."""
    out = []
    for name, reps in json.load(open(path))[run].items():
        dst = os.path.join(root, "build", "rewafl_variants", name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(os.path.join(root, "src"), os.path.join(dst, "src"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(root, "chip_smoke.py"), dst)
        cu = os.path.join(dst, "src/repro_torch/kernels/csrc/rewafl_select.cu")
        text = open(cu).read()
        for old, new in reps:
            if text.count(old) != 1:
                sys.exit(f"variant {name}: {old!r} occurs {text.count(old)} times")
            text = text.replace(old, new)
        open(cu, "w").write(text)
        out.append(dst)
    return out


def main() -> None:
    args = sys.argv[1:]
    sizes = "100,1000000"
    if args[:1] == ["--sizes"]:
        sizes, args = args[1], args[2:]
    variants = []
    if args[:1] == ["--variants"]:
        path, run, args = args[1], args[2], args[3:]
        variants = make_variants(os.path.abspath(args[0]), path, run)
    if not args:
        sys.exit(__doc__)
    order = [os.path.abspath(r) for r in args]
    if variants:
        order += variants
        order += order[::-1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    shown = set()
    for root in order:
        out = subprocess.run([sys.executable, "-c", CHILD, root, sizes], capture_output=True,
                             text=True, cwd=root)
        if out.returncode != 0:
            sys.exit(f"{root}: exited {out.returncode}\n{out.stderr[-3000:]}")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        if root not in shown:   # ptxas's registers and spills, once a build
            shown.add(root)
            for line in res["ptxas"]:
                print(f"ptxas {os.path.relpath(root)}: {line}", flush=True)
        for S, t in res["times"].items():
            print(f"rewafl_select {os.path.relpath(root)} S={S}: "
                  f"{'bitwise' if res['ok'] else 'DIFFERS from the plain version'}; "
                  f"kernel {t['ms']:.5f} ms (issued from Python {t['eager_ms']:.5f} "
                  f"ms), plain {t['plain_ms']:.5f} ms, library {t['library_ms']:.5f} "
                  f"ms, bound {t['bound_ms']:.6f} ms", flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
