"""Multi-pod dry run: prove the distribution config is coherent.

The PyTorch port of the reference's ``launch/dryrun.py``.  Every cell's
step is built for the production mesh, (data=16, model=16) or
(pod=2, data=16, model=16), and run once on fake tensors: the fake
process group (``launch/mesh.fake_production_mesh``, this process as
rank 0 of 256 or 512) stands in for the reference's 512 placeholder
host devices, so no environment variable has to be set before an
import, and a host with no card runs it.  The step is counted per rank
(``core/stepcount.count_cell``): ``roofline_raw`` is the count of the
full-depth step (eager execution runs every layer, so it needs no
calibration), ``roofline`` the calibrated roofline of
``core/trial.RooflineEvaluator``, ``memory_analysis`` the counter's
argument and peak bytes per rank.  Records go to
``results/torch/dryrun/``.

    python -m repro_torch.launch.dryrun --both-meshes --quiet
"""
import argparse
import json
import pathlib
import sys
import time
import traceback

from repro_torch.configs import (get_config, get_shape, list_archs, SHAPES,
                                 shape_applicable)
from repro_torch.core import costmodel
from repro_torch.core.params import TunableConfig, default_config

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "torch" / "dryrun"


def infra_default_rt(arch: str, **overrides) -> TunableConfig:
    """The cluster-level baseline configuration.

    Mirrors the paper: cluster settings (here: a 2D sharding able to hold
    every assigned model) are fixed infrastructure-wide per [8]; the 12
    application-level knobs start from Spark-like defaults (f32
    "Java serializer", no compression, balanced memory fractions ...).
    """
    base = dict(shard_strategy="fsdp_tp")
    base.update(overrides)
    return default_config(**base)


def _save(rec: dict, save: bool) -> None:
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        out = RESULTS_DIR / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
        out.write_text(json.dumps(rec, indent=1))


def run_cell(arch: str, shape_id: str, multi_pod: bool,
             rt: TunableConfig = None, save: bool = True) -> dict:
    from repro_torch.core import stepcount
    from repro_torch.core.trial import RooflineEvaluator, Workload
    from repro_torch.launch.mesh import fake_production_mesh
    cfg = get_config(arch)
    shape = get_shape(shape_id)
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    rec = {"arch": arch, "shape": shape_id, "mesh": mesh_name,
           "kind": shape.kind}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skip", reason=reason)
        _save(rec, save)
        return rec
    rt = rt or infra_default_rt(arch)
    rec["tunable"] = rt.as_dict()
    t0 = time.time()
    try:
        mesh = fake_production_mesh(multi_pod=multi_pod)
        chips = mesh.size()
        count, notes = stepcount.count_cell(cfg, shape, rt, mesh)
        rec["memory_analysis"] = {
            "argument_bytes": int(count.argument_bytes),
            "peak_bytes": int(count.peak_bytes),
        }
        raw = costmodel.roofline_of(count, compute_dtype=rt.compute_dtype)
        rec["roofline_raw"] = raw.as_dict()   # the full-depth count
        # calibrated terms: extrapolated from two small counts
        ev = RooflineEvaluator(use_cache=False)
        rl = ev.calibrated_roofline(Workload(arch, shape_id, multi_pod), rt)
        rec["roofline"] = rl.as_dict()
        rec["model_flops"] = costmodel.model_flops(cfg, shape)
        per_chip_model = rec["model_flops"] / chips
        rec["useful_flops_ratio"] = (
            per_chip_model / rl.flops_per_chip if rl.flops_per_chip else 0.0)
        hbm = costmodel.HW["hbm_per_chip"]
        rec["fits_hbm"] = rec["memory_analysis"]["peak_bytes"] <= hbm
        rec["sharding_notes"] = notes.get("sharding_notes", [])
        rec["status"] = "ok"
        rec["compile_s"] = round(time.time() - t0, 1)
    except Exception as e:
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:],
                   compile_s=round(time.time() - t0, 1))
    _save(rec, save)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape id (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for arch in archs:
        for shape_id in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape_id, mp)
                if rec["status"] == "ok":
                    rl = rec["roofline"]
                    ma = rec["memory_analysis"]
                    msg = (f"OK   {rec['mesh']:18s} {arch:22s} {shape_id:12s}"
                           f" bottleneck={rl['bottleneck']:10s}"
                           f" total={rl['total_s']*1e3:9.2f}ms"
                           f" peak/chip={ma['peak_bytes']/1e9:7.2f}GB"
                           f" fits={rec['fits_hbm']}")
                elif rec["status"] == "skip":
                    msg = (f"SKIP {rec['mesh']:18s} {arch:22s} {shape_id:12s}"
                           f" ({rec['reason'][:60]}...)")
                else:
                    failures += 1
                    msg = (f"FAIL {rec['mesh']:18s} {arch:22s} {shape_id:12s}"
                           f" {rec['error'][:120]}")
                if not args.quiet or rec["status"] != "ok":
                    print(msg, flush=True)
                if rec["status"] == "ok" and not args.quiet:
                    print(f"     memory_analysis: {rec['memory_analysis']}")
                    print(f"     count: flops/chip="
                          f"{rl['flops_per_chip']:.3e} bytes/chip="
                          f"{rl['bytes_per_chip']:.3e} coll_bytes="
                          f"{rl['collective_bytes']:.3e}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
