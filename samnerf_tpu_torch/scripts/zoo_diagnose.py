"""Train the zoo's hash methods on ``validate_zoo``'s scene twice, once
through the hand-written kernels (F32-ENC, F32-ENC-BWD) and once with
their plain PyTorch versions on the card in their place, and report each
run's losses, the PSNR of eval view 0 and of train view 0 (with and
without the occupancy grid) and the renders' mean colours: whether a low
zoo PSNR comes from the kernels or from the method.

    python3 -m samnerf_tpu_torch.scripts.zoo_diagnose [STEPS]

(STEPS defaults to 2000; 64 + 2 views of 128x128, detail 2, 4096 rays a
step, as ``validate_zoo --views 64``.)  Writes
``chiprun_out/zoo_diag.json``.  Runs on the card.
"""
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

from samnerf_tpu_torch import train as T
from samnerf_tpu_torch.data.datamanager import DataManager, DataManagerConfig
from samnerf_tpu_torch.data.dataparser import DataparserConfig
from samnerf_tpu_torch.ops import cuda_build, hash_grid as hg
from samnerf_tpu_torch.utils.metrics import psnr
from samnerf_tpu_torch.utils.synthetic import write_textured_scene

RUNS = (("instant-ngp", ("kernel", "plain")), ("depth-nerfacto", ("kernel", "plain")),
        ("semantic-nerfw", ("kernel",)))


def main() -> int:
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    if not torch.cuda.is_available():
        print("samnerf_tpu_torch.scripts.zoo_diagnose: no CUDA device", file=sys.stderr)
        return 1
    cuda_build.build_all()
    dev = torch.device("cuda", 0)
    kernel_fwd, kernel_bwd = hg.parity_hash_encode, hg.parity_hash_encode_bwd

    def plain(on):
        # the wrappers are module globals that the autograd function calls
        hg.parity_hash_encode = ((lambda t, p, s, n, h="reference":
                                  hg.parity_hash_encode_ref(t, p, s, n, h))
                                 if on else kernel_fwd)
        hg.parity_hash_encode_bwd = ((lambda g, p, s, n, h="reference":
                                      hg.parity_hash_encode_bwd_ref(g, p, s, n, h))
                                     if on else kernel_bwd)

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        scene = write_textured_scene(Path(tmp) / "zoo_scene", num_train=64, num_test=2,
                                     h=128, w=128, detail=2.0)
        dm = DataManager(DataManagerConfig(dataparser=DataparserConfig(
            data=scene, train_val_json_split=True)))
        for name, routes in RUNS:
            for route in routes:
                plain(route == "plain")
                losses, runs = {}, []

                def on_step(step, m):
                    if step in (1, 10, 100, 500, 1000, steps):
                        losses[step] = {k: float(v) for k, v in m.items()}

                t0 = time.time()
                rc = T.main([name, "--data", str(scene), "--max-num-iterations", str(steps),
                             "--rays-per-batch", "4096", "--output-dir",
                             str(Path(tmp) / "runs"), "--log-every", str(steps)],
                            device=dev, step_callback=on_step, run_callback=runs.append)
                run = runs[0]
                kw = {} if run.occupancy is None else {"occupancy": run.occupancy}
                out = {"rc": rc, "seconds": time.time() - t0, "eval_psnr": run.psnr,
                       "losses": losses}
                with torch.no_grad():
                    for split, cams, imgs in (("test", dm.eval_cameras, dm.eval_images),
                                              ("train", dm.cameras, dm.images)):
                        cams = cams.to(dev)
                        gt = torch.as_tensor(imgs[0], device=dev).float() / 255.0
                        rgb = T.render_eval_rgb(run.model, cams, 0, **kw)
                        out[f"{split}_psnr"] = float(psnr(rgb, gt))
                        out[f"{split}_rgb_mean"] = rgb.mean((0, 1)).tolist()
                        out[f"{split}_gt_mean"] = gt.mean((0, 1)).tolist()
                        if kw:
                            out[f"{split}_psnr_no_grid"] = float(
                                psnr(T.render_eval_rgb(run.model, cams, 0), gt))
                            out["occupied"] = float(run.occupancy.mean())
                results[f"{name}/{route}"] = out
                print(name, route, json.dumps(out), flush=True)
                del run, runs
                torch.cuda.empty_cache()
    plain(False)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/zoo_diag.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
