"""Export a run of the JAX package's zoo loop for the port's replay.

    JAX_PLATFORMS=cpu python tests/export_zoo_replay.py \\
        [--method depth-nerfacto] [--setting 64x128x4096x208] [--seed 42] --out RUN.pt

JAX's ``train_zoo`` step for depth-nerfacto or semantic-NeRF-W on the CPU
at the method's full widths, on ``validate_zoo``'s textured scene
(``VIEWS`` + 2 views of ``RES`` x ``RES``, detail 2), ``RAYS`` rays a step
for ``STEPS`` steps. The file holds JAX's init as the port's state dict,
every step's pixel indices and sampler jitter, JAX's per-step losses and
its eval PSNR of eval view 0; ``python3 -m
samnerf_tpu_torch.scripts.zoo_diagnose replay RUN.pt`` runs it through
the port's step on the card. Not a test module: it imports JAX and the
port, so it lives beside the tests that do the same.
"""
import argparse
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from samnerf_tpu.configs import zoo as jzoo  # noqa: E402
from samnerf_tpu.core.cameras import generate_rays as jax_rays  # noqa: E402
from samnerf_tpu_torch.convert import zoo_params_from_jax  # noqa: E402


def export_jax_run(name, views, res, rays, steps, seed, out):
    """JAX's zoo loop, one jitted step at a time, saved to ``out``: JAX's
    init as the port's state dict, every step's pixel indices and sampler
    jitter (``split(PRNGKey(seed + s), levels)``), and JAX's per-step
    losses; then JAX's PSNR of eval view 0."""
    from samnerf_tpu.data.datamanager import DataManagerConfig
    from samnerf_tpu.data.datamanagers_extra import DepthDataManager, SemanticDataManager
    from samnerf_tpu.data.dataparser import DataparserConfig
    from samnerf_tpu.engine.eval_render import _chunked_coords
    from samnerf_tpu_torch.utils.synthetic import write_textured_scene

    scene = Path(out).parent / f"scene_{views}_{res}"
    if not (scene / "transforms_test.json").exists():
        write_textured_scene(scene, num_train=views, num_test=2, h=res, w=res, detail=2.0)
    method = jzoo.zoo_methods()[name]
    jm, jcfg = method.build()
    cls = {"depth-nerfacto": DepthDataManager, "semantic-nerfw": SemanticDataManager}[name]
    dm = cls(DataManagerConfig(dataparser=DataparserConfig(
        data=scene, train_val_json_split=True), train_num_rays_per_batch=rays), seed=seed)
    cameras = jax.tree.map(jnp.asarray, dm.cameras)
    b0 = {k: jnp.asarray(v) for k, v in dm.next_train(0).items()}
    bundle0 = jax_rays(cameras, b0["indices"][:, 0], b0["indices"][:, 1:].astype(jnp.float32))
    key = jax.random.PRNGKey(seed)
    params = jax.jit(lambda r, b: jm.init(r, b, rng=r, train=True))(key, bundle0)
    init = zoo_params_from_jax(name, jax.tree.map(np.asarray, params))
    opt = optax.adam(method.lr)
    opt_state = opt.init(params)
    step_fn = jax.jit(jzoo.make_zoo_train_step(method, jm, jcfg, opt))
    levels = jcfg.base.num_proposal_iterations + 1
    indices, jitter, metrics = [], [], []
    for s in range(1, steps + 1):
        host = dm.next_train(s)
        rng = jax.random.PRNGKey(seed + s)
        params, opt_state, m = step_fn(params, opt_state, cameras,
                                       {k: jnp.asarray(v) for k, v in host.items()}, rng)
        indices.append(host["indices"])
        jitter.append(np.stack([np.asarray(jax.random.uniform(k, (rays, 1)))
                                for k in jax.random.split(rng, levels)]))
        metrics.append({k: float(v) for k, v in m.items()})
        if s % 16 == 0:
            print(s, json.dumps(metrics[-1]), flush=True)
    ec = jax.tree.map(jnp.asarray, dm.eval_cameras)
    coords = jnp.asarray(_chunked_coords(ec.height, ec.width, 4096))
    render = jax.jit(lambda p, c: jm.apply(p, jax_rays(ec, jnp.zeros((c.shape[0],), jnp.int32),
                                                       c), train=False)["rgb"])
    rgb = np.concatenate([np.asarray(render(params, c)) for c in coords])
    rgb = rgb[:ec.height * ec.width].reshape(ec.height, ec.width, 3)
    gt = dm.eval_images[0].astype(np.float32) / 255.0
    eval_psnr = float(-10.0 * np.log10(np.mean((rgb - gt) ** 2)))
    print("jax eval view 0 PSNR", eval_psnr, flush=True)
    torch.save({"method": name, "views": views, "res": res, "rays": rays, "seed": seed,
                "init": init, "indices": torch.from_numpy(np.stack(indices)),
                "jitter": torch.from_numpy(np.stack(jitter)), "jax_metrics": metrics,
                "jax_eval_psnr": eval_psnr}, out)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="export a JAX zoo run for the port's replay")
    ap.add_argument("--method", default="depth-nerfacto",
                    choices=("depth-nerfacto", "semantic-nerfw"))
    ap.add_argument("--setting", default="64x128x4096x208", help="VIEWSxRESxRAYSxSTEPS")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    export_jax_run(a.method, *(int(x) for x in a.setting.split("x")), a.seed, a.out)
