"""The JAX package's cached-regime fine-tune of ``tools/finetune_bundle.py``,
one jitted step at a time.

The tool's recipe (harris_lg5, lr 5e-5, seed 7, batch 8, the 600-step
difficulty ramp) with the keys and the step body of its scanned chunk of 10
steps, run as one jitted batch and one jitted step per step: XLA:CPU
compiles and runs those in minutes, where the scanned chunk is far slower.
For a short fine-tune on the CPU, flown afterwards by
``tools/finetune_ramp_check.py --fly``:

    JAX_PLATFORMS=cpu python tools/finetune_ramp_jax.py --steps 10 \\
        --out jax_ramp10.npz
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CHUNK = 10  # tools/finetune_bundle.py's chunk: one key split a chunk


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--curriculum", type=int, default=600)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import optax

    from gisnav_tpu.pipeline.runners import load_bundled
    from gisnav_tpu.train.device_data import device_batch_asymmetric
    from gisnav_tpu.train.steps import (
        CachedRegimeConfig,
        TrainState,
        make_cached_regime_train_step,
    )
    from gisnav_tpu.weights import save_npz

    params, pcfg = load_bundled("harris_lg5")
    cfg = CachedRegimeConfig(lightglue_depth=pcfg.lightglue_depth,
                             detector_mode=pcfg.detector_mode,
                             learning_rate=args.lr,
                             curriculum_steps=args.curriculum)
    tx = optax.adamw(cfg.learning_rate, weight_decay=cfg.weight_decay)
    state = TrainState(params=params, opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))

    @jax.jit
    def batch(step, k):  # the body of make_cached_regime_chunk
        d = (jnp.clip(step.astype(jnp.float32) / cfg.curriculum_steps,
                      0.0, 1.0) if cfg.curriculum_steps > 0
             else jnp.float32(1.0))
        return device_batch_asymmetric(
            k, args.batch, cfg.q_shape, cfg.r_shape,
            max_angle_deg=30.0 + 150.0 * d, max_blur_sigma=1.2 * d,
            shadow_strength=0.45 * d)

    step_fn = jax.jit(make_cached_regime_train_step(cfg, tx))
    key = jax.random.PRNGKey(args.seed)
    for _ in range(0, args.steps, CHUNK):
        key, sub = jax.random.split(key)
        for k in jax.random.split(sub, CHUNK):
            state, metrics = step_fn(state, *batch(state.step, k))
            print(f"step {int(state.step)} loss {float(metrics['loss']):.4f} "
                  f"gt_recall {float(metrics['gt_recall']):.3f}", flush=True)
    save_npz(args.out, jax.tree.map(jax.device_get, state.params))
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
