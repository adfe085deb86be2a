"""The float64 referee of the train-step test (tests/test_torch_train.py).

``numpy_params`` fills a ParamDef tree from one numpy generator, so both
packages get the same weights whatever Python's hash salt (the reference's
``init_params`` keys each leaf by ``hash(name)``).  Run as a script, this
module runs the reference's jitted train step in float64:

    python tests/_torch_f64_referee.py OUT.npz SEED [SEED ...]

It enables ``jax_enable_x64`` and reads every ``jnp.float32`` of the
reference as ``float64`` (its norms, attention, AdamW moments and the
linear's ``accum_dtype`` name float32 outright), so the whole step runs in
float64; it must run in a process of its own.  For each seed it writes the
step-0 loss and gradients and the parameters and AdamW moments after three
chained steps, under ``s<seed>/...``.
"""
import sys

import numpy as np

#: the train-step test's model (tests/test_system.py's) and its schedule
SYS = dict(name="sys_tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
           head_dim=16, d_ff=128, vocab_size=256, remat=False, attn_chunk=32)
ADAMW = dict(lr=3e-3, warmup_steps=10, total_steps=120)
DATA = dict(vocab_size=256, seq_len=64, global_batch=8, seed=3)
STEPS = 3


def numpy_params(defs, seed: int) -> dict:
    """A reference ParamDef tree filled from one numpy generator, in
    sorted-key order, with the reference's init scales (f32)."""
    from repro.models.params import ParamDef, _fan_in
    rng = np.random.default_rng(seed)

    def fill(d):
        if isinstance(d, ParamDef):
            if d.init == "zeros":
                return np.zeros(d.shape, np.float32)
            if d.init == "ones":
                return np.ones(d.shape, np.float32)
            std = d.scale / np.sqrt(_fan_in(d.shape)) if d.init == "normal" else d.scale
            return (rng.normal(size=d.shape) * std).astype(np.float32)
        return {k: fill(d[k]) for k in sorted(d)}
    return fill(defs)


def jax_params(defs, seed: int) -> dict:
    """:func:`numpy_params` as ``jnp`` arrays, for the reference's
    functions: the same weights whatever Python's hash salt."""
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, numpy_params(defs, seed))


def flat(tree, prefix: str = "") -> dict:
    """``{path: numpy array}`` of a nested dict of arrays."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _main(out: str, seeds: list) -> None:
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    jnp.float32 = jnp.float64
    from repro.configs.base import ModelConfig
    from repro.data import pipeline as data
    from repro.launch.steps import make_train_step
    from repro.models import model_defs
    from repro.models.transformer import loss_fn
    from repro.optim import adamw
    cfg = ModelConfig(**SYS, dtype="float64", accum_dtype="float64")
    dc = data.DataConfig(**DATA)
    step = jax.jit(make_train_step(cfg, adamw.AdamWConfig(**ADAMW)))
    grad = jax.jit(jax.value_and_grad(lambda p, b: loss_fn(p, b, cfg)[0]))
    res = {}
    for seed in seeds:
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                         numpy_params(model_defs(cfg), seed))
        loss, g = grad(p, data.global_batch(dc, 0))
        res[f"s{seed}/loss"] = np.asarray(loss)
        res.update({f"s{seed}/g/{k}": v for k, v in flat(g).items()})
        st = adamw.init_opt_state(p)
        for s in range(STEPS):
            p, st, _ = step(p, st, data.global_batch(dc, s))
        for part, tree in (("p", p), ("m", st.m), ("v", st.v)):
            res.update({f"s{seed}/{part}/{k}": v for k, v in flat(tree).items()})
    np.savez(out, **res)


if __name__ == "__main__":
    _main(sys.argv[1], [int(s) for s in sys.argv[2:]])
