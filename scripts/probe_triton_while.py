"""Which loop forms compile inside a Pallas Triton kernel on the GPU?

    python scripts/probe_triton_while.py [--interpret]

The forest descent kernel (``ops/forest_pallas.py``) runs a fixed
``max_depth`` levels because a ``lax.while_loop`` that stops once every
point sits on a leaf crashed the GPU compile (segfault, JAX 0.9.0). This
script keeps that finding checkable as JAX changes: the kernel's descent
(four trees' node ids carried together, packed node records, gathered
features) over random complete trees, with three loop forms, each compiled
and run in its own process so that a crash is reported instead of ending
the probe:

- ``fori``: a fixed trip count (the form the descent kernel uses);
- ``while_bool``: a while loop whose carry holds a bool "all on leaves";
- ``while_int``: the same with an int32 flag.

Prints one JSON line per form: the child's exit code (a negative code is
the signal that killed it) and whether the leaves were exact. With
``--interpret`` the forms run through the Pallas interpreter on any
backend, which checks the probe itself.
"""

import argparse
import json
import os
import subprocess
import sys

FORMS = ("fori", "while_bool", "while_int")
TREES = 4
FEATURES = 16
DEPTH = 12  # levels of each complete tree
BLOCK = 32
POINTS = 4096


def forest(rng):
    """TREES complete binary trees in the descent kernel's packed-record
    layout (``models.forest.pack_node_records``): per node, the word
    ``feature | left << FEAT_BITS`` (a ``left`` of 0 marks a leaf) and the
    threshold's float32 bits; node i's children are 2i+1 and 2i+2.
    Returns (records [TREES, N, 2] int32, feature bits)."""
    import numpy as np

    n = 2 ** (DEPTH + 1) - 1
    bits = 4  # FEATURES == 16
    left = 2 * np.arange(n) + 1
    left[left >= n] = 0
    records = np.zeros((TREES, n, 2), np.int32)
    for t in range(TREES):
        feat = rng.integers(0, FEATURES, n)
        thr = rng.random(n).astype(np.float32)
        records[t, :, 0] = feat | (left << bits)
        records[t, :, 1] = thr.view(np.int32)
    return records, bits


def reference_leaves(x, records, bits):
    """[P, TREES] leaf ids by a NumPy descent."""
    import numpy as np

    out = []
    for rec in records:
        node = np.zeros(x.shape[0], np.int64)
        while True:
            meta = rec[node, 0]
            lc = meta >> bits
            if (lc == 0).all():
                break
            xv = x[np.arange(x.shape[0]), meta & ((1 << bits) - 1)]
            thr = rec[node, 1].view(np.float32)
            node = np.where(lc == 0, node, lc + (xv >= thr))
        out.append(node)
    return np.stack(out, axis=1).astype(np.int32)


def run_form(form, interpret):
    """Compile and run one loop form; returns whether its leaves are exact."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    rng = np.random.default_rng(0)
    records, bits = forest(rng)
    n_nodes = records.shape[1]
    x = rng.random((POINTS, FEATURES)).astype(np.float32)

    def kernel(x_ref, rec_ref, out_ref):
        p = pl.program_id(0) * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
        row = p * FEATURES

        def meta_of(t, node):
            return plgpu.load(rec_ref.at[(t * n_nodes + node) * 2])

        def level(nodes):
            new = []
            for t in range(TREES):
                meta = meta_of(t, nodes[t])
                thr = jax.lax.bitcast_convert_type(
                    plgpu.load(rec_ref.at[(t * n_nodes + nodes[t]) * 2 + 1]),
                    jnp.float32)
                lc = meta >> bits
                xv = plgpu.load(x_ref.at[row + (meta & ((1 << bits) - 1))])
                nxt = lc + (xv >= thr).astype(jnp.int32)
                new.append(jnp.where(lc == 0, nodes[t], nxt))
            return tuple(new)

        def on_leaves(nodes):  # a max lowers for Triton, an all does not
            top = jnp.max(meta_of(0, nodes[0]) >> bits)
            for t in range(1, TREES):
                top = jnp.maximum(top, jnp.max(meta_of(t, nodes[t]) >> bits))
            return top == 0

        nodes = tuple(jnp.zeros((BLOCK,), jnp.int32) for _ in range(TREES))
        if form == "fori":
            nodes = jax.lax.fori_loop(0, DEPTH, lambda _, n: level(n), nodes)
        else:
            flag = (lambda b: b) if form == "while_bool" else (
                lambda b: b.astype(jnp.int32))
            done = (lambda f: f) if form == "while_bool" else (
                lambda f: f != 0)

            def body(state):
                n = level(state[0])
                return n, flag(on_leaves(n))

            nodes, _ = jax.lax.while_loop(
                lambda s: ~done(s[1]), body, (nodes, flag(on_leaves(nodes))))
        for t in range(TREES):
            plgpu.store(out_ref.at[t, :], nodes[t])

    call = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((TREES, POINTS), jnp.int32),
        grid=(POINTS // BLOCK,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 2,
        out_specs=pl.BlockSpec((TREES, BLOCK), lambda i: (0, i)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1),
        interpret=interpret,
    )
    got = np.asarray(jax.jit(call)(
        jnp.asarray(x.reshape(-1)), jnp.asarray(records.reshape(-1)))).T
    return bool((got == reference_leaves(x, records, bits)).all())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--interpret", action="store_true")
    ap.add_argument("--form", choices=FORMS, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.form:  # the child: one form, result on the last line
        print(json.dumps({"exact": run_form(args.form, args.interpret)}))
        return
    ok = True
    for form in FORMS:
        cmd = [sys.executable, os.path.abspath(__file__), "--form", form]
        if args.interpret:
            cmd.append("--interpret")
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        lines = proc.stdout.strip().splitlines()
        exact = json.loads(lines[-1])["exact"] if proc.returncode == 0 else None
        print(json.dumps({"form": form, "returncode": proc.returncode,
                          "exact": exact}), flush=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-2000:])
        ok &= form != "fori" or exact is True
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
