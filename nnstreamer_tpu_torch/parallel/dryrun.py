"""Multi-device dryrun: one sharded training step and one sharded
serving round, runnable in-process or as ``python -m
nnstreamer_tpu_torch.parallel.dryrun <n>``.

Port of ``nnstreamer_tpu/parallel/dryrun.py``. :func:`run` takes one
sharded training step (forward, backward, optimizer; ring attention when
a seq axis exists, then the same loss through Ulysses when the heads
allow) on an ``n``-device mesh; :func:`run_infer` serves MobileNet-v2
from one query server whose mesh filter takes micro-batches of several
clients. On the cards the devices are the cards; on the host CPU, which
the caller chooses (``--cpu``, or :func:`.world.set_host_devices`
before the run), they are gloo ranks, and :func:`ensure_devices` sets
their count before the mesh world starts.
"""
from __future__ import annotations

import functools
import sys

_SUBPROCESS_HINT = (
    "run the dryrun in a fresh process instead: "
    "`python -m nnstreamer_tpu_torch.parallel.dryrun <n> [--cpu]`")


def ensure_devices(n_devices: int) -> None:
    """Make >= n_devices devices available, or raise: on the host CPU
    the device count is set before the mesh world starts; once it runs
    (or on the cards, whose count is fixed) a smaller pool raises,
    naming the fresh-process fallback."""
    from . import world
    have = world.pool_size()
    if have >= n_devices:
        return
    if world.started():
        raise RuntimeError(
            f"ensure_devices({n_devices}): the mesh world runs with {have} "
            f"{world.device_type()} device(s) and cannot grow now — "
            + _SUBPROCESS_HINT)
    if world.device_type() == "cpu":
        world.set_host_devices(n_devices)
        return
    raise RuntimeError(
        f"ensure_devices({n_devices}): this machine has {have} card(s); "
        "to run on the host CPU's gloo ranks pass --cpu "
        f"(`python -m nnstreamer_tpu_torch.parallel.dryrun {n_devices} "
        "--cpu`) or call parallel.mesh.set_host_devices(n) first")


def run(n_devices: int) -> float:
    """One sharded train step on an n-device mesh (dp x sp x tp)."""
    ensure_devices(n_devices)
    import torch

    from ..models import transformer as tfm
    from .mesh import best_mesh, factorization
    from .sharding import GPT_RULES, P
    from .train import create_train_state, make_train_step, shard_batch

    mesh = best_mesh(n_devices)
    dp, sp, tp = factorization(mesh)
    cfg = tfm.GPTConfig(vocab=256, d_model=64, n_heads=4, n_layers=2,
                        d_ff=128, mesh=mesh,
                        seq_axis="seq" if sp > 1 else None)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    optimizer = functools.partial(torch.optim.AdamW, lr=1e-3,
                                  weight_decay=1e-4)
    state = create_train_state(params, optimizer, mesh, GPT_RULES)

    seq = 8 * sp  # divisible by the seq axis for ring attention blocks
    batch = torch.zeros((2 * dp, seq + 1), dtype=torch.int32)
    batch = shard_batch(batch, mesh, P("data", None))

    step = make_train_step(functools.partial(tfm.loss_fn, cfg=cfg))
    state, loss = step(state, batch)
    assert torch.isfinite(loss), f"non-finite loss {loss}"
    schemes = "ring"
    if sp > 1 and (cfg.n_heads // tp) % sp == 0:
        # the same loss through the OTHER sequence-parallel scheme, so
        # both collective patterns run
        import dataclasses
        cfg_u = dataclasses.replace(cfg, seq_axis="seq",
                                    seq_scheme="ulysses")
        loss_u = tfm.loss_fn(state.params, batch, cfg_u)
        assert torch.isfinite(loss_u), f"non-finite ulysses loss {loss_u}"
        schemes = "ring+ulysses"
    print(f"dryrun_multichip: mesh dp={dp} sp={sp} tp={tp} "
          f"seq={schemes} loss={float(loss):.4f} train ok", flush=True)
    run_infer(n_devices)
    return float(loss)


def run_infer(n_devices: int, size: int = 96) -> None:
    """Sharded *inference* round on the same pool: several query clients
    stream distinct frames to ONE server whose serversrc micro-batches
    them (batch=4) into shared stacked invokes of a mesh-mode
    MobileNet-v2 (batch dim over ``data``, params placed by the rule
    table), and the serversink row-routes replies back. Asserts (a)
    micro-batching happened (fewer invokes than frames and a stacked
    signature), (b) every client got ITS OWN frames' answers, in order,
    matching a one-device reference."""
    ensure_devices(n_devices)
    import math
    import socket
    import threading
    import time

    import numpy as np
    import torch

    from .. import Buffer, parse_launch
    from ..filters import FilterProperties, find_filter
    from ..filters.base import Accelerator
    from . import world

    zoo = f"zoo://mobilenet_v2?size={size}"
    caps = ('"other/tensors,format=static,num_tensors=1,'
            f'types=(string)uint8,dimensions=(string)3:{size}:{size},'
            'framerate=(fraction)0/1"')
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dp = max(1, n_devices // 2)
    tp = 2 if n_devices > 1 else 1
    on_card = world.device_type() == "cuda"
    acc = "" if on_card else "accelerator=true:cpu "
    server = parse_launch(
        f"tensor_query_serversrc name=qs port={port} id=42 batch=4 "
        f"! tensor_filter name=f framework=torch-cuda model={zoo} {acc}"
        f'custom="mesh:{dp}x1x{tp}" prefetch-host=true '
        f"! tensor_query_serversink id=42")
    server.start()
    time.sleep(0.2)

    ref = find_filter("torch-cuda")()
    ref.open(FilterProperties(
        framework="torch-cuda", model_files=(zoo,),
        accelerators=() if on_card else (Accelerator.CPU,)))
    n_clients, frames_each = 3, 4
    rng = np.random.default_rng(7)
    xs = {(c, i): rng.integers(0, 255, (size, size, 3), np.uint8,
                               endpoint=True)
          for c in range(n_clients) for i in range(frames_each)}
    want = {k: ref.invoke([torch.from_numpy(v)])[0].cpu().numpy()
            for k, v in xs.items()}
    ref.close()

    results: dict = {}

    def client(c):
        # jittered starts: clients interleave mid-stream, so the order
        # check exercises the row router on mixed-client batches
        time.sleep(0.03 * c)
        cl = parse_launch(
            f"appsrc name=in caps={caps} "
            f"! tensor_query_client port={port} timeout=60 max-request=8 "
            "! appsink name=out")
        cl.start()
        for i in range(frames_each):
            cl["in"].push_buffer(Buffer.from_arrays([xs[(c, i)]]))
        deadline = time.monotonic() + 300
        while len(cl["out"].buffers) < frames_each \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        results[c] = [np.asarray(b.chunks[0].host()).copy()
                      for b in cl["out"].buffers]
        cl["in"].end_stream()
        cl.stop()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=320)
    n_invokes = server["f"]._invoke_count
    sigs = list(server["f"].fw._mesh_sigs)
    server.stop()
    total = n_clients * frames_each
    # a perfectly coalescing server needs ceil(total/4) stacked
    # invokes; +2 tolerates ragged head/tail batches
    bound = math.ceil(total / 4) + 2
    assert n_invokes <= bound, \
        f"micro-batching degraded: {n_invokes} invokes for {total} " \
        f"frames (bound {bound})"
    assert any(sig and sig[0][0] and sig[0][0][0] == 4 for sig in sigs), \
        f"no stacked (batch=4) signature ran: {sigs}"
    for c in range(n_clients):
        got = results.get(c, [])
        assert len(got) == frames_each, \
            f"client {c} got {len(got)}/{frames_each} replies"
        for i, arr in enumerate(got):
            np.testing.assert_allclose(
                arr, want[(c, i)], rtol=1e-4, atol=1e-4,
                err_msg=f"row-routing broke for client {c} frame {i}")
    print(f"dryrun_multichip: mesh dp={dp} tp={tp} query micro-batch=4 "
          f"clients={n_clients} invokes={n_invokes}/{total} "
          "row-routing infer ok", flush=True)


if __name__ == "__main__":
    # python -m nnstreamer_tpu_torch.parallel.dryrun [N] [--cpu]
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    n = int(args[0]) if args else 8
    if "--cpu" in sys.argv[1:]:
        from . import world as _w
        _w.set_host_devices(n)
    run(n)
