"""CTR command line (counterpart of ``recsys_tpu/tools/train_ctr.py``).

Only the ``serve`` task is ported:

    python -m recsys_tpu_torch.tools.train_ctr serve --export_dir=./export \
        --device=cuda --port=8500

loads the servable (exported by either package) on ``--device`` (``cuda``
or ``cpu``; ``cuda`` without a card fails), answers one warm-up request,
and serves REST on 127.0.0.1 (``--port=0`` binds a free port and logs it).
The tasks ``train``, ``eval``, ``predict`` and ``export`` are not ported
yet.
"""

from __future__ import annotations

import gc
import logging
import sys

_TASKS = ("train", "eval", "predict", "export", "serve")
_FLAGS = ("export_dir", "port", "device")


def _parse(argv: list[str]) -> tuple[str, dict[str, str]]:
    task = argv[0] if argv and not argv[0].startswith("--") else "train"
    kv = {}
    for a in argv[1 if argv and argv[0] == task else 0:]:
        key, eq, value = a[2:].partition("=")
        if not a.startswith("--") or not eq or key not in _FLAGS:
            raise SystemExit(f"unsupported argument {a!r}; the port takes "
                             f"--{'=, --'.join(_FLAGS)}=")
        kv[key] = value
    return task, kv


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    task, kv = _parse(sys.argv[1:] if argv is None else argv)
    if task not in _TASKS:
        raise SystemExit(f"unknown task {task}")
    if task != "serve":
        raise SystemExit(f"task {task!r} is not ported yet; the PyTorch "
                         "port serves only (task 'serve')")
    import torch

    from recsys_tpu_torch.serve.export import Servable
    from recsys_tpu_torch.serve.server import make_rest_server

    # the dense layers' float32 matmuls in full float32, as on the CPU
    # (PyTorch's default, set explicitly: TF32 keeps ~3 decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = kv.get("device", "cuda")
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"--device={device}: want cuda or cpu")
    sv = Servable(kv.get("export_dir", "./export"), device=device)
    sv.warmup()
    # the long-lived objects (parameters, the kernel library) are final:
    # collect once and keep them out of later collections' scans
    gc.collect()
    gc.freeze()
    rest, batcher = make_rest_server(sv, int(kv.get("port", 8500)))
    logging.getLogger("recsys_tpu_torch").info(
        "serving %s on %s at REST:%d", sv.model_name, device,
        rest.server_address[1])
    try:
        rest.serve_forever()
    finally:
        rest.server_close()
        batcher.stop()


if __name__ == "__main__":
    main()
