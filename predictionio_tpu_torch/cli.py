"""Command line of the port (the deploy command of ``predictionio_tpu.cli``).

    python -m predictionio_tpu_torch.cli deploy --engine-json engine.json \\
        --model model.npz --port 8000 [--device cpu] \\
        [--serving-quant int8] [--batching]

``--model`` is a file written by ``workflow/persistence.py::dumps_models``.
The server runs on the CUDA card unless ``--device cpu`` is given, and
serves until ``POST /stop``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .controller.params import load_variant
from .server.engineserver import ServerConfig, deploy
from .server.http import AppServer
from .templates.recommendation import recommendation_engine
from .workflow.persistence import loads_models


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="predictionio_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)
    d = sub.add_parser("deploy", help="serve a trained model over HTTP")
    d.add_argument("--engine-json", required=True,
                   help="engine variant (algorithms and their params)")
    d.add_argument("--model", required=True,
                   help="model file written by dumps_models")
    d.add_argument("--ip", default="0.0.0.0")
    d.add_argument("--port", type=int, default=8000)
    d.add_argument("--device", default=None,
                   help="serving device (default: the CUDA card)")
    d.add_argument("--serving-quant", default="off",
                   choices=("off", "bf16", "int8"))
    d.add_argument("--batching", action="store_true",
                   help="coalesce concurrent queries into batched launches")
    return p


def build_deploy(args: argparse.Namespace) -> AppServer:
    """The engine server the deploy command would serve, not yet serving."""
    engine = recommendation_engine()
    engine_params = engine.params_from_variant(load_variant(args.engine_json))
    with open(args.model, "rb") as f:
        models = loads_models(f.read())
    config = ServerConfig(batching=args.batching,
                          serving_quant=args.serving_quant,
                          device=args.device)
    return deploy(engine, engine_params, models, config, args.ip, args.port)


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if args.command == "deploy":
        srv = build_deploy(args)
        print(f"Engine server listening on {args.ip}:{srv.port} "
              f"({srv.app.name})", flush=True)
        try:
            srv.serve_forever()
        finally:
            srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
