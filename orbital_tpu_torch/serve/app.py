"""The live viewer's web layer: the JAX package's routes over
``serve.backend``, with its page (``app/templates``) and scripts
(``app/static``) read by path.

    GET  /                bootstrap page (recent trails + body snapshot)
    GET  /api/state       the current snapshot as JSON (the page polls it)
    GET  /health          liveness / readiness probe
    POST /api/checkpoint  write a device-state checkpoint (CHECKPOINT_FP)

The web framework is the repository's shim, ``app/_compat.py`` (real Flask
where it is installed, else a werkzeug + jinja2 layer). It imports neither
JAX nor ``orbital_tpu``; it is loaded by path when an app is built, so
importing this module loads no web layer. An engine thread ticks the
backend at ``SIM_FPS`` unless ``SIM_DISABLE_THREAD=true``.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import Mapping, Optional

import torch

from .backend import Backend, create_backend

__all__ = ["create_app", "EngineThread", "serve"]

_REPO = Path(__file__).resolve().parents[2]
APP_DIR = _REPO / "app"
_COMPAT_NAME = "orbital_tpu_torch.serve._web_compat"


def _web():
    """The web shim ``app/_compat.py``, loaded by path once."""
    mod = sys.modules.get(_COMPAT_NAME)
    if mod is None:
        spec = importlib.util.spec_from_file_location(_COMPAT_NAME, APP_DIR / "_compat.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[_COMPAT_NAME] = mod
        spec.loader.exec_module(mod)
    return mod


def _version() -> str:
    fp = _REPO / "config.json"
    return json.loads(fp.read_text())["version"] if fp.exists() else "dev"


def _flask(web):
    """A Flask (or shim) app whose templates and static files are the JAX
    viewer's."""
    templates, static = APP_DIR / "templates", APP_DIR / "static"
    if web.USING_REAL_FLASK:
        return web.Flask(__name__, template_folder=str(templates), static_folder=str(static))
    import jinja2

    app = web.Flask(__name__)
    app.root, app.template_dir, app.static_dir = APP_DIR, templates, static
    app.jinja_env.loader = jinja2.FileSystemLoader(str(templates))
    return app


def create_app(env: Optional[Mapping[str, str]] = None, device: torch.device | str = "cuda"):
    """The web app over ``create_backend(env, device)``, which is
    ``app.backend``."""
    backend = create_backend(env, device)
    web = _web()
    app = _flask(web)
    app.backend = backend
    version = _version()

    @app.route("/")
    def index():
        return web.render_template("index.html", initial_state=backend.history(),
                                   bodies=backend.snapshot, version=version,
                                   system=backend.cfg.scene)

    @app.route("/api/state")
    def api_state():
        """Current positions & properties for all bodies (world units are
        meters; includes mass/radius extrema for client-side scaling)."""
        return web.jsonify(backend.snapshot)

    @app.get("/health")
    def health():
        return web.jsonify(backend.health()), 200

    @app.post("/api/checkpoint")
    def checkpoint():
        path = backend.checkpoint(os.getenv("CHECKPOINT_FP", backend.cfg.checkpoint_fp))
        return web.jsonify(status="ok", path=path), 200

    return app


class EngineThread:
    """Ticks a backend at its ``SIM_FPS`` on a daemon thread until
    :meth:`stop`."""

    def __init__(self, backend: Backend):
        self.backend = backend
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self) -> None:
        period = 1.0 / self.backend.cfg.fps
        while not self._stop.is_set():
            t0 = time.monotonic()
            self.backend.tick()
            self._stop.wait(max(0.0, period - (time.monotonic() - t0)))

    def start(self) -> "EngineThread":
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout)


def serve(host: str = "127.0.0.1", port: int = 5000, env: Optional[Mapping[str, str]] = None,
          device: torch.device | str = "cuda") -> None:
    """Build the backend and the app, start the engine thread (unless
    ``SIM_DISABLE_THREAD=true``) and serve until interrupted."""
    app = create_app(env=env, device=device)
    thread = None if app.backend.cfg.disable_thread else EngineThread(app.backend).start()
    try:
        app.run(host=host, port=port)
    finally:
        if thread is not None:
            thread.stop()
