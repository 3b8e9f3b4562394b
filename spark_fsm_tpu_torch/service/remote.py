"""Actor-protocol TCP entry — the reference's second (Akka-remote) API.

The reference exposes its actor system two ways: the Spray REST surface and
an Akka-remoting entry that speaks ``ServiceRequest``/``ServiceResponse``
messages directly (SURVEY.md sec 1 L6 "AkkaApi", sec 2 "Akka remote API").
The rebuild's analog is a persistent-connection TCP protocol with one JSON
envelope per line:

    -> {"service": "fsm", "task": "train", "data": {"algorithm": ...}}
    <- {"service": "fsm", "task": "train", "data": {...}, "status": "started"}

Tasks use the actor vocabulary directly (``train``, ``status``,
``get:patterns``, ``get:rules``, ``track:{topic}``, ``stream:{topic}``,
``register:{topic}``) — the same strings the Master routes on — so a remote
client is one socket away from everything the HTTP surface offers, without
HTTP framing.  Errors come back as ``status: failure`` envelopes on the
same line framing; the connection survives malformed requests.

Port: a copy of ``spark_fsm_tpu/service/remote.py`` with its imports pointed at ``spark_fsm_tpu_torch``.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import Optional

from spark_fsm_tpu_torch.service.actors import Master
from spark_fsm_tpu_torch.service.model import ServiceRequest, ServiceResponse
from spark_fsm_tpu_torch.utils.obs import log_event

MAX_LINE = 64 << 20  # 64 MiB — streamed micro-batches ride this protocol too


class _Handler(socketserver.StreamRequestHandler):
    server: "RemoteServer"

    def handle(self) -> None:
        while True:
            try:
                line = self.rfile.readline(MAX_LINE + 1)
            except OSError:
                return
            if not line:
                return  # client closed
            if len(line) > MAX_LINE and not line.endswith(b"\n"):
                # Oversized request: drain to the next newline so the
                # one-reply-per-line framing stays in sync, then refuse it.
                while True:
                    try:
                        rest = self.rfile.readline(MAX_LINE)
                    except OSError:
                        return
                    if not rest or rest.endswith(b"\n"):
                        break
                reply = ServiceResponse(
                    "fsm", "", {"error": "request line exceeds "
                                         f"{MAX_LINE} bytes"},
                    "failure").to_json()
            else:
                line = line.strip()
                if not line:
                    continue
                reply = self._reply(line)
            self.wfile.write(reply.encode("utf-8") + b"\n")
            self.wfile.flush()

    def _reply(self, line: bytes) -> str:
        try:
            req = ServiceRequest.from_json(line.decode("utf-8"))
        except (ValueError, UnicodeDecodeError, AttributeError,
                TypeError) as exc:  # non-object JSON lands here too
            return ServiceResponse(
                "fsm", "", {"error": f"malformed request: {exc}"},
                "failure").to_json()
        try:
            return self.server.master.handle(req).to_json()
        except Exception as exc:  # worker bug -> failure envelope,
            log_event("remote_request_failed", task=req.task, error=str(exc))
            return ServiceResponse(  # not a dropped connection
                req.service, req.task,
                {"uid": req.uid, "error": str(exc)}, "failure").to_json()


class RemoteServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, master: Master, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.master = master
        super().__init__((host, port), _Handler)

    @property
    def port(self) -> int:
        return self.server_address[1]


def serve_remote_background(master: Master, host: str = "127.0.0.1",
                            port: int = 0) -> RemoteServer:
    """Start the actor-protocol server on a daemon thread."""
    server = RemoteServer(master, host, port)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="fsm-remote").start()
    log_event("remote_api_up", host=host, port=server.port)
    return server


class RemoteClient:
    """Blocking client for the actor protocol (one request per call).

    The protocol is symmetric enough that this is all a remote peer needs;
    it doubles as the reference client for tests and examples.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 9999,
                 timeout: float = 30.0) -> None:
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._file = self._sock.makefile("rwb")

    def close(self) -> None:
        try:
            self._file.close()
            self._sock.close()
        except OSError:
            pass

    def request(self, task: str, data: Optional[dict] = None,
                service: str = "fsm") -> dict:
        req = ServiceRequest(service=service, task=task,
                             data={str(k): str(v)
                                   for k, v in (data or {}).items()})
        self._file.write(req.to_json().encode("utf-8") + b"\n")
        self._file.flush()
        line = self._file.readline()
        if not line:
            raise ConnectionError("remote API closed the connection")
        obj = json.loads(line.decode("utf-8"))
        if not isinstance(obj, dict):
            raise ValueError(f"malformed response: {obj!r}")
        return obj
