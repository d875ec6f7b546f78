"""REST server on stdlib http.server (no FastAPI in this environment).

Routes mirror the reference's FastAPI app (ox-vgg/WISE/api/routes.py,
api/__init__.py): project-scoped routers for search (GET text-only, POST
multimodal), media streaming with HTTP Range support (:148-241), thumbnails
(:243-260), storyboard JSON (:262-318), metadata (:320-331), info (:348-357),
featured (:1159-1208), and the report audit endpoint (:368-409). A static
mount serves a prebuilt frontend bundle when present.

Copy of ``wise_tpu/api/server.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import csv
import datetime
import json
import logging
import mimetypes
import os
import re
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..data_models import MediaType
from .engine import SearchEngine

logger = logging.getLogger(__name__)

RANGE_RE = re.compile(r"bytes=(\d*)-(\d*)")
CHUNK = 1 << 20


def parse_range(header: str, file_size: int) -> Optional[Tuple[int, int]]:
    """Returns (start, end) inclusive, or None if unparseable
    (reference: routes.py:64-94)."""
    m = RANGE_RE.match(header or "")
    if not m:
        return None
    start_s, end_s = m.groups()
    if start_s == "" and end_s == "":
        return None
    if start_s == "":
        # suffix range: last N bytes
        n = int(end_s)
        return max(0, file_size - n), file_size - 1
    start = int(start_s)
    end = int(end_s) if end_s else min(start + 8 * CHUNK - 1, file_size - 1)
    if start >= file_size:
        return None
    return start, min(end, file_size - 1)


_URL_QUERY_MAX_BYTES = 32 * 1024 * 1024


def _fetch_url_bytes(url: str, timeout: float = 10.0) -> bytes:
    """Download a pasted image/audio URL query (reference fetches with
    requests, routes.py POST /search URL-query handling).

    SSRF guard: the target host must resolve to a public address —
    loopback/private/link-local/metadata ranges are refused (the server
    would otherwise fetch internal endpoints on the client's behalf).
    WISE_ALLOW_INTERNAL_URLS=1 opts out for trusted deployments. Reads are
    capped at 32 MB so a streaming endpoint can't pin a handler thread."""
    import ipaddress
    import socket

    parsed = urllib.parse.urlparse(url)
    if parsed.scheme not in ("http", "https"):
        raise ValueError(f"unsupported URL scheme: {url!r}")
    if os.environ.get("WISE_ALLOW_INTERNAL_URLS", "0") != "1":
        host = parsed.hostname or ""
        try:
            infos = socket.getaddrinfo(host, None)
        except socket.gaierror:
            raise ValueError(f"cannot resolve host {host!r}")
        for info in infos:
            addr = ipaddress.ip_address(info[4][0])
            if (addr.is_private or addr.is_loopback or addr.is_link_local
                    or addr.is_reserved or addr.is_multicast
                    or addr.is_unspecified):
                raise ValueError(
                    f"refusing to fetch non-public address for {host!r}"
                )
    with urllib.request.urlopen(url, timeout=timeout) as r:
        data = r.read(_URL_QUERY_MAX_BYTES + 1)
    if len(data) > _URL_QUERY_MAX_BYTES:
        raise ValueError("URL query payload exceeds 32 MB")
    return data


def parse_multipart(body: bytes, content_type: str) -> Dict[str, List[bytes]]:
    """Minimal multipart/form-data parser: {field: [values...]}."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        return {}
    boundary = b"--" + m.group(1).encode()
    fields: Dict[str, List[bytes]] = {}
    for part in body.split(boundary):
        part = part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" not in part:
            continue
        header_blob, value = part.split(b"\r\n\r\n", 1)
        name_m = re.search(rb'name="([^"]+)"', header_blob)
        if not name_m:
            continue
        fields.setdefault(name_m.group(1).decode(), []).append(value)
    return fields


class WiseAPIHandler(BaseHTTPRequestHandler):
    engine: SearchEngine = None
    project_id: str = ""
    config = None
    frontend_dir: Optional[Path] = None
    report_file: Optional[Path] = None
    protocol_version = "HTTP/1.1"

    # -- helpers -----------------------------------------------------------
    def log_message(self, fmt, *args):
        logger.info("%s - %s", self.address_string(), fmt % args)

    def _send_json(self, obj, status: int = 200):
        data = (
            obj if isinstance(obj, (bytes, str)) else json.dumps(obj)
        )
        if isinstance(data, str):
            data = data.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if self._dev_mode():
            self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(data)

    def _dev_mode(self) -> bool:
        """CORS is a development-mode affordance (Vite dev server on its
        own origin), exactly like the reference's CORSMiddleware gated on
        mode == 'development' (api/__init__.py:41-52); the production SPA
        is same-origin and needs none."""
        return (self.config is not None
                and self.config.serve.mode == "development")

    def _send_error_json(self, status: int, message: str):
        self._send_json({"message": message}, status)

    def _send_bytes(self, data: bytes, content_type: str, status: int = 200):
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _route(self) -> Tuple[str, Dict[str, List[str]]]:
        parsed = urllib.parse.urlparse(self.path)
        qs = urllib.parse.parse_qs(parsed.query)
        path = parsed.path
        prefix = f"/{self.project_id}/"
        if path.startswith(prefix):
            path = path[len(prefix):]
        elif path == f"/{self.project_id}":
            path = ""
        else:
            path = path.lstrip("/")
        return path, qs

    # -- GET ---------------------------------------------------------------
    def do_GET(self):
        try:
            path, qs = self._route()
            if path == "info":
                return self._send_json(self.engine.info().model_dump())
            if path == "featured":
                start = int(qs.get("start", ["0"])[0])
                end = int(qs.get("end", ["44"])[0])
                thumbs = self._thumbs_param(qs, default=10)
                seed = int(qs.get("random_seed", ["123"])[0])
                resp = self.engine.featured(start, end, thumbs,
                                            random_seed=seed)
                return self._send_json(resp.model_dump())
            if path == "search":
                return self._get_search(qs)
            if path == "thumbnail":
                # the reference frontend's route (routes.py:243-260):
                # /thumbnail?media_id=&timestamp=
                media_id = int(qs.get("media_id", ["0"])[0])
                ts = float(qs.get("timestamp", ["0"])[0])
                blob = self.engine.thumbnail(media_id, ts)
                if blob is None:
                    return self._send_error_json(404, "Thumbnail not found!")
                return self._send_bytes(blob, "image/jpeg")
            m = re.match(r"media/(\d+)$", path)
            if m:
                return self._get_media(int(m.group(1)))
            m = re.match(r"thumbs/raw/(\d+)$", path)
            if m:
                return self._get_raw_thumb(int(m.group(1)))
            m = re.match(r"thumbs/(\d+)$", path)
            if m:
                blob = self.engine.thumbnail(int(m.group(1)), None)
                if blob is None:
                    return self._send_error_json(404, "thumbnail not found")
                return self._send_bytes(blob, "image/jpeg")
            m = re.match(r"storyboard/(\d+)/sprite\.jpg$", path)
            if m:
                sprite = self.engine.storyboard_sprite(int(m.group(1)))
                if sprite is None:
                    return self._send_error_json(404, "no storyboard")
                return self._send_bytes(sprite, "image/jpeg")
            m = re.match(r"storyboard/(\d+)$", path)
            if m:
                base = f"/{self.project_id}/"
                return self._send_json(
                    self.engine.storyboard(int(m.group(1)), base)
                )
            m = re.match(r"metadata/(\d+)$", path)
            if m:
                return self._get_metadata(int(m.group(1)))
            return self._get_static(path)
        except BrokenPipeError:
            pass
        except Exception as e:
            logger.exception("GET failed")
            try:
                self._send_error_json(500, str(e))
            except Exception:
                pass

    @staticmethod
    def _thumbs_param(qs, default: int = 0) -> int:
        """thumbnails_to_send, also accepting the built frontend's short
        'thumbs' name (frontend/dist/config.js FETCH_THUMBS)."""
        val = qs.get("thumbnails_to_send", qs.get("thumbs", [str(default)]))
        return int(val[0])

    def _get_search(self, qs):
        queries = qs.get("q", [])
        if not queries:
            return self._send_error_json(400, "Missing search query")
        start = int(qs.get("start", ["0"])[0])
        end = min(int(qs.get("end", ["20"])[0]), max(self.engine.num_vectors, 1))
        thumbs = self._thumbs_param(qs)
        if start > end:
            return self._send_error_json(
                400, "'start' cannot be greater than 'end'"
            )
        blocklist = set(self.config.search.query_blocklist)
        for q in queries:
            if q.strip() in blocklist:
                msg = (
                    "One of the search terms you entered has been blocked"
                    if len(queries) > 1
                    else "The search term you entered has been blocked"
                )
                return self._send_error_json(403, msg)
        media_type = "video" if "video" in self.engine.indices else (
            next(iter(self.engine.indices), None)
        )
        if media_type is None:
            return self._send_error_json(400, "no search index loaded")
        items = [dict(sign="positive", modality="text", val=q) for q in queries]
        resp = self.engine.similarity_search(
            media_type,
            items,
            MediaType.VIDEO if media_type == "video" else None,
            start,
            end,
            thumbs,
        )
        return self._send_json(resp.model_dump())

    def _get_media(self, media_id: int):
        path = self.engine.media_path(media_id)
        if path is None or not Path(path).exists():
            return self._send_error_json(404, "media not found")
        path = Path(path)
        size = path.stat().st_size
        ctype = mimetypes.guess_type(str(path))[0] or "application/octet-stream"
        rng = parse_range(self.headers.get("Range"), size)
        with open(path, "rb") as f:
            if rng is None:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(size))
                self.send_header("Accept-Ranges", "bytes")
                self.end_headers()
                while True:
                    chunk = f.read(CHUNK)
                    if not chunk:
                        break
                    self.wfile.write(chunk)
            else:
                start, end = rng
                length = end - start + 1
                self.send_response(206)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(length))
                self.send_header(
                    "Content-Range", f"bytes {start}-{end}/{size}"
                )
                self.send_header("Accept-Ranges", "bytes")
                self.end_headers()
                f.seek(start)
                remaining = length
                while remaining > 0:
                    chunk = f.read(min(CHUNK, remaining))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                    self.wfile.write(chunk)

    def _get_raw_thumb(self, thumb_id: int):
        if self.engine.thumbs_conn is None:
            return self._send_error_json(404, "no thumbnails")
        row = self.engine.thumbs_conn.execute(
            "SELECT content FROM thumbnails WHERE id = ?", (thumb_id,)
        ).fetchone()
        if row is None:
            return self._send_error_json(404, "thumbnail not found")
        return self._send_bytes(row["content"], "image/jpeg")

    def _get_metadata(self, media_id: int):
        row = self.engine.conn.execute(
            "SELECT * FROM media WHERE id = ?", (media_id,)
        ).fetchone()
        if row is None:
            return self._send_error_json(404, "media not found")
        return self._send_json(
            {
                "id": str(row["id"]),
                "filename": row["path"],
                "width": row["width"],
                "height": row["height"],
                "media_type": row["media_type"].lower(),
                "format": row["format"],
                "duration": row["duration"] or 0.0,
            }
        )

    def _get_static(self, path: str):
        if self.frontend_dir is None:
            return self._send_error_json(404, f"unknown path {path!r}")
        target = (self.frontend_dir / (path or "index.html")).resolve()
        if not str(target).startswith(str(self.frontend_dir.resolve())):
            return self._send_error_json(403, "forbidden")
        if target.is_dir():
            target = target / "index.html"
        if not target.exists():
            target = self.frontend_dir / "index.html"
            if not target.exists():
                return self._send_error_json(404, "not found")
        ctype = mimetypes.guess_type(str(target))[0] or "application/octet-stream"
        data = target.read_bytes()
        if target.name == "index.html":
            # the reference patches <base href> into frontend/dist/index.html
            # at serve time so the SPA's relative API calls resolve under
            # /{project}/ (api/__init__.py:84-92) — do it on the fly here
            data = re.sub(
                rb'<base href="[^"]*"\s*/?>',
                f'<base href="/{self.project_id}/" />'.encode(),
                data, count=1,
            )
        self._send_bytes(data, ctype)

    # -- POST --------------------------------------------------------------
    def do_POST(self):
        try:
            path, qs = self._route()
            length = int(self.headers.get("Content-Length", "0") or 0)
            body = self.rfile.read(length) if length else b""
            if path == "search":
                return self._post_search(qs, body)
            if path == "report":
                return self._post_report(qs, body)
            return self._send_error_json(404, f"unknown path {path!r}")
        except BrokenPipeError:
            pass
        except Exception as e:
            logger.exception("POST failed")
            try:
                self._send_error_json(500, str(e))
            except Exception:
                pass

    def _post_search(self, qs, body: bytes):
        search_in_s = qs.get("search_in", ["video"])[0]
        try:
            search_in = MediaType(search_in_s)
        except ValueError:
            return self._send_error_json(400, f"invalid search_in {search_in_s}")
        media_type = "audio" if search_in == MediaType.AV else search_in.value
        if media_type not in self.engine.indices:
            return self._send_error_json(
                400, f"No search index exists for this modality: {search_in_s}"
            )
        start = int(qs.get("start", ["0"])[0])
        end = int(qs.get("end", ["20"])[0])
        thumbs = self._thumbs_param(qs)

        form: Dict[str, List[bytes]] = {}
        ctype = self.headers.get("Content-Type", "")
        if "multipart/form-data" in ctype:
            form = parse_multipart(body, ctype)
        elif body and "application/json" in ctype:
            j = json.loads(body)
            form = {
                k: [
                    v.encode() if isinstance(v, str) else v
                    for v in (val if isinstance(val, list) else [val])
                ]
                for k, val in j.items()
            }

        def get_texts(key):
            vals = qs.get(key, []) + [v.decode() for v in form.get(key, [])]
            return [v for v in vals if v]

        text_q = get_texts("text_queries")
        neg_text_q = get_texts("negative_text_queries")
        blocklist = set(self.config.search.query_blocklist)
        for tq in text_q + neg_text_q:
            if tq.strip() in blocklist:
                msg = (
                    "One of the search terms you entered has been blocked"
                    if len(text_q) > 1
                    else "The search term you entered has been blocked"
                )
                return self._send_error_json(403, msg)

        def fetch_urls(key):
            """URL-paste queries (reference routes.py Form fields
            image_url_queries/audio_url_queries): download and treat as
            uploaded bytes. Failures -> 400 like the reference."""
            out = []
            for u in get_texts(key):
                out.append(_fetch_url_bytes(u))
            return out

        items: List[Dict] = []
        items += [dict(sign="positive", modality="text", val=t) for t in text_q]
        items += [
            dict(sign="positive", modality="image", val=b)
            for b in form.get("image_file_queries", [])
        ]
        items += [
            dict(sign="positive", modality="audio", val=b)
            for b in form.get("audio_file_queries", [])
        ]
        try:
            items += [
                dict(sign="positive", modality="image", val=b)
                for b in fetch_urls("image_url_queries")
            ]
            items += [
                dict(sign="positive", modality="audio", val=b)
                for b in fetch_urls("audio_url_queries")
            ]
            items += [
                dict(sign="negative", modality="image", val=b)
                for b in fetch_urls("negative_image_url_queries")
            ]
            items += [
                dict(sign="negative", modality="audio", val=b)
                for b in fetch_urls("negative_audio_url_queries")
            ]
        except Exception as e:
            return self._send_error_json(400, f"failed to fetch URL: {e}")
        for vid in qs.get("internal_image_queries", []):
            feats = self.engine.internal_image_features(media_type, [int(vid)])
            items.append(dict(sign="positive", modality="image", val=feats[0]))
        items += [
            dict(sign="negative", modality="text", val=t) for t in neg_text_q
        ]
        items += [
            dict(sign="negative", modality="image", val=b)
            for b in form.get("negative_image_file_queries", [])
        ]
        items += [
            dict(sign="negative", modality="audio", val=b)
            for b in form.get("negative_audio_file_queries", [])
        ]
        for vid in qs.get("negative_internal_image_queries", []):
            feats = self.engine.internal_image_features(media_type, [int(vid)])
            items.append(dict(sign="negative", modality="image", val=feats[0]))

        if not items:
            return self._send_error_json(400, "Missing search query")
        if len(items) > 5:
            return self._send_error_json(
                400, "A maximum of 5 query items is supported"
            )
        resp = self.engine.similarity_search(
            media_type, items, search_in, start, end, thumbs
        )
        return self._send_json(resp.model_dump())

    def _post_report(self, qs, body: bytes):
        """Append a reported-result row to the audit CSV
        (reference: routes.py:368-409)."""
        try:
            payload = json.loads(body) if body else {}
        except json.JSONDecodeError:
            payload = {}
        row = {
            "timestamp": datetime.datetime.now().isoformat(),
            "sourceURI": payload.get("sourceURI", ""),
            "reasons": ";".join(payload.get("reasons", [])),
        }
        if self.report_file is not None:
            new = not self.report_file.exists()
            with open(self.report_file, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(row.keys()))
                if new:
                    w.writeheader()
                w.writerow(row)
        return self._send_json({"status": "ok"})

    def do_OPTIONS(self):
        self.send_response(204)
        if self._dev_mode():
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods",
                             "GET, POST, OPTIONS")
            self.send_header("Access-Control-Allow-Headers", "*")
        self.send_header("Content-Length", "0")
        self.end_headers()


def create_server(
    project_dir,
    hostname: str = "0.0.0.0",
    port: int = 9670,
    config=None,
    frontend_dir=None,
    index_type: str = "IndexFlatIP",
) -> ThreadingHTTPServer:
    engine = SearchEngine(project_dir, config=config, index_type=index_type)
    handler = type(
        "BoundHandler",
        (WiseAPIHandler,),
        {
            "engine": engine,
            "project_id": engine.project_id,
            "config": engine.config,
            "frontend_dir": Path(frontend_dir) if frontend_dir else None,
            "report_file": Path(project_dir) / "reported.csv",
        },
    )
    return ThreadingHTTPServer((hostname, port), handler)


def serve(project_dir, hostname="0.0.0.0", port=9670, **kw):
    server = create_server(project_dir, hostname, port, **kw)
    logger.info(f"serving on http://{hostname}:{port}/")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
