"""Python client SDK for the HTTP API (the port's copy of
vectorsearch_tpu/client.py: the same requests and the same ClientError).

It takes compress/decompress from the port's store, whose zstd contexts
are per thread: clients in several threads never share one.

The reference is consumed both as a Go library and over HTTP with thin
typed fetch wrappers (ui/src/api/*.ts; README "Projects Used"). This is the
equivalent typed client for Python consumers: one class per deployment,
methods mirroring the engine surface, zstd request/response compression,
and streaming chat.

    from vectorsearch_tpu_torch.client import Client
    c = Client("http://localhost:7500")
    ids = c.upload("owner", "category", [{"name": "a", "document": {...}}])
    hits = c.search("owner", "category", "query text", count=5)
    for delta in c.chat("question?", document_ids=[hits[0]["document_id"]]):
        print(delta, end="")
"""
from __future__ import annotations

import json
from typing import Any, Iterator

import requests

from .store.db import compress, decompress


class ClientError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class Client:
    def __init__(
        self,
        base_url: str = "http://localhost:7500",
        use_zstd: bool = False,
        timeout: float = 120.0,
        session: requests.Session | None = None,
        verify: bool | str = True,
    ):
        self.base_url = base_url.rstrip("/")
        self.use_zstd = use_zstd
        self.timeout = timeout
        self.session = session or requests.Session()
        self.verify = verify

    def _post(self, path: str, payload: dict, stream: bool = False):
        body = json.dumps(payload).encode("utf-8")
        headers = {"Content-Type": "application/json"}
        if self.use_zstd:
            body = compress(body)
            headers["Content-Encoding"] = "zstd"
            headers["Accept-Encoding"] = "zstd"
        resp = self.session.post(
            self.base_url + path,
            data=body,
            headers=headers,
            timeout=self.timeout,
            stream=stream,
            verify=self.verify,
        )
        if resp.status_code != 200:
            try:
                msg = resp.json().get("error", resp.text)
            except Exception:
                msg = resp.text
            raise ClientError(resp.status_code, msg)
        return resp

    def _post_json(self, path: str, payload: dict) -> dict:
        resp = self._post(path, payload)
        raw = resp.content
        if resp.headers.get("Content-Encoding", "").lower() == "zstd":
            raw = decompress(raw)
        return json.loads(raw)

    # ---- engine surface ----

    def upload(
        self, owner: str, category: str, documents: list[dict]
    ) -> list[int]:
        """documents: [{"name"?, "external_id"?, "document": any-json}]"""
        out = self._post_json(
            "/api/upload",
            {"owner": owner, "category": category, "documents": documents},
        )
        return out["document_ids"]

    def search(
        self,
        owner: str,
        category: str,
        text: str,
        count: int = 10,
        offset: int = 0,
        centroids: int = 0,
    ) -> list[dict]:
        out = self._post_json(
            "/api/search",
            {
                "owner": owner,
                "category": category,
                "text": text,
                "count": count,
                "offset": offset,
                "centroids": centroids,
            },
        )
        return out["documents"]

    def chat(
        self,
        text: str,
        prefix: str = "",
        history: list[str] | None = None,
        document_ids: list[int] | None = None,
        documents: list[Any] | None = None,
    ) -> Iterator[str]:
        """Streams reply text deltas."""
        resp = self._post(
            "/api/chat",
            {
                "text": text,
                "prefix": prefix,
                "history": history or [],
                "document_ids": document_ids or [],
                "documents": documents or [],
            },
            stream=True,
        )
        for chunk in resp.iter_content(chunk_size=None, decode_unicode=False):
            if chunk:
                yield chunk.decode("utf-8", errors="replace")

    def category_names(self, owner: str) -> list[str]:
        return self._post_json("/api/categories", {"owner": owner})[
            "category_names"
        ]

    def delete_owner(self, owner: str) -> None:
        self._post_json("/api/delete/owner", {"owner": owner})

    def delete_category(self, owner: str, category: str) -> None:
        self._post_json(
            "/api/delete/category", {"owner": owner, "category": category}
        )

    def delete_document(self, owner: str, category: str, document_id: int) -> None:
        self._post_json(
            "/api/delete/document",
            {"owner": owner, "category": category, "document_id": document_id},
        )

    def stats(self) -> dict:
        resp = self.session.get(
            self.base_url + "/api/stats", timeout=self.timeout, verify=self.verify
        )
        if resp.status_code != 200:
            raise ClientError(resp.status_code, resp.text)
        return resp.json()
