"""Quickstart: run the port's engine as a library (no HTTP server).
Counterpart of examples/quickstart.py.

    python -m vectorsearch_tpu_torch.examples.quickstart                    # on the card
    VSTPU_DEVICE=cpu python -m vectorsearch_tpu_torch.examples.quickstart   # on the CPU

The engine runs on the CUDA card, or where VSTPU_DEVICE asks (`cpu`,
`cuda:N`); with neither it refuses to start. It uses the deterministic noop
embedder so it needs no external service; swap `AI.from_config(cfg)` with
a real config for Ollama/OpenAI embeddings. For the HTTP deployment see
`python -m vectorsearch_tpu_torch` and vectorsearch_tpu_torch.client.Client.
"""
from vectorsearch_tpu_torch.config import Config
from vectorsearch_tpu_torch.embed import AI
from vectorsearch_tpu_torch.engine import Engine
from vectorsearch_tpu_torch.store import Store


def main():
    store = Store(":memory:")
    ai = AI.from_config(Config(), use_noop=True, noop_seed=0)
    engine = Engine(store, ai, snapshot_dir=None)
    print("engine device:", engine.device)

    ids = engine.upload(
        "demo",
        "articles",
        [
            {"name": "intro", "document": {"title": "Hello", "body": "vector search on GPUs"}},
            {"name": "deep", "document": {"title": "IVF", "body": "clustered inverted file index"}},
        ],
    )
    print("uploaded document ids:", ids)

    hits = engine.search("demo", "articles", "vector search", count=2, centroids=-1)
    for h in hits:
        print(f"  #{h.document_id} {h.name!r} sim={h.similarity:.4f} -> {h.document}")

    print("categories:", engine.fetch_category_names("demo"))

    reply = "".join(engine.chat("what is this about?", document_ids=ids[:1]))
    print("chat (noop responds with noise):", reply[:60], "...")

    engine.refresh_centroids(target_cluster_size=1000)
    print("stats:", engine.stats())

    engine.close()
    store.close()


if __name__ == "__main__":
    main()
