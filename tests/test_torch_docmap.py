"""The port's DocMap (vectorsearch_tpu_torch/engine/docmap.py): the 7
scenarios of tests/test_docmap.py, each run on the port's module and on the
JAX package's, with the same answers from both (the concurrent stress on
the port's alone, against a dict)."""
import threading

import numpy as np

import vectorsearch_tpu.engine.docmap as jax_docmap
import vectorsearch_tpu_torch.engine.docmap as port_docmap

MODULES = (port_docmap, jax_docmap)


def both(scenario):
    port, jax = (scenario(m) for m in MODULES)
    assert port == jax, (port, jax)
    return port


def test_basic_get_update_pop():
    def scenario(mod):
        m = mod.DocMap([1, 5, 9], [10, 50, 90])
        out = [len(m), m.get(5), m.get(2), m.get(2, -1), 5 in m, 2 in m]
        m.update([(2, 20), (11, 110)])
        out += [len(m), m.get(2), m.get(11)]
        out += [m.pop(5), m.get(5), len(m), m.pop(5), len(m)]  # pop is idempotent
        m.update([(1, 111)])  # an overwrite keeps the count
        out += [m.get(1), len(m)]
        return out

    assert both(scenario) == [3, 50, None, -1, True, False, 5, 20, 110,
                              50, None, 4, None, 4, 111, 4]


def test_unsorted_init_and_max_key():
    def scenario(mod):
        m = mod.DocMap([9, 1, 5], [90, 10, 50])
        out = [m.get(1), m.get(9), m.max_key()]
        m.pop(9)
        out.append(m.max_key())
        m.update([(30, 300)])
        return out + [m.max_key(), mod.DocMap().max_key()]

    assert both(scenario) == [10, 90, 9, 5, 30, 0]


def test_get_many_vectorized():
    def scenario(mod):
        m = mod.DocMap([1, 5, 9], [10, 50, 90])
        m.update([(2, 20)])
        m.pop(5)
        return m.get_many(np.array([1, 2, 5, 9, 100])).tolist()

    assert both(scenario) == [10, 20, -1, 90, -1]


def test_merge_threshold(monkeypatch):
    def scenario(mod):
        monkeypatch.setattr(mod, "MERGE_THRESHOLD", 8)
        m = mod.DocMap([1, 2, 3], [10, 20, 30])
        m.update([(k, k * 10) for k in range(100, 110)])  # crosses the threshold
        out = [m._overlay, len(m), m.get(105), m.get(2)]
        for k in range(100, 108):
            m.pop(k)  # the 8th pop crosses the threshold and merges
        keys, vals = m.arrays()
        return out + [m._deleted, len(m), m.get(105), m.get(109), keys.tolist(), vals.tolist()]

    assert both(scenario) == [{}, 13, 1050, 20, set(), 5, None, 1090,
                              [1, 2, 3, 108, 109], [10, 20, 30, 1080, 1090]]


def test_items_materialized():
    def scenario(mod):
        m = mod.DocMap([1, 2], [10, 20])
        m.update([(3, 30), (1, 11)])
        m.pop(2)
        return sorted(m.items())

    assert both(scenario) == [(1, 11), (3, 30)]


def test_from_dict():
    def scenario(mod):
        m = mod.DocMap.from_dict({7: 70, 3: 30})
        return m.get(7), m.get(3), len(m)

    assert both(scenario) == (70, 30, 2)


def test_concurrent_read_write():
    """Readers during 60,000 writes never see a torn value, and the map
    ends equal to a dict that took the same writes (the JAX copy of this
    stress runs in tests/test_docmap.py)."""
    m = port_docmap.DocMap(np.arange(10_000), np.arange(10_000) * 2)
    stop = threading.Event()
    errors = []

    def reader():
        try:
            while not stop.is_set():
                out = m.get_many(np.arange(0, 10_000, 97))
                assert ((out == -1) | (out % 2 == 0)).all()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        for k in range(20_000, 80_000):
            m.update([(k, k * 2)])
            if k % 3 == 0:
                m.pop(k - 15_000)
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors
    oracle = {k: k * 2 for k in range(10_000)}
    for k in range(20_000, 80_000):
        oracle[k] = k * 2
        if k % 3 == 0:
            oracle.pop(k - 15_000, None)
    assert len(m) == len(oracle) and sorted(m.items()) == sorted(oracle.items())
