"""The port's page allocator (``repro_torch.serving.kvcache``) vs the JAX
package's, driven side by side in this process.

Chain keys must be byte-identical.  Under one seeded random sequence of the
engine's calls (admit, register_prefill, cow, truncate, extend, retire,
swap_out, swap_in; the walk of ``tests/test_paged_kvcache.py``) both pools
must take the same decisions after every operation: page ids, refcounts,
free list, prefix table and its LRU order, ``reserved_extra`` and
``PoolStats``; and the page movers must leave the same bytes in the pool.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.serving import kvcache as JK  # noqa: E402
from repro_torch.serving import kvcache as TK  # noqa: E402


@pytest.mark.parametrize("page", [1, 2, 4, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_keys_byte_identical(seed, page):
    rng = np.random.default_rng(seed * 31 + page)
    for n in (1, page, 3 * page + 1, int(rng.integers(1, 60))):
        toks = [int(t) for t in rng.integers(0, 200000, n)]
        want = JK.chain_keys(toks, page)
        assert TK.chain_keys(toks, page) == want
        assert TK.chain_keys(np.asarray(toks, np.int32), page) == want


def _planes(n_pages, page, seed):
    """Random contents for a two-plane stub pool: f32 K and int8 V."""
    rng = np.random.default_rng(seed)
    return {"k": rng.standard_normal((2, n_pages, page, 1, 2)
                                     ).astype(np.float32),
            "v": rng.integers(-128, 128, (2, n_pages, page, 1, 2)
                              ).astype(np.int8)}


class _JaxStub:
    def __init__(self, planes):
        self.planes = planes

    def init_paged_cache(self, n_pages, page_size, dtype):
        return {k: jnp.asarray(v) for k, v in self.planes.items()}


class _TorchStub:
    def __init__(self, planes):
        self.planes = planes

    def init_paged_cache(self, n_pages, page_size, dtype, device, tp=1):
        return {k: torch.from_numpy(v.copy()).to(device)
                for k, v in self.planes.items()}


def _pools(n_pages, page, prefix, seed=0):
    planes = _planes(n_pages, page, seed)
    kw = dict(n_pages=n_pages, page_size=page, pages_per_slot=n_pages - 1,
              prefix_cache=prefix)
    return (JK.PagePool(_JaxStub(planes), kv_dtype=jnp.float32, **kw),
            TK.PagePool(_TorchStub(planes), kv_dtype=torch.float32,
                        device="cpu", **kw))


def _adm_state(adm):
    return None if adm is None else dataclasses.asdict(adm)


def _assert_same(jp, tp):
    assert tp.free == jp.free
    np.testing.assert_array_equal(tp.ref, np.asarray(jp.ref))
    assert list(tp.table.items()) == list(jp.table.items())
    assert tp.key_of == jp.key_of
    assert tp.reserved_extra == jp.reserved_extra
    assert dataclasses.asdict(tp.stats) == dataclasses.asdict(jp.stats)
    for name, arr in tp.cache.items():
        np.testing.assert_array_equal(arr.numpy(),
                                      np.asarray(jp.cache[name]), err_msg=name)


class _TwinWalk:
    """One random walk of engine-shaped calls applied to both pools."""

    def __init__(self, rng, *, page, n_pages, prefix_cache):
        self.rng, self.page = rng, page
        self.jp, self.tp = _pools(n_pages, page, prefix_cache,
                                  seed=int(rng.integers(1 << 30)))
        self.live = []          # [j_adm, t_adm, plen, stop, cur]
        self.swapped = []       # [reserve, plen, stop, cur]
        self.seen = []          # prompts admitted before: repeats hit

    def admit(self):
        stop = int(self.rng.integers(1, 2 * self.page + 1))
        if self.seen and self.rng.random() < 0.5:
            tokens = self.seen[int(self.rng.integers(len(self.seen)))]
        else:
            plen = int(self.rng.integers(1, 3 * self.page + 1))
            tokens = [int(t) for t in self.rng.integers(0, 3, plen)]
            self.seen.append(tokens)
        plen = len(tokens)
        ja = self.jp.admit(tokens, stop)
        ta = self.tp.admit(tokens, stop)
        assert _adm_state(ta) == _adm_state(ja)
        if ja is None:
            return
        for pool, adm in ((self.jp, ja), (self.tp, ta)):
            pool.register_prefill(adm)
        assert self.tp.cow(ta) == self.jp.cow(ja)
        self.live.append([ja, ta, plen, stop, plen])

    def truncate(self):
        if not self.live:
            return
        ent = self.live[self.rng.integers(len(self.live))]
        n = int(self.rng.integers(ent[2], ent[4] + 1))
        assert self.tp.truncate(ent[1], n) == self.jp.truncate(ent[0], n)
        ent[4] = n

    def extend(self):
        if not self.live:
            return
        ent = self.live[self.rng.integers(len(self.live))]
        _, _, plen, stop, cur = ent
        n = int(self.rng.integers(cur, plen + stop + self.page))
        self.jp.extend(ent[0], n)
        self.tp.extend(ent[1], n)
        ent[4] = min(max(n, cur), plen + stop - 1)

    def retire(self):
        if not self.live:
            return
        ja, ta, *_ = self.live.pop(int(self.rng.integers(len(self.live))))
        self.jp.retire(ja)
        self.tp.retire(ta)

    def swap_out(self):
        if not self.live:
            return
        ja, ta, plen, stop, cur = self.live.pop(
            int(self.rng.integers(len(self.live))))
        reserve = ja.reserve
        assert self.tp.swap_out(ta) == self.jp.swap_out(ja)
        self.swapped.append([reserve, plen, stop, cur])

    def swap_in(self):
        if not self.swapped:
            return
        i = int(self.rng.integers(len(self.swapped)))
        reserve, plen, stop, cur = self.swapped[i]
        ja, ta = self.jp.swap_in(reserve), self.tp.swap_in(reserve)
        assert _adm_state(ta) == _adm_state(ja)
        if ja is None:
            return
        self.swapped.pop(i)
        self.live.append([ja, ta, plen, stop, cur])

    def check(self):
        _assert_same(self.jp, self.tp)
        for ja, ta, *_ in self.live:
            assert _adm_state(ta) == _adm_state(ja)
        assert self.tp.free_claimable() == self.jp.free_claimable()
        assert self.tp.pressure() == self.jp.pressure()
        assert self.tp.pages_in_use() == self.jp.pages_in_use()

    def run(self, n_ops=40):
        ops = [self.admit, self.admit, self.truncate, self.extend,
               self.retire, self.swap_out, self.swap_in]
        self.check()
        for _ in range(n_ops):
            ops[self.rng.integers(len(ops))]()
            self.check()
        while self.live or self.swapped:
            if self.live:
                self.retire()
            else:
                self.swap_in()
            self.check()


@pytest.mark.parametrize("prefix", [True, False])
@pytest.mark.parametrize("page,n_pages", [(2, 8), (4, 12), (2, 12), (4, 8)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_walk_same_decisions(seed, page, n_pages, prefix):
    _TwinWalk(np.random.default_rng(seed * 977 + page * 13 + n_pages),
              page=page, n_pages=n_pages, prefix_cache=prefix).run()


def test_page_movers_same_bytes():
    planes = _planes(6, 4, 3)
    jc = {k: jnp.asarray(v) for k, v in planes.items()}
    tc = {k: torch.from_numpy(v.copy()) for k, v in planes.items()}
    jc = JK._copy_page(jc, np.int32(2), np.int32(5))
    tc = TK._copy_page(tc, 2, 5)
    page = {"k": np.full((2, 4, 1, 2), 1.5, np.float32),
            "v": np.arange(16, dtype=np.int8).reshape(2, 4, 1, 2)}
    jc = JK._write_page(jc, np.int32(1), page)
    tc = TK._write_page(tc, 1, {k: torch.from_numpy(v)
                                for k, v in page.items()})
    for name in planes:
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
    np.testing.assert_array_equal(tc["v"][:, 5].numpy(), planes["v"][:, 2])


def test_shared_tier_adoption_same_decisions():
    """Two pools behind one fleet tier: the second adopts the first's full
    prompt pages, in both packages alike, with the same page bytes."""
    tiers = (JK.SharedPrefixTier(), TK.SharedPrefixTier())
    prompt = [5, 6, 7, 8, 9, 10, 11, 12, 13, 14]
    twins = [_pools(10, 4, True, seed=s) for s in (7, 8)]
    for (jp, tp) in twins:
        jp.shared_tier, tp.shared_tier = tiers
    for jp, tp in twins:
        ja, ta = jp.admit(prompt, 3), tp.admit(prompt, 3)
        assert _adm_state(ta) == _adm_state(ja)
        jp.register_prefill(ja)
        tp.register_prefill(ta)
        _assert_same(jp, tp)
        jp.retire(ja)
        tp.retire(ta)
        _assert_same(jp, tp)
    assert tiers[1].stats() == tiers[0].stats()
    assert twins[1][1].stats.shared_hit_pages == 2
