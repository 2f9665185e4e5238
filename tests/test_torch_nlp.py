"""Port parity: the NLP embedding stack (``deeplearning4j_torch/nlp``)
against the JAX package's ``deeplearning4j_tpu/nlp`` on the CPU — the cases
of ``tests/test_nlp.py`` (without ``TestDistributedEmbeddings``: sharded
tables wait for ROADMAP A11c), each also held to the JAX module on the
same numpy-seeded inputs.

Tolerances, stated once:

- host code (tokenizers, vocab, Huffman, ``BatchBuilder``, serde, the
  native C loops) is equal to JAX's: tokens, codes, points, arrays and
  tables bitwise, vector files byte for byte;
- the random draws are bitwise ``jax.random``'s (windows, negatives, the
  GloVe permutation);
- one update step is within ``STEP_ATOL`` of JAX's and of ``-lr ·
  autograd``; one epoch of each device algorithm, trained from the same
  tables and key as JAX's, within ``EPOCH_ATOL`` (float summation order:
  torch's einsum products and the learning-rate ramp against XLA's).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu.nlp as jnlp  # noqa: E402
from deeplearning4j_tpu.nlp import learning as jlearn  # noqa: E402
from deeplearning4j_tpu.nlp import serde as jserde  # noqa: E402
from deeplearning4j_tpu.nlp.bagofwords import (  # noqa: E402
    BagOfWordsVectorizer as JBow, TfidfVectorizer as JTfidf)
from deeplearning4j_tpu.nlp.tokenization import (  # noqa: E402
    LabelledDocument as JDoc)
import deeplearning4j_torch.nlp as tnlp  # noqa: E402
from deeplearning4j_torch import native as tnative  # noqa: E402
from deeplearning4j_torch.nlp import learning as tlearn  # noqa: E402
from deeplearning4j_torch.nlp import serde as tserde  # noqa: E402
from deeplearning4j_torch.nlp.bagofwords import (  # noqa: E402
    BagOfWordsVectorizer as TBow, TfidfVectorizer as TTfidf)
from deeplearning4j_torch.nlp.tokenization import (  # noqa: E402
    LabelledDocument as TDoc)
from deeplearning4j_torch.ops import random as prandom  # noqa: E402
from deeplearning4j_torch.utils.convert import (  # noqa: E402
    sequence_vectors_from_jax, sequence_vectors_state)
from tests.test_nlp import _synthetic_corpus  # noqa: E402

pytestmark = pytest.mark.torch_port

CPU = "cpu"
STEP_ATOL = 1e-6
EPOCH_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its batch loops run thousands
    of small ops, whose thread pools only contend with the other test
    workers sharing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))      # a copy: the updates are in place
    return t if dtype is None else t.to(dtype)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _docs(mod, n=60, seed=2):
    rs = np.random.RandomState(seed)
    day = ["day", "sun", "light", "bright", "warm"]
    night = ["night", "moon", "dark", "star", "cold"]
    docs = []
    for _ in range(n):
        topic, label = (day, "DAY") if rs.rand() < 0.5 else (night, "NIGHT")
        words = [topic[rs.randint(len(topic))]
                 for _ in range(rs.randint(6, 10))]
        docs.append(mod(" ".join(words), label))
    return docs


# ---------------------------------------------------------- host code
class TestTokenizationAndVocab:
    TEXTS = ["Hello, World! 123 foo-bar", "a (b) [c] d's e.f", "",
             "MiXeD   spaces\tand\nlines", "running quickly walked"]

    @pytest.mark.parametrize("pre", ["none", "common", "lowcase", "ending"])
    def test_tokens_equal_jax(self, pre):
        from deeplearning4j_tpu.nlp import tokenization as jt
        from deeplearning4j_torch.nlp import tokenization as tt

        mk = {"none": lambda m: None,
              "common": lambda m: m.CommonPreprocessor(),
              "lowcase": lambda m: m.LowCasePreProcessor(),
              "ending": lambda m: m.EndingPreProcessor()}[pre]
        for text in self.TEXTS:
            assert (tt.DefaultTokenizerFactory(mk(tt)).create(text).tokens()
                    == jt.DefaultTokenizerFactory(mk(jt)).create(text)
                    .tokens())
        ng_t = tt.NGramTokenizerFactory(tt.DefaultTokenizerFactory(), 1, 3)
        ng_j = jt.NGramTokenizerFactory(jt.DefaultTokenizerFactory(), 1, 3)
        assert ng_t.create("a b c d").tokens() == \
            ng_j.create("a b c d").tokens()

    def test_sentence_iterators_equal_jax(self, tmp_path):
        (tmp_path / "d").mkdir()
        (tmp_path / "d" / "x.txt").write_text("one two\n\nthree\n")
        (tmp_path / "d" / "y.txt").write_text("four\n")
        for a, b in ((tnlp.LineSentenceIterator(str(tmp_path / "d" /
                                                   "x.txt")),
                      jnlp.LineSentenceIterator(str(tmp_path / "d" /
                                                   "x.txt"))),
                     (tnlp.FileSentenceIterator(str(tmp_path / "d")),
                      jnlp.FileSentenceIterator(str(tmp_path / "d"))),
                     (tnlp.CollectionSentenceIterator(["a b", "c d"]),
                      jnlp.CollectionSentenceIterator(["a b", "c d"]))):
            assert list(a) == list(b) and list(a) == list(b)

    @pytest.mark.parametrize("corpus", ["ties", "synthetic", "single"])
    def test_vocab_and_huffman_equal_jax(self, corpus):
        """Counts, index order, codes and points equal JAX's, also where
        many words tie on their count."""
        sents = {"ties": ["a b c d e f g h i j k l", "a b c d m n o p"],
                 "synthetic": _synthetic_corpus(200),
                 "single": ["solo solo"]}[corpus]
        t = tnlp.VocabConstructor(min_word_frequency=1).build_vocab(sents)
        j = jnlp.VocabConstructor(min_word_frequency=1).build_vocab(sents)
        assert t.num_words() == j.num_words()
        assert t.total_word_count == j.total_word_count
        for i in range(t.num_words()):
            a, b = t.element_at_index(i), j.element_at_index(i)
            assert (a.word, a.count, a.index, a.codes, a.points) == \
                (b.word, b.count, b.index, b.codes, b.points)

    def test_vocab_min_frequency(self):
        vc = tnlp.VocabConstructor(min_word_frequency=2)
        cache = vc.build_vocab(["a a a b b c", "a b d"])
        assert cache.word_frequency("a") == 4
        assert not cache.contains_word("c")
        assert cache.word_at_index(0) == "a"

    @pytest.mark.parametrize("kw", [dict(negative=5, sampling=0.0),
                                    dict(negative=0, sampling=1e-3),
                                    dict(negative=3, sampling=1e-2)])
    def test_batch_builder_equal_jax(self, kw):
        sents = _synthetic_corpus(80)
        cache_t = tnlp.VocabConstructor().build_vocab(sents)
        cache_j = jnlp.VocabConstructor().build_vocab(sents)
        bt = tlearn.BatchBuilder(cache_t, window=3, seed=4, **kw)
        bj = jlearn.BatchBuilder(cache_j, window=3, seed=4, **kw)
        for name in ("points", "codes", "code_mask", "_neg_table"):
            a, b = getattr(bt, name), getattr(bj, name)
            assert (a is None and b is None) or np.array_equal(a, b)
        toks = [s.split() for s in sents]
        idx_t = [bt.sentence_to_indices(s) for s in toks]
        idx_j = [bj.sentence_to_indices(s) for s in toks]
        assert all(np.array_equal(a, b) for a, b in zip(idx_t, idx_j))
        for a, b in zip(bt.pairs_from_corpus(idx_t),
                        bj.pairs_from_corpus(idx_j)):
            assert np.array_equal(a, b)
        if kw["negative"]:
            assert np.array_equal(bt.sample_negatives(idx_t[0]),
                                  bj.sample_negatives(idx_j[0]))

    def test_cjk_bigrams_and_mixed_scripts(self):
        tf = tnlp.CjkTokenizerFactory()
        jf = jnlp.CjkTokenizerFactory()
        for text in ("深度学习", "学", "TPU深度 learning", "한국어", "ひらがな",
                     "人々の時々", "ｶﾀｶﾅ", "𠮷野家", "深度学习。音乐！"):
            assert tf.create(text).tokens() == jf.create(text).tokens()
        assert tf.create("深度学习").tokens() == ["深度", "度学", "学习"]

    def test_bag_of_words_and_tfidf_equal_jax(self):
        docs = ["the cat sat", "the dog ran", "the bird flew", "a cat a dog"]
        for T, J in ((TBow, JBow), (TTfidf, JTfidf)):
            t, j = T().fit(docs), J().fit(docs)
            for d in docs + ["the cat", "unknown words"]:
                assert np.array_equal(t.transform(d), j.transform(d))
        assert np.array_equal(TBow().fit_transform(docs),
                              JBow().fit_transform(docs))
        tv = TTfidf().fit(docs[:3])
        assert tv.transform("the cat")[tv.vocab.index_of("the")] == 0.0


# ---------------------------------------------------------- updates
def _step_inputs(seed=0):
    V, D, L, K, B = 9, 6, 3, 3, 5
    rs = np.random.RandomState(seed)
    return dict(
        syn0=rs.randn(V, D).astype(np.float32) * 0.1,
        syn1=rs.randn(V, D).astype(np.float32) * 0.1,
        syn1neg=rs.randn(V, D).astype(np.float32) * 0.1,
        centers=rs.randint(0, V, B).astype(np.int32),
        context=rs.randint(0, V, (B, 4)).astype(np.int32),
        context_mask=(rs.rand(B, 4) > 0.3).astype(np.float32),
        points=rs.randint(0, V - 1, (B, L)).astype(np.int32),
        codes=(rs.rand(B, L) > 0.5).astype(np.float32),
        code_mask=(rs.rand(B, L) > 0.2).astype(np.float32),
        neg_targets=rs.randint(0, V, (B, 1 + K)).astype(np.int32),
        neg_labels=np.eye(1 + K, dtype=np.float32)[np.zeros(B, int)])


class TestUpdates:
    def test_hs_update_matches_autograd(self):
        """The closed-form HS update equals -lr · dLoss/dparams of the
        binary cross-entropy along the huffman path."""
        a = _step_inputs()
        c, pts = _t(a["centers"][:1]).long(), _t(a["points"][:1]).long()
        codes = _t(a["codes"][:1])
        s0 = _t(a["syn0"]).requires_grad_()
        s1 = _t(a["syn1"]).requires_grad_()
        f = torch.sigmoid(torch.einsum("bd,bld->bl", s0[c], s1[pts]))
        t = 1.0 - codes
        loss = -(t * torch.log(f + 1e-12)
                 + (1 - t) * torch.log(1 - f + 1e-12)).sum()
        g0, g1 = torch.autograd.grad(loss, (s0, s1))
        lr = 0.1
        new0, new1, _ = tlearn.skipgram_step(
            _t(a["syn0"]), _t(a["syn1"]), _t(a["syn1neg"]), c, pts, codes,
            torch.ones(1, 3), torch.zeros(1, 1, dtype=torch.long),
            torch.zeros(1, 1), lr, 16.0, use_hs=True, use_ns=False)
        assert torch.allclose(new0, s0.detach() - lr * g0, atol=STEP_ATOL)
        assert torch.allclose(new1, s1.detach() - lr * g1, atol=STEP_ATOL)

    def test_ns_update_matches_autograd(self):
        a = _step_inputs(1)
        c = _t(a["centers"][:2]).long()
        negt, negl = _t(a["neg_targets"][:2]).long(), _t(a["neg_labels"][:2])
        s0 = _t(a["syn0"]).requires_grad_()
        sn = _t(a["syn1neg"]).requires_grad_()
        f = torch.sigmoid(torch.einsum("bd,bkd->bk", s0[c], sn[negt]))
        loss = -(negl * torch.log(f + 1e-12)
                 + (1 - negl) * torch.log(1 - f + 1e-12)).sum()
        g0, gn = torch.autograd.grad(loss, (s0, sn))
        lr = 0.05
        new0, _, newn = tlearn.skipgram_step(
            _t(a["syn0"]), _t(a["syn1"]), _t(a["syn1neg"]), c,
            torch.zeros(2, 1, dtype=torch.long), torch.zeros(2, 1),
            torch.zeros(2, 1), negt, negl, lr, 16.0, use_hs=False,
            use_ns=True)
        # centers 1 and 4 are distinct rows here (no duplicate cap at play)
        assert torch.allclose(new0, s0.detach() - lr * g0, atol=STEP_ATOL)
        assert torch.allclose(newn, sn.detach() - lr * gn, atol=STEP_ATOL)

    @pytest.mark.parametrize("algo", ["skipgram", "cbow"])
    @pytest.mark.parametrize("hs,ns", [(True, False), (False, True),
                                       (True, True)])
    @pytest.mark.parametrize("cap", [16.0, 1.0])
    def test_step_equals_jax(self, algo, hs, ns, cap):
        a = _step_inputs(2)
        common = (a["points"], a["codes"], a["code_mask"], a["neg_targets"],
                  a["neg_labels"])
        if algo == "skipgram":
            j = jlearn.skipgram_step(
                *(jnp.asarray(a[k]) for k in ("syn0", "syn1", "syn1neg",
                                              "centers")),
                *map(jnp.asarray, common), jnp.float32(0.05),
                jnp.float32(cap), use_hs=hs, use_ns=ns)
            t = tlearn.skipgram_step(
                *(_t(a[k]) for k in ("syn0", "syn1", "syn1neg")),
                _t(a["centers"]).long(), _t(a["points"]).long(),
                _t(a["codes"]), _t(a["code_mask"]),
                _t(a["neg_targets"]).long(), _t(a["neg_labels"]), 0.05, cap,
                use_hs=hs, use_ns=ns)
        else:
            j = jlearn.cbow_step(
                *(jnp.asarray(a[k]) for k in ("syn0", "syn1", "syn1neg",
                                              "context", "context_mask")),
                *map(jnp.asarray, common), jnp.float32(0.05),
                jnp.float32(cap), use_hs=hs, use_ns=ns)
            t = tlearn.cbow_step(
                *(_t(a[k]) for k in ("syn0", "syn1", "syn1neg")),
                _t(a["context"]).long(), _t(a["context_mask"]),
                _t(a["points"]).long(), _t(a["codes"]), _t(a["code_mask"]),
                _t(a["neg_targets"]).long(), _t(a["neg_labels"]), 0.05, cap,
                use_hs=hs, use_ns=ns)
        for x, y in zip(t, j):
            np.testing.assert_allclose(_np(x), np.asarray(y), rtol=0,
                                       atol=STEP_ATOL)

    def test_segment_row_add_matches_scatter_and_jax(self):
        rs = np.random.RandomState(0)
        R, D, M, cap = 40, 8, 512, 4.0
        table = rs.randn(R, D).astype(np.float32)
        idx = rs.randint(0, R, M).astype(np.int32)
        w = (rs.rand(M) > 0.2).astype(np.float32)
        upd = rs.randn(M, D).astype(np.float32) * w[:, None]
        s = tlearn._row_mean_scale(R, _t(idx).long(), _t(w), cap)
        ref = tlearn._scatter_add(_t(table).clone(), _t(idx).long(),
                                  _t(upd) * s[:, None])
        out = tlearn._segment_row_add(_t(idx).long(), _t(upd), _t(w), cap,
                                      _t(table))
        jout = jlearn._segment_row_add(jnp.asarray(idx), jnp.asarray(upd),
                                       jnp.asarray(w), jnp.float32(cap),
                                       jnp.asarray(table))
        np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)
        np.testing.assert_allclose(_np(out), np.asarray(jout), atol=1e-5)

    def test_negative_draws_are_the_per_batch_fold_in_draws(self):
        """All S batches' negatives drawn in chunks equal JAX's
        ``randint(fold_in(kn, i), (B, K), 0, T)`` batch by batch."""
        old = tlearn._DRAW_CHUNK
        tlearn._DRAW_CHUNK = 64       # several chunks of 2 batches
        try:
            kn = prandom.PRNGKey(11, device=CPU)
            got = list(tlearn._negative_draws(kn, 7, 8, 4, 1000))
        finally:
            tlearn._DRAW_CHUNK = old
        jk = jax.random.PRNGKey(11)
        for i, g in enumerate(got):
            want = jax.random.randint(jax.random.fold_in(jk, i), (8, 4), 0,
                                      1000, dtype=jnp.int32)
            assert np.array_equal(_np(g), np.asarray(want))


# ---------------------------------------------------------- epochs
V_E, D_E, W_E, K_E, L_E, B_E = 50, 16, 3, 4, 5, 64


def _epoch_tables(seed):
    rs = np.random.RandomState(seed)
    return dict(pts=rs.randint(0, V_E - 1, (V_E, L_E)).astype(np.int32),
                cds=(rs.rand(V_E, L_E) > 0.5).astype(np.float32),
                cmk=(rs.rand(V_E, L_E) > 0.3).astype(np.float32),
                neg=rs.randint(0, V_E, 256).astype(np.int32))


def _start():
    syn0 = np.linspace(-1, 1, V_E * D_E).reshape(V_E, D_E).astype(np.float32)
    return (syn0, np.full((V_E, D_E), 0.01, np.float32),
            np.full((V_E, D_E), 0.02, np.float32))


def _run_epoch(side, algo, toks, labs, key_seed, tabs, hs, ns, segment,
               label_cap):
    W = W_E
    if side == "jax":
        s = tuple(jnp.asarray(a) for a in _start())
        key = jax.random.PRNGKey(key_seed)
        tab = tuple(jnp.asarray(tabs[k]) for k in ("pts", "cds", "cmk",
                                                   "neg"))
        f32 = jnp.float32
        if algo == "skipgram":
            return jlearn.skipgram_corpus_epoch(
                *s, jnp.asarray(toks), key, f32(0.025), f32(0.01), f32(8.0),
                *tab, window=W, batch=B_E, neg_k=K_E, use_hs=hs, use_ns=ns,
                segment_updates=segment)
        common = (jnp.asarray(toks), jnp.asarray(labs), key, f32(0.025),
                  f32(0.01), f32(8.0), f32(label_cap), *tab)
        if algo == "dbow":
            return jlearn.dbow_corpus_epoch(
                *s, *common, batch=B_E, neg_k=K_E, use_hs=hs, use_ns=ns,
                segment_updates=segment)
        return jlearn.cbow_corpus_epoch(
            *s, *common, window=W, batch=B_E, neg_k=K_E, use_hs=hs,
            use_ns=ns, with_labels=(algo == "dm"), segment_updates=segment)
    s = tuple(_t(a) for a in _start())
    key = prandom.PRNGKey(key_seed, device=CPU)
    tab = (_t(tabs["pts"]).long(), _t(tabs["cds"]), _t(tabs["cmk"]),
           _t(tabs["neg"]).long())
    if algo == "skipgram":
        return tlearn.skipgram_corpus_epoch(
            *s, _t(toks).long(), key, 0.025, 0.01, 8.0, *tab, window=W,
            batch=B_E, neg_k=K_E, use_hs=hs, use_ns=ns,
            segment_updates=segment)
    common = (_t(toks).long(), _t(labs).long(), key, 0.025, 0.01, 8.0,
              label_cap, *tab)
    if algo == "dbow":
        return tlearn.dbow_corpus_epoch(*s, *common, batch=B_E, neg_k=K_E,
                                        use_hs=hs, use_ns=ns,
                                        segment_updates=segment)
    return tlearn.cbow_corpus_epoch(*s, *common, window=W, batch=B_E,
                                    neg_k=K_E, use_hs=hs, use_ns=ns,
                                    with_labels=(algo == "dm"),
                                    segment_updates=segment)


def _epoch_stream(algo, seed=4):
    rs = np.random.RandomState(seed)
    if algo == "skipgram":
        toks = rs.randint(0, V_E, 96).astype(np.int32)
        toks[::13] = -1
        n = 96
        while (n * 2 * W_E) % B_E:
            n *= 2
        return np.concatenate([toks, np.full(n - 96, -1, np.int32)]), None
    n = 128
    toks = rs.randint(0, V_E - 10, n).astype(np.int32)
    toks[::11] = -1
    doc = np.cumsum(toks < 0)
    labs = np.where(toks >= 0, V_E - 10 + (doc % 10), -1).astype(np.int32)
    return toks, labs


class TestEpochs:
    @pytest.mark.parametrize("algo", ["skipgram", "cbow", "dm", "dbow"])
    @pytest.mark.parametrize("hs,ns", [(True, True), (False, True),
                                       (True, False)])
    def test_epoch_equals_jax_from_the_same_state_and_key(self, algo, hs,
                                                          ns):
        """One device epoch from the same tables and key: within
        EPOCH_ATOL of JAX's (the window and negative draws are bitwise
        JAX's; the products sum in another order)."""
        toks, labs = _epoch_stream(algo)
        tabs = _epoch_tables(3)
        cap = np.inf if algo in ("dm", "dbow") else 8.0
        j = _run_epoch("jax", algo, toks, labs, 5, tabs, hs, ns, False, cap)
        t = _run_epoch("torch", algo, toks, labs, 5, tabs, hs, ns, False,
                       cap)
        for a, b in zip(t, j):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                       atol=EPOCH_ATOL)

    @pytest.mark.parametrize("algo", ["skipgram", "cbow", "dm", "dbow"])
    def test_segment_path_equals_scatter_path_and_jax(self, algo):
        """The sorted-segment path (label_cap plumbing included) against
        the scatter path and against JAX's segment path (2e-4, the JAX
        package's own bound between its two paths)."""
        toks, labs = _epoch_stream(algo)
        tabs = _epoch_tables(3)
        cap = np.inf if algo != "cbow" else 8.0
        seg = _run_epoch("torch", algo, toks, labs, 9, tabs, True, True,
                         True, cap)
        sca = _run_epoch("torch", algo, toks, labs, 9, tabs, True, True,
                         False, cap)
        jseg = _run_epoch("jax", algo, toks, labs, 9, tabs, True, True,
                          True, cap)
        for a, b, c in zip(seg, sca, jseg):
            np.testing.assert_allclose(_np(a), _np(b), atol=2e-4)
            np.testing.assert_allclose(_np(a), np.asarray(c),
                                       atol=EPOCH_ATOL)

    def test_window_draws_equal_jax(self):
        toks, _ = _epoch_stream("skipgram")
        t_ctx, t_val, t_kn = tlearn._shifted_pairs(
            _t(toks).long(), prandom.PRNGKey(5, device=CPU), W_E)
        kw, kn = jax.random.split(jax.random.PRNGKey(5))
        win = jax.random.randint(kw, (toks.size,), 1, W_E + 1,
                                 dtype=jnp.int32)
        d = np.array([d for d in range(-W_E, W_E + 1) if d])
        assert np.array_equal(_np(t_kn), np.asarray(kn))
        live = _np(t_val)
        assert np.array_equal(live & (np.abs(d)[None] <= np.asarray(win)[:,
                                                                    None]),
                              live)


# ---------------------------------------------------------- trainers
def _w2v_pair(**kw):
    t = tnlp.Word2Vec(device=CPU, **kw)
    j = jnlp.Word2Vec(**kw)
    return t, j


def _assert_tables(t, j, atol=EPOCH_ATOL, names=("syn0", "syn1",
                                                 "syn1neg")):
    for n in names:
        np.testing.assert_allclose(_np(getattr(t, n)),
                                   np.asarray(getattr(j, n)), rtol=0,
                                   atol=atol)


class TestWord2Vec:
    @pytest.mark.parametrize("kw", [
        dict(use_hierarchic_softmax=True, negative=0),
        dict(use_hierarchic_softmax=False, negative=5),
        dict(use_hierarchic_softmax=True, negative=3, batch_size=128),
        dict(use_hierarchic_softmax=True, negative=0,
             elements_algorithm="cbow"),
        dict(use_hierarchic_softmax=False, negative=4, sampling=1e-2)])
    def test_device_fit_equals_jax(self, kw):
        """``fit`` on the device path (vocab, the seeded tables, the keys,
        the learning-rate decay over two epochs) within EPOCH_ATOL of
        JAX's."""
        corpus = _synthetic_corpus(60)
        common = dict(layer_size=16, window=3, min_word_frequency=2,
                      epochs=2, learning_rate=0.05, seed=7,
                      backend="device")
        common.setdefault("batch_size", 256)
        common.update(kw)
        t, j = _w2v_pair(**common)
        t.fit(tnlp.CollectionSentenceIterator(corpus))
        j.fit(jnlp.CollectionSentenceIterator(corpus))
        assert [t.vocab.word_at_index(i) for i in range(t.vocab_size())] \
            == [j.vocab.word_at_index(i) for i in range(j.vocab_size())]
        _assert_tables(t, j)
        assert abs(t.similarity("day", "sun")
                   - j.similarity("day", "sun")) < 1e-4

    @pytest.mark.parametrize("algo", ["skipgram", "cbow"])
    def test_native_tables_equal_jax_native_run(self, algo):
        """``backend="auto"`` on the host takes the native loop in both
        packages: the same C source on the same inputs gives bitwise the
        same tables."""
        corpus = _synthetic_corpus(80)
        t, j = _w2v_pair(layer_size=16, window=3, min_word_frequency=2,
                         epochs=2, negative=5, use_hierarchic_softmax=False,
                         learning_rate=0.05, seed=7,
                         elements_algorithm=algo)
        t.fit(tnlp.CollectionSentenceIterator(corpus))
        j.fit(jnlp.CollectionSentenceIterator(corpus))
        assert isinstance(t.syn0, np.ndarray)
        assert np.array_equal(t.syn0, np.asarray(j.syn0))
        assert np.array_equal(t.syn1neg, np.asarray(j.syn1neg))

    def test_native_backend_routing_rules(self):
        corpus = _synthetic_corpus(60)

        def built(**kw):
            kw.setdefault("window", 2)
            kw.setdefault("layer_size", 8)
            w = tnlp.Word2Vec(min_word_frequency=1, device=CPU, **kw)
            w.build_vocab(corpus)
            w.reset_weights()
            return w

        assert built(negative=5, use_hierarchic_softmax=False
                     )._use_native_backend()
        assert not built(negative=5, use_hierarchic_softmax=True
                         )._use_native_backend()
        assert not built(negative=5, use_hierarchic_softmax=False,
                         backend="device")._use_native_backend()
        assert not built(negative=5, use_hierarchic_softmax=False,
                         sampling=1e-3)._use_native_backend()
        assert built(negative=5, use_hierarchic_softmax=False,
                     elements_algorithm="cbow")._use_native_backend()
        assert not built(negative=5, use_hierarchic_softmax=False,
                         elements_algorithm="cbow",
                         window=65)._use_native_backend()
        assert not built(negative=5, use_hierarchic_softmax=False,
                         layer_size=4097)._use_native_backend()
        with pytest.raises(ValueError, match="native"):
            built(negative=0, use_hierarchic_softmax=True,
                  backend="native")._use_native_backend()
        # native-eligible tables start on the host, others on the device
        assert isinstance(built(negative=5, use_hierarchic_softmax=False
                                ).syn0, np.ndarray)
        assert torch.is_tensor(built(negative=5).syn0)
        # on a card "auto" keeps the tables there; "native" takes the loop
        ns = dict(negative=5, use_hierarchic_softmax=False, layer_size=8)
        assert not tnlp.Word2Vec(device="cuda", **ns)._use_native_backend()
        assert tnlp.Word2Vec(device="cuda", backend="native",
                             **ns)._use_native_backend()

    def test_native_fallback_reuses_materialized_corpus(self, monkeypatch):
        """When the native kernel bails after the corpus walk consumed a
        one-shot generator, the device fallback trains on the
        materialized index corpus (JAX ``sequence_vectors.py:227-241``),
        and its tables move to the device."""
        corpus = _synthetic_corpus(80)
        w2v = tnlp.Word2Vec(layer_size=16, window=3, min_word_frequency=2,
                            epochs=1, negative=5,
                            use_hierarchic_softmax=False, learning_rate=0.05,
                            seed=5, device=CPU)
        w2v.build_vocab(corpus)
        w2v.reset_weights()
        before = np.array(w2v.syn0, copy=True)
        monkeypatch.setattr(tnative, "skipgram_train", lambda *a, **k: None)
        trained = []
        orig = w2v._fit_element_epochs
        w2v._fit_element_epochs = lambda sents: (
            trained.append(sum(len(s) for s in sents)) or orig(sents))
        w2v._fit_native(iter(corpus))
        assert trained and trained[0] > 0
        assert torch.is_tensor(w2v.syn0)
        assert not np.allclose(_np(w2v.syn0), before)

    @pytest.mark.parametrize("hs,negative,lr,backend", [
        (True, 0, 0.05, "device"), (False, 5, 0.05, "device"),
        (False, 5, 0.05, "native")])
    def test_learns_topic_structure(self, hs, negative, lr, backend):
        corpus = _synthetic_corpus()
        w2v = tnlp.Word2Vec(layer_size=32, window=4, min_word_frequency=3,
                            epochs=4, use_hierarchic_softmax=hs,
                            negative=negative, learning_rate=lr, seed=7,
                            backend=backend, device=CPU)
        w2v.fit(tnlp.CollectionSentenceIterator(corpus))
        assert w2v.similarity("day", "sun") > w2v.similarity("day", "moon")
        assert w2v.similarity("night", "moon") > \
            w2v.similarity("night", "sun")

    def test_words_nearest_and_sum_equal_jax(self):
        corpus = _synthetic_corpus()
        t, j = _w2v_pair(layer_size=32, window=4, min_word_frequency=3,
                         epochs=4, negative=5, seed=11, backend="device")
        t.fit(tnlp.CollectionSentenceIterator(corpus))
        j.fit(jnlp.CollectionSentenceIterator(corpus))
        near_t = t.words_nearest("moon", 4)
        assert [w for w, _ in near_t] == [w for w, _ in
                                          j.words_nearest("moon", 4)]
        assert "moon" not in [w for w, _ in near_t]
        assert len({"night", "dark", "star", "cold", "midnight"}
                   & {w for w, _ in near_t}) >= 1
        np.testing.assert_allclose(
            [s for _, s in near_t],
            [s for _, s in j.words_nearest("moon", 4)], atol=1e-4)
        vec = t.word_vector("sun")
        assert [w for w, _ in t.words_nearest(vec, 3)] == \
            [w for w, _ in j.words_nearest(np.asarray(vec), 3)]
        got = t.words_nearest_sum(["day", "moon"], ["sun"], 3)
        want = j.words_nearest_sum(["day", "moon"], ["sun"], 3)
        assert [w for w, _ in got] == [w for w, _ in want]

    def test_tiny_vocab_large_batch_stays_finite_and_learns(self):
        rs = np.random.RandomState(42)
        topic_a = ["cat", "dog", "bird", "fish", "horse", "cow"]
        topic_b = ["hammer", "wrench", "drill", "saw", "pliers", "chisel"]
        sentences = [" ".join(rs.choice(topic_a if rs.rand() < 0.5
                                        else topic_b, 8))
                     for _ in range(600)]
        w2v = tnlp.Word2Vec(layer_size=32, window=5, min_word_frequency=1,
                            epochs=3, negative=5,
                            use_hierarchic_softmax=False, batch_size=4096,
                            seed=1, backend="device", device=CPU)
        w2v.fit(tnlp.CollectionSentenceIterator(sentences))
        assert torch.isfinite(w2v.syn0).all()
        near = [w for w, _ in w2v.words_nearest("cat", 5)]
        assert all(w in topic_a for w in near), near

    def test_trains_on_cjk_corpus(self):
        rs = np.random.RandomState(0)
        a, b = "深度学习模型", "音乐歌曲舞蹈"
        sents = ["".join((a if rs.rand() < 0.5 else b)[rs.randint(6)]
                         for _ in range(8)) for _ in range(300)]
        kw = dict(layer_size=24, window=3, min_word_frequency=2, negative=5,
                  use_hierarchic_softmax=False, epochs=4, seed=5)
        t = tnlp.Word2Vec(tokenizer_factory=tnlp.CjkTokenizerFactory(),
                          device=CPU, **kw)
        j = jnlp.Word2Vec(tokenizer_factory=jnlp.CjkTokenizerFactory(), **kw)
        t.fit(tnlp.CollectionSentenceIterator(sents))
        j.fit(jnlp.CollectionSentenceIterator(sents))
        assert np.array_equal(t.syn0, np.asarray(j.syn0))   # native, both
        assert t.similarity(a[:2], a[2:4]) > t.similarity(a[:2], b[:2])

    def test_one_epoch_from_a_jax_state(self):
        """``utils/convert.py`` carries a JAX trainer's vocab, Huffman tree
        and tables into the port; one more epoch in each package from that
        state agrees within EPOCH_ATOL."""
        corpus = _synthetic_corpus(60)
        kw = dict(layer_size=16, window=3, min_word_frequency=2, epochs=1,
                  learning_rate=0.05, negative=3, seed=7, backend="device",
                  batch_size=128)
        j = jnlp.Word2Vec(**kw)
        j.fit(corpus)
        t = sequence_vectors_from_jax(sequence_vectors_state(j),
                                      tnlp.Word2Vec(device=CPU, **kw))
        _assert_tables(t, j, atol=0)
        for i in range(j.vocab_size()):
            a, b = t.vocab.element_at_index(i), j.vocab.element_at_index(i)
            assert (a.word, a.count, a.codes, a.points) == \
                (b.word, b.count, b.codes, b.points)
        t.fit(corpus)
        j.fit(corpus)
        _assert_tables(t, j)


class TestSerde:
    def _trained(self):
        w2v = tnlp.Word2Vec(layer_size=16, min_word_frequency=2, epochs=1,
                            negative=3, seed=5, backend="device",
                            device=CPU)
        w2v.fit(tnlp.CollectionSentenceIterator(_synthetic_corpus(100)))
        return w2v

    @pytest.mark.parametrize("binary", [True, False])
    def test_files_byte_identical_both_ways(self, binary, tmp_path):
        """The port and JAX write the same bytes for the same tables; each
        reads the other's file to the same words and vectors."""
        t = self._trained()
        j = jnlp.Word2Vec(layer_size=16)
        j.vocab = jnlp.VocabConstructor(min_word_frequency=2).build_vocab(
            _synthetic_corpus(100))
        j.syn0 = jnp.asarray(_np(t.syn0))
        wt, wj = ((tserde.write_word2vec_binary, jserde.write_word2vec_binary)
                  if binary else (tserde.write_word_vectors_text,
                                  jserde.write_word_vectors_text))
        pt, pj = str(tmp_path / "t"), str(tmp_path / "j")
        wt(t, pt)
        wj(j, pj)
        assert open(pt, "rb").read() == open(pj, "rb").read()
        mt = tserde.load_word2vec(pj, binary=binary, device=CPU)
        mj = jserde.load_word2vec(pt, binary=binary)
        assert [mt.vocab.word_at_index(i) for i in range(mt.vocab_size())] \
            == [mj.vocab.word_at_index(i) for i in range(mj.vocab_size())]
        np.testing.assert_array_equal(_np(mt.syn0), np.asarray(mj.syn0))
        atol = 0 if binary else 1e-6       # text keeps six decimals
        for w in ("day", "night", "the"):
            if t.has_word(w):
                np.testing.assert_allclose(mt.word_vector(w),
                                           t.word_vector(w), atol=atol)
        assert abs(t.similarity("day", "sun")
                   - mt.similarity("day", "sun")) < 1e-5

    def test_round4_fixture_loads_as_jax_reads_it(self):
        import pathlib

        root = pathlib.Path(__file__).resolve().parent / "fixtures"
        path = str(root / "regression_vectors_r4.bin")
        exp = np.load(root / "regression_vectors_r4_expected.npz")
        m = tserde.load_word2vec(path, binary=True, device=CPU)
        j = jserde.load_word2vec(path, binary=True)
        np.testing.assert_array_equal(_np(m.syn0), np.asarray(j.syn0))
        words, vecs = tserde.read_word2vec_binary(path)
        jwords, jvecs = jserde.read_word2vec_binary(path)
        assert words == jwords and np.array_equal(vecs, jvecs)
        assert m.vocab.num_words() == len(words) and vecs.shape[1] == 12
        np.testing.assert_allclose(m.word_vector("w1"), exp["w1"], atol=1e-6)


# ---------------------------------------------------------- doc2vec, GloVe
class TestParagraphVectors:
    @pytest.mark.parametrize("algo", ["dbow", "dm"])
    @pytest.mark.parametrize("hs", [False, True])
    def test_device_fit_equals_jax(self, algo, hs):
        kw = dict(layer_size=16, window=3, min_word_frequency=2, epochs=2,
                  negative=3, use_hierarchic_softmax=hs,
                  sequence_algorithm=algo, learning_rate=0.05, seed=9,
                  backend="device")
        t = tnlp.ParagraphVectors(device=CPU, **kw)
        j = jnlp.ParagraphVectors(**kw)
        t.fit(_docs(TDoc))
        j.fit(_docs(JDoc))
        assert t._label_ids == j._label_ids
        _assert_tables(t, j)
        for text in ("sun light warm", "moon dark"):
            np.testing.assert_allclose(
                t.infer_vector(text, iterations=5, seed=3),
                np.asarray(j.infer_vector(text, iterations=5, seed=3)),
                atol=STEP_ATOL)

    def test_infer_vector_from_a_jax_state(self):
        """``infer_vector`` from the JAX tables (``utils/convert.py``)
        within STEP_ATOL of JAX's, and deterministic."""
        kw = dict(layer_size=24, window=3, min_word_frequency=2, epochs=3,
                  negative=5, use_hierarchic_softmax=True, seed=4,
                  backend="device")
        j = jnlp.ParagraphVectors(**kw)
        j.fit(_docs(JDoc))
        t = sequence_vectors_from_jax(sequence_vectors_state(j),
                                      tnlp.ParagraphVectors(device=CPU,
                                                            **kw))
        v1 = t.infer_vector("sun light warm", iterations=10, seed=0)
        v2 = t.infer_vector("sun light warm", iterations=10, seed=0)
        assert np.array_equal(v1, v2) and v1.shape == (24,)
        np.testing.assert_allclose(
            v1, np.asarray(j.infer_vector("sun light warm", iterations=10,
                                          seed=0)), atol=STEP_ATOL)
        assert abs(t.similarity_to_label("sun light", "DAY")
                   - j.similarity_to_label("sun light", "DAY")) < 1e-5

    @pytest.mark.parametrize("algo", ["dbow", "dm"])
    def test_native_tables_equal_jax_native_run(self, algo):
        kw = dict(layer_size=16, window=3, min_word_frequency=1, epochs=3,
                  negative=5, use_hierarchic_softmax=False,
                  sequence_algorithm=algo, seed=3)
        t = tnlp.ParagraphVectors(device=CPU, **kw)
        j = jnlp.ParagraphVectors(**kw)
        t.fit(_docs(TDoc, 40))
        j.fit(_docs(JDoc, 40))
        assert isinstance(t.syn0, np.ndarray)
        assert np.array_equal(t.syn0, np.asarray(j.syn0))
        assert np.array_equal(t.syn1neg, np.asarray(j.syn1neg))

    def test_native_routing_rules(self):
        def pv(**kw):
            return tnlp.ParagraphVectors(layer_size=8, min_word_frequency=1,
                                         device=CPU, **kw)

        assert pv(negative=5, use_hierarchic_softmax=False
                  )._native_eligible_config()
        assert not pv(negative=5, use_hierarchic_softmax=False,
                      backend="device")._native_eligible_config()
        assert pv(negative=5, use_hierarchic_softmax=False,
                  sequence_algorithm="dm")._native_eligible_config()
        assert not pv(negative=5, use_hierarchic_softmax=False,
                      train_words=True)._native_eligible_config()
        assert not pv(negative=0, use_hierarchic_softmax=True
                      )._native_eligible_config()

    @pytest.mark.parametrize("algo", ["dbow", "dm"])
    def test_doc_classification(self, algo):
        pv = tnlp.ParagraphVectors(layer_size=24, window=3,
                                   min_word_frequency=2, epochs=6,
                                   negative=5, use_hierarchic_softmax=False,
                                   sequence_algorithm=algo,
                                   learning_rate=0.05, seed=9,
                                   backend="device", device=CPU)
        pv.fit(_docs(TDoc, 120))
        assert set(pv.labels()) == {"DAY", "NIGHT"}
        assert pv.predict("sun light warm bright day sun") == "DAY"
        assert pv.predict("moon dark star cold night moon") == "NIGHT"

    def test_train_words_equals_jax(self):
        kw = dict(layer_size=16, window=2, min_word_frequency=2, epochs=1,
                  negative=3, use_hierarchic_softmax=True, train_words=True,
                  learning_rate=0.05, seed=2, backend="device")
        t = tnlp.ParagraphVectors(device=CPU, **kw)
        j = jnlp.ParagraphVectors(**kw)
        t.fit(_docs(TDoc, 30))
        j.fit(_docs(JDoc, 30))
        _assert_tables(t, j)


class TestGlove:
    def test_fit_equals_jax(self):
        """Co-occurrences, the seeded tables, the permutation of each epoch
        (bitwise) and three AdaGrad epochs within EPOCH_ATOL of JAX's."""
        corpus = _synthetic_corpus(80)
        kw = dict(layer_size=12, window=4, min_word_frequency=3, epochs=3,
                  learning_rate=0.1, batch_size=128, seed=13)
        t = tnlp.Glove(device=CPU, **kw)
        j = jnlp.Glove(**kw)
        t.fit(corpus)
        j.fit(corpus)
        np.testing.assert_allclose(_np(t.syn0), np.asarray(j.syn0), rtol=0,
                                   atol=EPOCH_ATOL)

    def test_epoch_permutation_is_jax_permutation(self):
        for n in (1, 5, 300, 4096):
            got = prandom.permutation(
                prandom.fold_in(prandom.PRNGKey(13, device=CPU), 2), n)
            want = jax.random.permutation(
                jax.random.fold_in(jax.random.PRNGKey(13), 2), n)
            assert np.array_equal(_np(got), np.asarray(want))

    def test_learns_topic_structure(self):
        g = tnlp.Glove(layer_size=24, window=6, min_word_frequency=3,
                       epochs=40, learning_rate=0.1, seed=13, device=CPU)
        g.fit(_synthetic_corpus(250))
        assert g.similarity("day", "sun") > g.similarity("day", "moon")
