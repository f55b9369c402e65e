# ported from paddle_tpu/dataset/text.py
"""Text/sequence dataset family (reference: python/paddle/dataset/ — imdb.py,
imikolov.py, conll05.py, wmt14.py/wmt16.py, movielens.py).

Synthetic, deterministic, zero-egress — same reader contracts (yield
structure, dtypes, dict helpers) as the download-backed reference modules;
see dataset/synthetic.py for the substitution rationale.
"""

from __future__ import annotations

import numpy as np

__all__ = ["imdb", "imikolov", "conll05", "wmt16", "movielens"]


class _Synth:
    pass


def _seq(rng, vocab, lo=4, hi=30):
    return rng.randint(2, vocab, size=rng.randint(lo, hi)).astype("int64").tolist()


# -- imdb: sentiment classification ------------------------------------------


class imdb(_Synth):
    """reference: dataset/imdb.py — (word-id sequence, 0/1 label)."""

    VOCAB = 5147  # reference word_dict size ballpark

    @staticmethod
    def word_dict():
        return {("w%d" % i).encode(): i for i in range(imdb.VOCAB)}

    @staticmethod
    def _reader(n, seed):
        def reader():
            rng = np.random.RandomState(seed)
            # label leaks into token distribution so models can learn
            for _ in range(n):
                y = int(rng.randint(2))
                base = _seq(rng, imdb.VOCAB)
                marker = 3 if y else 4
                seq = [marker if rng.rand() < 0.3 else t for t in base]
                yield seq, y

        return reader

    @staticmethod
    def train(word_idx=None):
        return imdb._reader(2000, seed=11)

    @staticmethod
    def test(word_idx=None):
        return imdb._reader(400, seed=12)


# -- imikolov: language-model n-grams -----------------------------------------


class imikolov(_Synth):
    """reference: dataset/imikolov.py — n-gram windows for word2vec/NNLM."""

    VOCAB = 2074

    @staticmethod
    def build_dict(min_word_freq=50):
        return {("w%d" % i).encode(): i for i in range(imikolov.VOCAB)}

    @staticmethod
    def _reader(n, ngram, seed):
        def reader():
            rng = np.random.RandomState(seed)
            # Markov-ish chain: next word correlated with previous
            for _ in range(n):
                start = int(rng.randint(2, imikolov.VOCAB - ngram - 3))
                window = [(start + i * 3) % imikolov.VOCAB for i in range(ngram)]
                yield tuple(window)

        return reader

    @staticmethod
    def train(word_idx=None, n=5):
        return imikolov._reader(4000, n, seed=21)

    @staticmethod
    def test(word_idx=None, n=5):
        return imikolov._reader(800, n, seed=22)


# -- conll05: semantic role labeling ------------------------------------------


class conll05(_Synth):
    """reference: dataset/conll05.py — SRL: (word, ctx-ngrams×5, predicate,
    mark, IOB label) sequences. Synthetic grammar keeps tags learnable."""

    WORD_VOCAB = 4000
    PRED_VOCAB = 300
    NUM_LABELS = 9  # IOB over 4 chunk types + O

    @staticmethod
    def get_dict():
        word_dict = {("w%d" % i).encode(): i for i in range(conll05.WORD_VOCAB)}
        verb_dict = {("v%d" % i).encode(): i for i in range(conll05.PRED_VOCAB)}
        label_dict = {("l%d" % i).encode(): i for i in range(conll05.NUM_LABELS)}
        return word_dict, verb_dict, label_dict

    @staticmethod
    def _reader(n, seed):
        def reader():
            rng = np.random.RandomState(seed)
            for _ in range(n):
                t = int(rng.randint(5, 20))
                words = rng.randint(0, conll05.WORD_VOCAB, t).astype("int64")
                pred = int(rng.randint(conll05.PRED_VOCAB))
                pred_pos = int(rng.randint(t))
                mark = np.zeros(t, "int64")
                mark[pred_pos] = 1
                # labels depend on distance to predicate — learnable
                labels = np.minimum(np.abs(np.arange(t) - pred_pos),
                                    conll05.NUM_LABELS - 1).astype("int64")
                ctx = [np.roll(words, s) for s in (-2, -1, 0, 1, 2)]
                yield (words.tolist(), *[c.tolist() for c in ctx],
                       [pred] * t, mark.tolist(), labels.tolist())

        return reader

    @staticmethod
    def test():
        return conll05._reader(200, seed=32)

    @staticmethod
    def train():
        return conll05._reader(1000, seed=31)


# -- wmt16: translation pairs --------------------------------------------------


class wmt16(_Synth):
    """reference: dataset/wmt16.py — (src ids, trg ids, trg_next ids)."""

    SRC_VOCAB = 3000
    TRG_VOCAB = 3000
    BOS, EOS, UNK = 0, 1, 2

    @staticmethod
    def _reader(n, seed):
        def reader():
            rng = np.random.RandomState(seed)
            for _ in range(n):
                src = _seq(rng, wmt16.SRC_VOCAB, 4, 20)
                # target = reversed source offset by 7 → learnable mapping
                trg_core = [(t + 7) % wmt16.TRG_VOCAB for t in reversed(src)]
                trg = [wmt16.BOS] + trg_core
                trg_next = trg_core + [wmt16.EOS]
                yield src, trg, trg_next

        return reader

    @staticmethod
    def train(src_dict_size=SRC_VOCAB, trg_dict_size=TRG_VOCAB, src_lang="en"):
        return wmt16._reader(2000, seed=41)

    @staticmethod
    def test(src_dict_size=SRC_VOCAB, trg_dict_size=TRG_VOCAB, src_lang="en"):
        return wmt16._reader(400, seed=42)


# -- movielens: ratings --------------------------------------------------------


class movielens(_Synth):
    """reference: dataset/movielens.py — (user feats, movie feats, rating)."""

    N_USERS = 944
    N_MOVIES = 1683
    N_AGES = 7
    N_JOBS = 21
    N_CATEGORIES = 19

    @staticmethod
    def max_user_id():
        return movielens.N_USERS - 1

    @staticmethod
    def max_movie_id():
        return movielens.N_MOVIES - 1

    @staticmethod
    def max_job_id():
        return movielens.N_JOBS - 1

    @staticmethod
    def _reader(n, seed):
        def reader():
            rng = np.random.RandomState(seed)
            # latent-factor ground truth → ratings are learnable
            ru = np.random.RandomState(7).randn(movielens.N_USERS, 4)
            rm = np.random.RandomState(8).randn(movielens.N_MOVIES, 4)
            for _ in range(n):
                u = int(rng.randint(movielens.N_USERS))
                m = int(rng.randint(movielens.N_MOVIES))
                gender = u % 2
                age = u % movielens.N_AGES
                job = u % movielens.N_JOBS
                title = [(m + i) % 5000 for i in range(3)]
                categories = [m % movielens.N_CATEGORIES]
                score = float(np.clip(2.5 + ru[u] @ rm[m], 1.0, 5.0))
                yield [u], [gender], [age], [job], [m], categories, title, [score]

        return reader

    @staticmethod
    def train():
        return movielens._reader(4000, seed=51)

    @staticmethod
    def test():
        return movielens._reader(800, seed=52)
