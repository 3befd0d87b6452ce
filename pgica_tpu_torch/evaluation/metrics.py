"""Caption-quality metrics suite (the port's copy of pgica_tpu/evaluation/metrics.py).

The same metrics, computed the same way: each is Python/NumPy except the
two that run the model (BERTScore's text-tower route and CLIP-Score), which
call the port's inference module on the model's device and bring the
results to the host. Offline-capable (no network, no nltk corpora needed):

* BLEU-1..4 — standard modified n-gram precision with brevity penalty
  (reference uses HF ``evaluate``'s bleu; same definition).
* ROUGE-1/2/L — per-pair F-measure then mean (reference metrics.py:275-309);
  uses the ``rouge_score`` package when importable, else the built-in port.
* METEOR — simplified unigram-matching METEOR (exact + stem-ish suffix
  matching, harmonic mean weighted to recall, fragmentation penalty).
  The reference delegates to HF evaluate/nltk; semantics documented here.
* CIDEr — exact port of the reference's from-scratch CIDEr
  (metrics.py:441-572): IDF over reference documents, 1-4-gram TF-IDF
  cosine, Gaussian length penalty sigma=6, x10 scaling.
* BERTScore — embedding-based token F1. With no offline BERT available,
  the default scorer embeds tokens with the framework's own text tower when
  given one (each distinct text once, ``BERT_SCORE_BATCH`` texts a forward),
  else falls back to a character-n-gram soft-F1 proxy
  (``bert_score_proxy=True`` in the result marks the fallback).
* CLIP-Score — image-text similarity from the framework's own contrastive
  model (reference loads a second CLIP; here the aligned model itself is the
  scorer, reference metrics.py:380-439).
* Preference metrics — Jaccard-token win rate vs preferred/rejected +
  Pearson correlation with human scores (reference metrics.py:574-661).
* Diversity — distinct-1/2 and unique-caption ratio (reference 663-712).
"""

from __future__ import annotations

import logging
import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_WORD_RE = re.compile(r"\w+|[^\w\s]")


def word_tokenize(text: str) -> List[str]:
    """Self-contained lowercase word tokenizer (no nltk corpora needed)."""
    return _WORD_RE.findall(text.lower())


def _ngram_counts(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


class _TableLemma:
    __slots__ = ("_name",)

    def __init__(self, name: str):
        self._name = name

    def name(self) -> str:
        return self._name


class _TableSynset:
    __slots__ = ("_lemmas",)

    def __init__(self, names):
        self._lemmas = [_TableLemma(n) for n in names]

    def lemmas(self):
        return self._lemmas


class _TableWordnet:
    """Wordnet-shaped synonym table for METEOR's synonym stage.

    Exposes exactly the surface nltk's aligner consumes —
    ``synsets(word) -> [synset.lemmas() -> lemma.name()]`` — backed by a JSON
    file mapping word -> [synonyms]. The mapping is symmetrized at load (real
    wordnet synonymy is symmetric through shared synsets). Multiword lemmas
    (containing "_") are filtered by nltk itself, matching real-corpus
    behavior.
    """

    def __init__(self, table: Dict[str, List[str]]):
        # nltk's aligner runs its stem stage BEFORE the wordnet stage and
        # hands the synonym matcher the STEMMED leftovers (upstream
        # _enum_stem_match returns stemmed unmatched lists), so lookups and
        # lemma names must also cover Porter-stemmed forms of every entry.
        try:
            from nltk.stem.porter import PorterStemmer

            stem = PorterStemmer().stem
        except Exception:  # table still works for exact surface forms
            def stem(w):
                return w

        sym: Dict[str, set] = {}
        for word, syns in table.items():
            w = word.lower()
            for s in syns:
                s = s.lower()
                for a, b in ((w, s), (s, w)):
                    for key in {a, stem(a)}:
                        sym.setdefault(key, set()).update({b, stem(b)})
        self._table = {w: sorted(s) for w, s in sym.items()}

    @classmethod
    def from_json(cls, path: str) -> "_TableWordnet":
        import json

        with open(path) as f:
            table = json.load(f)
        if not isinstance(table, dict):
            raise ValueError(f"{path}: expected a JSON object of word -> [synonyms]")
        return cls(table)

    def synsets(self, word: str):
        names = self._table.get(word.lower())
        return [_TableSynset([word.lower(), *names])] if names else []


class CaptioningMetrics:
    """All caption metrics behind one object (reference surface parity)."""

    def __init__(
        self,
        device: Optional[str] = None,
        cache_dir: Optional[str] = None,
        model=None,
        clip_judge=None,
        bert_model_path: Optional[str] = None,
        wordnet_path: Optional[str] = None,
    ):
        # device/cache_dir kept for reference API parity; the model's device is used.
        self.device = device
        self.cache_dir = cache_dir
        self.model = model  # optional PreferenceGuidedCaptioningModel for clip/bert scores
        # Independent CLIP-Score judge (reference loads a SECOND frozen CLIP,
        # metrics.py:380-439): any object with compute_similarity/tokenizer/
        # temperature/max_caption_length — e.g. a separately-trained
        # PreferenceGuidedCaptioningModel restored from a judge checkpoint.
        self.clip_judge = clip_judge
        # Local HF encoder checkpoint directory for REAL BERTScore embeddings
        # (transformers runs offline against local files, on the model's device).
        self.bert_model_path = bert_model_path
        self._hf_bert = None
        # METEOR synonym stage (reference metrics.py:311-338 delegates to nltk
        # with the wordnet corpus, absent offline). ``wordnet_path`` is either
        # an nltk data directory (containing corpora/wordnet — enables the
        # REAL nltk reader) or a JSON file mapping word -> [synonyms] (wrapped
        # in a wordnet-shaped table with the same synsets/lemmas/name surface
        # nltk's aligner consumes).
        self.wordnet_path = wordnet_path
        self._wordnet = None
        self._wordnet_resolved = False

    # ------------------------------------------------------------------ BLEU

    def compute_bleu_scores(
        self, predictions: List[str], references: List[List[str]]
    ) -> Dict[str, float]:
        references = self._listify(references)
        out = {}
        for n in range(1, 5):
            out[f"bleu_{n}"] = self._corpus_bleu(predictions, references, max_n=n)
        out["bleu"] = out["bleu_4"]
        return out

    @staticmethod
    def _corpus_bleu(predictions, references, max_n: int) -> float:
        clipped = [0] * max_n
        totals = [0] * max_n
        pred_len_sum = 0
        ref_len_sum = 0
        for pred, refs in zip(predictions, references):
            pred_tok = word_tokenize(pred)
            refs_tok = [word_tokenize(r) for r in refs]
            pred_len_sum += len(pred_tok)
            # closest reference length (standard BLEU brevity penalty)
            if refs_tok:
                ref_len_sum += min(
                    (abs(len(r) - len(pred_tok)), len(r)) for r in refs_tok
                )[1]
            for n in range(1, max_n + 1):
                pc = _ngram_counts(pred_tok, n)
                max_ref = Counter()
                for r in refs_tok:
                    rc = _ngram_counts(r, n)
                    for g, c in rc.items():
                        max_ref[g] = max(max_ref[g], c)
                totals[n - 1] += max(sum(pc.values()), 0)
                clipped[n - 1] += sum(min(c, max_ref.get(g, 0)) for g, c in pc.items())
        precisions = []
        for n in range(max_n):
            if totals[n] == 0:
                precisions.append(0.0)
            else:
                # add-epsilon smoothing for zero clipped counts
                precisions.append((clipped[n] or 1e-9) / totals[n])
        if min(precisions) <= 0:
            return 0.0
        log_p = sum(math.log(p) for p in precisions) / max_n
        bp = 1.0 if pred_len_sum > ref_len_sum else math.exp(1 - ref_len_sum / max(pred_len_sum, 1))
        return float(bp * math.exp(log_p))

    # ------------------------------------------------------------------ ROUGE

    def compute_rouge_scores(
        self, predictions: List[str], references: List[List[str]]
    ) -> Dict[str, float]:
        references = self._listify(references)
        try:
            from rouge_score import rouge_scorer

            scorer = rouge_scorer.RougeScorer(["rouge1", "rouge2", "rougeL"], use_stemmer=True)
            agg = defaultdict(list)
            for pred, refs in zip(predictions, references):
                best = {k: 0.0 for k in ("rouge1", "rouge2", "rougeL")}
                for ref in refs:
                    s = scorer.score(ref, pred)
                    for k in best:
                        best[k] = max(best[k], s[k].fmeasure)
                for k, v in best.items():
                    agg[k].append(v)
            return {
                "rouge_1": float(np.mean(agg["rouge1"])) if agg["rouge1"] else 0.0,
                "rouge_2": float(np.mean(agg["rouge2"])) if agg["rouge2"] else 0.0,
                "rouge_l": float(np.mean(agg["rougeL"])) if agg["rougeL"] else 0.0,
            }
        except ImportError:
            return self._rouge_builtin(predictions, references)

    def _rouge_builtin(self, predictions, references) -> Dict[str, float]:
        def f1(p_counts: Counter, r_counts: Counter) -> float:
            overlap = sum((p_counts & r_counts).values())
            p_total, r_total = sum(p_counts.values()), sum(r_counts.values())
            if overlap == 0 or p_total == 0 or r_total == 0:
                return 0.0
            p, r = overlap / p_total, overlap / r_total
            return 2 * p * r / (p + r)

        def lcs_len(a: List[str], b: List[str]) -> int:
            dp = [0] * (len(b) + 1)
            for x in a:
                prev = 0
                for j, y in enumerate(b, 1):
                    cur = dp[j]
                    dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
                    prev = cur
            return dp[-1]

        r1, r2, rl = [], [], []
        for pred, refs in zip(predictions, references):
            pt = word_tokenize(pred)
            best1 = best2 = bestl = 0.0
            for ref in refs:
                rt = word_tokenize(ref)
                best1 = max(best1, f1(_ngram_counts(pt, 1), _ngram_counts(rt, 1)))
                best2 = max(best2, f1(_ngram_counts(pt, 2), _ngram_counts(rt, 2)))
                lcs = lcs_len(pt, rt)
                if lcs and pt and rt:
                    p, r = lcs / len(pt), lcs / len(rt)
                    bestl = max(bestl, 2 * p * r / (p + r))
            r1.append(best1)
            r2.append(best2)
            rl.append(bestl)
        return {
            "rouge_1": float(np.mean(r1)) if r1 else 0.0,
            "rouge_2": float(np.mean(r2)) if r2 else 0.0,
            "rouge_l": float(np.mean(rl)) if rl else 0.0,
        }

    # ------------------------------------------------------------------ METEOR

    def compute_meteor_score(
        self, predictions: List[str], references: List[List[str]]
    ) -> Dict[str, float]:
        """METEOR with real nltk semantics (reference metrics.py:311-338).

        Uses nltk's ``single_meteor_score`` (exact + Porter-stem alignment
        stages, alpha=0.9/beta=3/gamma=0.5) when nltk is importable. The
        wordnet-synonym stage needs the wordnet corpus; when it is absent a
        no-op wordnet is substituted — exact nltk behavior minus synonym-only
        matches — and ``meteor_synonym_stage`` is 0.0 to mark the deviation.
        Falls back to the built-in implementation (``meteor_nltk=0.0``) only
        when nltk itself is missing.
        """
        references = self._listify(references)
        scorer = self._nltk_meteor_pair()
        flags = {"meteor_nltk": 1.0 if scorer else 0.0}
        if scorer is None:
            scorer = self._meteor_pair
            flags["meteor_synonym_stage"] = 0.0
        else:
            flags["meteor_synonym_stage"] = 1.0 if self._resolve_wordnet() is not None else 0.0
        scores = []
        for pred, refs in zip(predictions, references):
            scores.append(max(scorer(pred, ref) for ref in refs) if refs else 0.0)
        return {"meteor": float(np.mean(scores)) if scores else 0.0, **flags}

    def _resolve_wordnet(self):
        """Synonym backend for METEOR, resolved once.

        Priority: ``wordnet_path`` (nltk data dir, or JSON synonym table) ->
        nltk's installed wordnet corpus -> None (synonym stage flagged off).
        """
        if self._wordnet_resolved:
            return self._wordnet
        self._wordnet_resolved = True
        if self.wordnet_path:
            import os

            path = str(self.wordnet_path)
            try:
                if os.path.isdir(path):
                    import nltk.data

                    if path not in nltk.data.path:
                        nltk.data.path.insert(0, path)
                    from nltk.corpus import wordnet

                    wordnet.synsets("test")  # force-load the corpus
                    self._wordnet = wordnet
                else:
                    self._wordnet = _TableWordnet.from_json(path)
                return self._wordnet
            except Exception as e:
                logger.warning("wordnet_path %s unusable (%s); synonym stage off", path, e)
        try:
            from nltk.corpus import wordnet

            wordnet.synsets("test")
            self._wordnet = wordnet
        except Exception:
            self._wordnet = None
        return self._wordnet

    def _nltk_meteor_pair(self):
        """Returns fn(pred, ref) -> float backed by nltk, or None."""
        try:
            from nltk.stem.porter import PorterStemmer
            from nltk.translate.meteor_score import single_meteor_score
        except Exception:
            return None

        stemmer = PorterStemmer()
        wordnet = self._resolve_wordnet()
        if wordnet is None:
            class wordnet:  # no-op synonym stage (corpus unavailable offline)
                @staticmethod
                def synsets(word):
                    return []

        def pair(pred: str, ref: str) -> float:
            return float(
                single_meteor_score(
                    word_tokenize(ref), word_tokenize(pred),
                    stemmer=stemmer, wordnet=wordnet,
                )
            )

        return pair

    @staticmethod
    def _stem(tok: str) -> str:
        for suf in ("ing", "ed", "es", "s"):
            if tok.endswith(suf) and len(tok) - len(suf) >= 3:
                return tok[: -len(suf)]
        return tok

    def _meteor_pair(self, pred: str, ref: str, alpha=0.9, beta=3.0, gamma=0.5) -> float:
        pt, rt = word_tokenize(pred), word_tokenize(ref)
        if not pt or not rt:
            return 0.0
        used = [False] * len(rt)
        match_idx: List[Tuple[int, int]] = []
        for stage in (0, 1):  # exact, then stem
            for i, p in enumerate(pt):
                if any(i == mi for mi, _ in match_idx):
                    continue
                key = p if stage == 0 else self._stem(p)
                for j, r in enumerate(rt):
                    if used[j]:
                        continue
                    cand = r if stage == 0 else self._stem(r)
                    if key == cand:
                        used[j] = True
                        match_idx.append((i, j))
                        break
        m = len(match_idx)
        if m == 0:
            return 0.0
        precision, recall = m / len(pt), m / len(rt)
        fmean = precision * recall / (alpha * precision + (1 - alpha) * recall)
        # fragmentation: count contiguous matched chunks in pred order
        match_idx.sort()
        chunks = 1
        for (i1, j1), (i2, j2) in zip(match_idx, match_idx[1:]):
            if not (i2 == i1 + 1 and j2 == j1 + 1):
                chunks += 1
        penalty = gamma * (chunks / m) ** beta
        return fmean * (1 - penalty)

    # ------------------------------------------------------------------ CIDEr

    def compute_cider_score(
        self, predictions: List[str], references: List[List[str]], sigma: float = 6.0
    ) -> float:
        """Exact port of the reference's from-scratch CIDEr (metrics.py:463-572)."""
        references = self._listify(references)
        doc_freq: Dict[tuple, int] = defaultdict(int)
        for refs in references:
            seen = set()
            for ref in refs:
                toks = word_tokenize(ref)
                for n in range(1, 5):
                    for g in _ngram_counts(toks, n):
                        if g not in seen:
                            doc_freq[g] += 1
                            seen.add(g)
        total_docs = len(references)

        scores = []
        for pred, refs in zip(predictions, references):
            pt = word_tokenize(pred)
            ref_toks = [word_tokenize(r) for r in refs]
            score = 0.0
            for n in range(1, 5):
                pc = _ngram_counts(pt, n)
                rc: Dict[tuple, float] = defaultdict(float)
                for toks in ref_toks:
                    for g, c in _ngram_counts(toks, n).items():
                        rc[g] += c / len(ref_toks)
                num = p_norm = r_norm = 0.0
                for g in set(pc) | set(rc):
                    idf = math.log(total_docs / (doc_freq.get(g, 1) + 1e-8))
                    pw = pc.get(g, 0) * idf
                    rw = rc.get(g, 0.0) * idf
                    num += pw * rw
                    p_norm += pw * pw
                    r_norm += rw * rw
                score += num / math.sqrt(p_norm * r_norm) if p_norm > 0 and r_norm > 0 else 0.0
            score /= 4.0
            avg_ref_len = float(np.mean([len(t) for t in ref_toks])) if ref_toks else 0.0
            if avg_ref_len > 0:
                score *= math.exp(-((len(pt) - avg_ref_len) ** 2) / (2 * sigma**2))
            else:
                score = 0.0
            scores.append(score)
        return float(np.mean(scores) * 10.0) if scores else 0.0

    # ------------------------------------------------------------------ BERTScore

    def compute_bert_score(
        self, predictions: List[str], references: List[List[str]]
    ) -> Dict[str, float]:
        """BERTScore (reference metrics.py:340-378). Priority order:

        1. real pretrained-LM embeddings from a local HF checkpoint
           (``bert_model_path``) — ``bert_score_proxy = 0.0``;
        2. the framework's own text tower — flagged proxy (self-embeddings
           are not an independent judge);
        3. character-trigram soft-F1 — flagged proxy.
        """
        references = self._listify(references)
        if self.bert_model_path:
            try:
                return self._bert_score_hf(predictions, references)
            except Exception as e:  # pragma: no cover - depends on local files
                logger.warning("bert_model_path unusable (%s); falling back to proxy", e)
        if self.model is not None:
            return self._bert_score_model(predictions, references)
        return self._bert_score_chargram(predictions, references)

    def _bert_score_hf(self, predictions, references) -> Dict[str, float]:
        """Greedy-matching BERTScore over real pretrained-LM token embeddings
        (standard BERTScore without idf weighting, matching the reference's
        default; reference metrics.py:340-378)."""
        import torch

        device = self.model.device if self.model is not None else torch.device("cpu")
        if self._hf_bert is None:
            from transformers import AutoModel, AutoTokenizer

            tok = AutoTokenizer.from_pretrained(self.bert_model_path)
            mdl = AutoModel.from_pretrained(self.bert_model_path).to(device)
            mdl.eval()
            self._hf_bert = (tok, mdl)
        tok, mdl = self._hf_bert

        @torch.no_grad()
        def embed(text: str):
            enc = tok(text, return_tensors="pt", truncation=True, max_length=128).to(device)
            h = mdl(**enc).last_hidden_state[0]  # (T, D)
            return torch.nn.functional.normalize(h, dim=-1).cpu()

        p_scores, r_scores, f_scores = [], [], []
        for pred, refs in zip(predictions, references):
            ph = embed(pred)
            best = (0.0, 0.0, 0.0)
            for ref in refs:
                rh = embed(ref)
                sim = (ph @ rh.T).numpy()
                if sim.size == 0:
                    continue
                p = float(sim.max(axis=1).mean())
                r = float(sim.max(axis=0).mean())
                f = 2 * p * r / (p + r) if p + r > 0 else 0.0
                if f > best[2]:
                    best = (p, r, f)
            p_scores.append(best[0])
            r_scores.append(best[1])
            f_scores.append(best[2])
        return {
            "bert_score_precision": float(np.mean(p_scores)) if p_scores else 0.0,
            "bert_score_recall": float(np.mean(r_scores)) if r_scores else 0.0,
            "bert_score_f1": float(np.mean(f_scores)) if f_scores else 0.0,
            "bert_score_proxy": 0.0,
        }

    def _bert_score_chargram(self, predictions, references) -> Dict[str, float]:
        """Character-trigram soft-F1 proxy (no pretrained LM available offline)."""

        def grams(text: str) -> Counter:
            s = f"  {text.lower()}  "
            return Counter(s[i : i + 3] for i in range(len(s) - 2))

        p_scores, r_scores, f_scores = [], [], []
        for pred, refs in zip(predictions, references):
            best = (0.0, 0.0, 0.0)
            pg = grams(pred)
            for ref in refs:
                rg = grams(ref)
                overlap = sum((pg & rg).values())
                p = overlap / max(sum(pg.values()), 1)
                r = overlap / max(sum(rg.values()), 1)
                f = 2 * p * r / (p + r) if p + r > 0 else 0.0
                if f > best[2]:
                    best = (p, r, f)
            p_scores.append(best[0])
            r_scores.append(best[1])
            f_scores.append(best[2])
        return {
            "bert_score_precision": float(np.mean(p_scores)) if p_scores else 0.0,
            "bert_score_recall": float(np.mean(r_scores)) if r_scores else 0.0,
            "bert_score_f1": float(np.mean(f_scores)) if f_scores else 0.0,
            "bert_score_proxy": 1.0,  # marks the chargram fallback
        }

    # texts a text-tower forward (JAX: one). Every text is padded to max_caption_length and rows do not
    # interact, so batching changes only the order of the GEMMs' sums (tests/test_torch_metrics.py holds
    # P/R/F1 to JAX's within 1e-5)
    BERT_SCORE_BATCH = 32

    def _text_tower_tokens(self, texts: List[str]) -> Dict[str, np.ndarray]:
        """Each distinct text -> its kept tokens' unit-length hidden states (float32, on the host),
        from the inference module's text tower on the model's device."""
        import torch

        module = self.model._inference_module()
        tp, max_len, device = self.model.tokenizer, self.model.max_caption_length, self.model.device
        texts = list(dict.fromkeys(texts))
        out = {}
        for start in range(0, len(texts), self.BERT_SCORE_BATCH):
            chunk = texts[start : start + self.BERT_SCORE_BATCH]
            ids, mask = tp.encode_batch(chunk, max_len)
            with torch.inference_mode():
                hidden = module.encode_text(torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device))
                hidden = hidden["hidden_states"].float().cpu().numpy()
            for text, h, m in zip(chunk, hidden, mask):
                a = h[m > 0]
                out[text] = a / np.clip(np.linalg.norm(a, axis=-1, keepdims=True), 1e-8, None)
        return out

    def _bert_score_model(self, predictions, references) -> Dict[str, float]:
        """Greedy token-matching F1 over the framework text tower's embeddings."""
        tokens = self._text_tower_tokens([*predictions, *(r for refs in references for r in refs)])

        f_scores, p_scores, r_scores = [], [], []
        for pred, refs in zip(predictions, references):
            a = tokens[pred]
            best = (0.0, 0.0, 0.0)
            for ref in refs:
                sim = a @ tokens[ref].T
                if sim.size == 0:
                    continue
                p = float(sim.max(axis=1).mean())
                r = float(sim.max(axis=0).mean())
                f = 2 * p * r / (p + r) if p + r > 0 else 0.0
                if f > best[2]:
                    best = (p, r, f)
            p_scores.append(best[0])
            r_scores.append(best[1])
            f_scores.append(best[2])
        return {
            "bert_score_precision": float(np.mean(p_scores)) if p_scores else 0.0,
            "bert_score_recall": float(np.mean(r_scores)) if r_scores else 0.0,
            "bert_score_f1": float(np.mean(f_scores)) if f_scores else 0.0,
            "bert_score_proxy": 1.0,  # self-embeddings are not an independent judge
        }

    # ------------------------------------------------------------------ CLIP score

    def compute_clip_score(self, images, captions: List[str]) -> Dict[str, float]:
        """Per-pair image-text similarity (reference metrics.py:380-439).

        The reference scores with a SECOND, independent frozen CLIP ViT-B/32;
        pass such a judge as ``clip_judge`` (any contrastive model with the
        wrapper API — e.g. a separately-trained checkpoint restored via
        ``evaluation.clip_judge_checkpoint``). Without one, the model under
        evaluation scores itself — a circular metric that cannot detect
        contrastive-head collapse — and the output carries
        ``clip_score_self_judged: 1.0`` so reports can't be misread as
        independent judgments.
        """
        scorer = self.clip_judge or self.model
        if scorer is None:
            logger.warning("compute_clip_score requires a model; returning zeros")
            return {"clip_score_mean": 0.0, "clip_score_std": 0.0}
        # Score over min(len(images), len(captions)) aligned pairs — callers
        # may pass a sample batch of images for a larger caption set.
        n = min(len(images), len(captions))
        images = images[:n]
        captions = list(captions[:n])
        tok = scorer.tokenizer
        ids_mask = [tok.encode_padded(c, scorer.max_caption_length) for c in captions]
        ids = np.stack([x[0] for x in ids_mask])
        mask = np.stack([x[1] for x in ids_mask])
        sim = np.asarray(scorer.compute_similarity(images, ids, mask), np.float32)
        per_pair = np.diag(sim) * scorer.temperature * 100.0  # undo temperature, CLIP-logit scale
        return {
            "clip_score_mean": float(per_pair.mean()),
            "clip_score_std": float(per_pair.std()),
            "clip_score_self_judged": 0.0 if self.clip_judge is not None else 1.0,
        }

    # ------------------------------------------------------------------ preference

    def compute_preference_metrics(
        self,
        model_outputs: List[str],
        preferred_captions: List[str],
        rejected_captions: List[str],
        preference_scores: List[float],
    ) -> Dict[str, float]:
        pref_sims, rej_sims = [], []
        for out, pref, rej in zip(model_outputs, preferred_captions, rejected_captions):
            pref_sims.append(self._jaccard(out, pref))
            rej_sims.append(self._jaccard(out, rej))
        if not pref_sims:
            return {
                "preference_win_rate": 0.0,
                "avg_preferred_similarity": 0.0,
                "avg_rejected_similarity": 0.0,
                "preference_margin": 0.0,
                "human_preference_correlation": 0.0,
            }
        wins = sum(1 for p, r in zip(pref_sims, rej_sims) if p > r)
        corr = 0.0
        if len(preference_scores) > 1:
            margins = [p - r for p, r in zip(pref_sims, rej_sims)]
            corr = self._pearson(margins, list(preference_scores))
        return {
            "preference_win_rate": wins / len(pref_sims),
            "avg_preferred_similarity": float(np.mean(pref_sims)),
            "avg_rejected_similarity": float(np.mean(rej_sims)),
            "preference_margin": float(np.mean(pref_sims) - np.mean(rej_sims)),
            "human_preference_correlation": corr,
        }

    @staticmethod
    def _jaccard(a: str, b: str) -> float:
        ta, tb = set(word_tokenize(a)), set(word_tokenize(b))
        if not ta or not tb:
            return 0.0
        return len(ta & tb) / len(ta | tb)

    @staticmethod
    def _pearson(x: List[float], y: List[float]) -> float:
        x_arr, y_arr = np.asarray(x, np.float64), np.asarray(y, np.float64)
        if x_arr.std() == 0 or y_arr.std() == 0:
            return 0.0
        return float(np.corrcoef(x_arr, y_arr)[0, 1])

    # ------------------------------------------------------------------ diversity

    def compute_diversity_metrics(self, captions: List[str]) -> Dict[str, float]:
        if not captions:
            return {"distinct_1": 0.0, "distinct_2": 0.0, "unique_captions": 0.0}
        uni: Counter = Counter()
        bi: Counter = Counter()
        for cap in captions:
            toks = word_tokenize(cap)
            uni.update(_ngram_counts(toks, 1))
            bi.update(_ngram_counts(toks, 2))
        return {
            "distinct_1": len(uni) / max(sum(uni.values()), 1),
            "distinct_2": len(bi) / max(sum(bi.values()), 1),
            "unique_captions": len(set(captions)) / len(captions),
        }

    # ------------------------------------------------------------------ aggregate

    def compute_all_metrics(
        self,
        predictions: List[str],
        references: List[List[str]],
        images=None,
        preferred_captions: Optional[List[str]] = None,
        rejected_captions: Optional[List[str]] = None,
        preference_scores: Optional[List[float]] = None,
    ) -> Dict[str, float]:
        """Run the whole suite (reference metrics.py:714-761)."""
        references = self._listify(references)
        metrics: Dict[str, float] = {}
        metrics.update(self.compute_bleu_scores(predictions, references))
        metrics.update(self.compute_rouge_scores(predictions, references))
        metrics.update(self.compute_meteor_score(predictions, references))
        metrics["cider_score"] = self.compute_cider_score(predictions, references)
        metrics.update(self.compute_bert_score(predictions, references))
        if images is not None and self.model is not None:
            metrics.update(self.compute_clip_score(images, predictions))
        if preferred_captions and rejected_captions:
            metrics.update(
                self.compute_preference_metrics(
                    predictions, preferred_captions, rejected_captions, preference_scores or []
                )
            )
        metrics.update(self.compute_diversity_metrics(predictions))
        return metrics

    @staticmethod
    def _listify(references):
        if references and isinstance(references[0], str):
            return [[r] for r in references]
        return references
