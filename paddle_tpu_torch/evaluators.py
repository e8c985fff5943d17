"""Evaluators — streaming task metrics, on the host in numpy.

The JAX package's `evaluators.py` on the port (the reference's
paddle/gserver/evaluators/Evaluator.cpp:40-1346: classification_error,
sum, column_sum, precision_recall, pnpair, rankauc, the printers ...)
with the same contract: `start()`, `add_batch(outs, feed)` per batch,
`result()`. `outs` and `feed` map layer names to Args whose fields are
torch tensors (on any device) or numpy arrays; each is read to the host
once and reduced in numpy, in the dtypes the JAX evaluators reduce in,
so both packages give the same results on the same numbers. Every type
is in `core/registry.py::EVALUATORS`; `create_evaluator(conf)` builds
one from its config dict.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.registry import EVALUATORS


def _np(x):
    """A tensor (any device) or array-like as a numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _mask(a) -> np.ndarray:
    """[B, T] float32 mask of a sequence Arg: 1.0 where a step is real
    (the JAX Arg.mask())."""
    lens = _np(a.seq_lens)
    v = a.value if a.value is not None else a.ids
    t = v.shape[1]
    return (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)


class Evaluator:
    """conf: {"name", "type", "input", "label", ...} — evaluator configs
    reference output/label layers by name."""

    def __init__(self, conf: dict):
        self.conf = conf
        self.name = conf.get("name", conf["type"])
        self.start()

    def start(self):
        raise NotImplementedError

    def add_batch(self, outs: dict, feed: dict):
        raise NotImplementedError

    def result(self):
        raise NotImplementedError

    # helpers
    def _get(self, outs, feed, key):
        name = self.conf[key]
        if name in outs:
            return outs[name]
        return feed[name]

    @staticmethod
    def _masked_pairs(pred: Arg, label: Arg):
        """Return flat (pred_rows, label_ids, weight) with padding dropped
        via mask weights (sequence-aware, like the reference's
        sequence-level eval accounting)."""
        p = _np(pred.value)
        l = _np(label.ids if label.ids is not None else label.value)
        if pred.is_seq:
            if l.ndim >= 2 and l.shape[1] != p.shape[1]:
                # independent padding (a per-subsequence prediction vs
                # the label's own bucket) — align to the prediction's
                # time axis; padding is masked below either way
                tp = p.shape[1]
                if l.shape[1] > tp:
                    l = l[:, :tp]
                else:
                    l = np.pad(l, ((0, 0), (0, tp - l.shape[1])))
            m = _mask(pred)
            p = p.reshape(-1, p.shape[-1])
            l = l.reshape(-1)
            w = m.reshape(-1)
        else:
            p = p.reshape(p.shape[0], -1)
            l = l.reshape(-1)
            w = np.ones(p.shape[0])
        return p, l, w


@EVALUATORS.register("classification_error")
class ClassificationErrorEvaluator(Evaluator):
    """(Evaluator.cpp:172 ClassificationErrorEvaluator). conf "top_k"
    (the reference's classification_threshold/num_results family):
    a prediction counts as correct when the label is among the k
    highest-scoring classes (default 1)."""

    def start(self):
        self.wrong = 0.0
        self.total = 0.0

    def add_batch(self, outs, feed):
        pred = self._get(outs, feed, "input")
        label = self._get(outs, feed, "label")
        k = int(self.conf.get("top_k", 1))
        p, l, w = self._masked_pairs(pred, label)
        if k <= 1:
            hit = (np.argmax(p, axis=-1) == l).astype(np.float64)
        else:
            topk = np.argpartition(-p, min(k, p.shape[-1] - 1), axis=-1)[
                :, :k
            ]
            hit = (topk == l[:, None]).any(axis=-1).astype(np.float64)
        self.wrong += float(((1.0 - hit) * w).sum())
        self.total += float(w.sum())

    def result(self):
        return self.wrong / max(self.total, 1.0)


@EVALUATORS.register("sum")
class SumEvaluator(Evaluator):
    """(Evaluator.cpp:40 SumEvaluator)."""

    def start(self):
        self.sum = 0.0
        self.total = 0.0

    def add_batch(self, outs, feed):
        x = self._get(outs, feed, "input")
        v = _np(x.value)
        if x.is_seq:
            m = _mask(x).reshape(v.shape[:2] + (1,) * (v.ndim - 2))
            v = v * m
            self.total += float(_np(x.seq_lens).sum())
        else:
            self.total += v.shape[0]
        self.sum += float(v.sum())

    def result(self):
        return self.sum / max(self.total, 1.0)


@EVALUATORS.register("column_sum")
class ColumnSumEvaluator(Evaluator):
    """(Evaluator.cpp:503 ColumnSumEvaluator)."""

    def start(self):
        self.sum = None
        self.total = 0.0

    def add_batch(self, outs, feed):
        x = self._get(outs, feed, "input")
        v = _np(x.value).reshape(-1, _np(x.value).shape[-1])
        s = v.sum(axis=0)
        self.sum = s if self.sum is None else self.sum + s
        self.total += v.shape[0]

    def result(self):
        return self.sum / max(self.total, 1.0)


@EVALUATORS.register("precision_recall")
class PrecisionRecallEvaluator(Evaluator):
    """(Evaluator.cpp:862 PrecisionRecallEvaluator). Multi-class
    macro-averaged; conf may set "positive_label" for binary."""

    def start(self):
        self.tp = {}
        self.fp = {}
        self.fn = {}

    def add_batch(self, outs, feed):
        pred = self._get(outs, feed, "input")
        label = self._get(outs, feed, "label")
        p, l, w = self._masked_pairs(pred, label)
        yhat = np.argmax(p, axis=-1)
        for c in np.unique(np.concatenate([yhat, l])):
            c = int(c)
            real = w > 0
            self.tp[c] = self.tp.get(c, 0) + int(((yhat == c) & (l == c) & real).sum())
            self.fp[c] = self.fp.get(c, 0) + int(((yhat == c) & (l != c) & real).sum())
            self.fn[c] = self.fn.get(c, 0) + int(((yhat != c) & (l == c) & real).sum())

    def result(self):
        pos = self.conf.get("positive_label")
        classes = [pos] if pos is not None else sorted(self.tp)
        precs, recs = [], []
        for c in classes:
            tp, fp, fn = self.tp.get(c, 0), self.fp.get(c, 0), self.fn.get(c, 0)
            precs.append(tp / max(tp + fp, 1))
            recs.append(tp / max(tp + fn, 1))
        p, r = float(np.mean(precs)), float(np.mean(recs))
        f1 = 2 * p * r / max(p + r, 1e-12)
        return {"precision": p, "recall": r, "F1": f1}


@EVALUATORS.register("pnpair")
class PnpairEvaluator(Evaluator):
    """Positive-negative pair ordering ratio (Evaluator.cpp:995
    PnpairEvaluator): for query-grouped (score, label) pairs, counts
    correctly-ordered pos>neg pairs. conf: input (score), label, query_id."""

    def start(self):
        self.pairs = []  # (qid, score, label)

    def add_batch(self, outs, feed):
        score = self._get(outs, feed, "input")
        label = self._get(outs, feed, "label")
        qid = self._get(outs, feed, "query_id")
        s = _np(score.value).reshape(-1)
        l = _np(label.ids).reshape(-1)
        q = _np(qid.ids).reshape(-1)
        self.pairs.extend(zip(q.tolist(), s.tolist(), l.tolist()))

    def result(self):
        from collections import defaultdict

        by_q = defaultdict(list)
        for q, s, l in self.pairs:
            by_q[q].append((s, l))
        good = bad = 0.0
        for items in by_q.values():
            for i in range(len(items)):
                for j in range(i + 1, len(items)):
                    (si, li), (sj, lj) = items[i], items[j]
                    if li == lj:
                        continue
                    hi, lo = (si, sj) if li > lj else (sj, si)
                    if hi > lo:
                        good += 1
                    elif hi < lo:
                        bad += 1
                    else:
                        good += 0.5
                        bad += 0.5
        return good / max(bad, 1e-12)


@EVALUATORS.register("rankauc")
class AucEvaluator(Evaluator):
    """ROC AUC on binary scores (Evaluator.cpp:584 AucEvaluator),
    histogram-bucketed like the reference."""

    BINS = 4096

    def start(self):
        self.pos = np.zeros(self.BINS)
        self.neg = np.zeros(self.BINS)

    def add_batch(self, outs, feed):
        score = self._get(outs, feed, "input")
        label = self._get(outs, feed, "label")
        s = _np(score.value)
        s = s[..., -1] if s.shape[-1] > 1 else s.reshape(-1)
        s = np.clip(s.reshape(-1), 0.0, 1.0)
        l = _np(label.ids).reshape(-1)
        idx = np.minimum((s * self.BINS).astype(np.int64), self.BINS - 1)
        np.add.at(self.pos, idx[l == 1], 1)
        np.add.at(self.neg, idx[l == 0], 1)

    def result(self):
        # sum over thresholds of trapezoid areas, descending score
        pos_c = np.cumsum(self.pos[::-1])
        neg_c = np.cumsum(self.neg[::-1])
        tot_pos, tot_neg = pos_c[-1], neg_c[-1]
        if tot_pos == 0 or tot_neg == 0:
            return 0.5
        tpr = pos_c / tot_pos
        fpr = neg_c / tot_neg
        return float(np.trapezoid(tpr, fpr))


@EVALUATORS.register("seq_classification_error")
class SequenceClassificationErrorEvaluator(Evaluator):
    """Sequence-level classification error (Evaluator.cpp:135
    SequenceClassificationErrorEvaluator): a sequence counts as wrong if
    ANY frame in it is wrong."""

    def start(self):
        self.wrong = 0.0
        self.total = 0.0

    def add_batch(self, outs, feed):
        pred = self._get(outs, feed, "input")
        label = self._get(outs, feed, "label")
        p = _np(pred.value)  # [B,T,C]
        l = _np(label.ids if label.ids is not None else label.value)
        l = l.reshape(p.shape[0], p.shape[1])
        m = _mask(pred)
        frame_err = (np.argmax(p, axis=-1) != l) & (m > 0)
        self.wrong += float((frame_err.any(axis=-1)).sum())
        self.total += p.shape[0]

    def result(self):
        return self.wrong / max(self.total, 1.0)


@EVALUATORS.register("chunk")
class ChunkEvaluator(Evaluator):
    """IOB/IOE/IOBES/plain chunking F1 (ChunkEvaluator.cpp). A chunk is
    correct iff begin, end, and type all match. Label encoding (the
    reference's): tag = label % num_tag_types, type = label // num_tag_types,
    with the "other" type == num_chunk_types. conf: chunk_scheme,
    num_chunk_types, excluded_chunk_types, input (decoded ids), label."""

    SCHEMES = {
        # scheme: (num_tag_types, begin, inside, end, single)
        "plain": (1, -1, -1, -1, -1),
        "IOB": (2, 0, 1, -1, -1),
        "IOE": (2, -1, 0, 1, -1),
        "IOBES": (4, 0, 1, 2, 3),
    }

    def start(self):
        scheme = self.conf.get("chunk_scheme", "IOB")
        (
            self.num_tag,
            self.tag_b,
            self.tag_i,
            self.tag_e,
            self.tag_s,
        ) = self.SCHEMES[scheme]
        self.num_chunk_types = self.conf["num_chunk_types"]
        self.other = self.num_chunk_types
        self.excluded = set(self.conf.get("excluded_chunk_types", ()))
        self.n_label = 0
        self.n_output = 0
        self.n_correct = 0

    # -- chunk boundary rules (ChunkEvaluator.cpp:225-245), data not code --
    def _is_end(self, ptag, ptype, tag, typ):
        if ptype == self.other:
            return False
        if typ == self.other or typ != ptype:
            return True
        if ptag in (self.tag_b, self.tag_i) and ptag >= 0:
            return tag in (self.tag_b, self.tag_s) and tag >= 0
        return ptag in (self.tag_e, self.tag_s) and ptag >= 0

    def _is_begin(self, ptag, ptype, tag, typ):
        if ptype == self.other:
            return typ != self.other
        if typ == self.other:
            return False
        if typ != ptype:
            return True
        if tag == self.tag_b or tag == self.tag_s:
            return True
        if tag in (self.tag_i, self.tag_e) and tag >= 0:
            return ptag in (self.tag_e, self.tag_s) and ptag >= 0
        return False

    def _segments(self, labels):
        segs, in_chunk, start = [], False, 0
        tag, typ = -1, self.other
        for i, lab in enumerate(labels):
            ptag, ptype = tag, typ
            tag, typ = int(lab) % self.num_tag, int(lab) // self.num_tag
            if in_chunk and self._is_end(ptag, ptype, tag, typ):
                segs.append((start, i - 1, ptype))
                in_chunk = False
            if self._is_begin(ptag, ptype, tag, typ):
                start, in_chunk = i, True
        if in_chunk:
            segs.append((start, len(labels) - 1, typ))
        return segs

    def _eval_seq(self, out, lab):
        o, l = self._segments(out), self._segments(lab)
        correct = set(o) & set(l)
        self.n_correct += sum(1 for s in correct if s[2] not in self.excluded)
        self.n_output += sum(1 for s in o if s[2] not in self.excluded)
        self.n_label += sum(1 for s in l if s[2] not in self.excluded)

    def add_batch(self, outs, feed):
        pred = self._get(outs, feed, "input")
        label = self._get(outs, feed, "label")
        p = _np(pred.ids if pred.ids is not None else pred.value)
        p = p.reshape(p.shape[0], -1)
        l = _np(label.ids).reshape(p.shape[0], -1)
        lens = _np(label.seq_lens)
        for b in range(p.shape[0]):
            n = int(lens[b])
            self._eval_seq(p[b, :n], l[b, :n])

    def result(self):
        prec = self.n_correct / max(self.n_output, 1)
        rec = self.n_correct / max(self.n_label, 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return {"precision": prec, "recall": rec, "F1": f1}


def _edit_distance(ref, hyp):
    """Levenshtein with (sub, del, ins) backtrace counts
    (CTCErrorEvaluator.cpp stringAlignment)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m, 0, 0, m
    if m == 0:
        return n, 0, n, 0
    ref_a = _np(ref)
    hyp_a = _np(hyp)
    d = np.zeros((n + 1, m + 1), np.int64)
    d[:, 0] = np.arange(n + 1)
    d[0, :] = np.arange(m + 1)
    # vectorized per row; the insertion prefix dependency
    # r[j] = min(best[j], r[j-1]+1) solved with the minimum.accumulate
    # trick on s[j] = r[j] - j
    col = np.arange(1, m + 1)
    for i in range(1, n + 1):
        cost = (hyp_a != ref_a[i - 1]).astype(np.int64)
        best = np.minimum(d[i - 1, :-1] + cost, d[i - 1, 1:] + 1)
        s = np.minimum.accumulate(np.concatenate(([i], best - col)))
        d[i, 1:] = s[1:] + col
        d[i, 0] = i
    subs = dels = ins = 0
    i, j = n, m
    while i and j:
        if d[i, j] == d[i - 1, j - 1] and ref[i - 1] == hyp[j - 1]:
            i, j = i - 1, j - 1
        elif d[i, j] == d[i - 1, j - 1] + 1:
            subs += 1
            i, j = i - 1, j - 1
        elif d[i, j] == d[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    dels += i
    ins += j
    return int(d[n, m]), subs, dels, ins


@EVALUATORS.register("ctc_edit_distance")
class CTCErrorEvaluator(Evaluator):
    """Sequence edit-distance error for CTC models (CTCErrorEvaluator.cpp):
    per sequence, best-path decode (argmax per frame, collapse — reuses
    ops.ctc.ctc_greedy_decode so train-time and eval-time decode agree),
    then length-normalized Levenshtein vs the label string. conf "blank"
    defaults to 0 like this framework's ctc layer (the reference hardcodes
    blank = C-1; set blank=C-1 in conf for that convention). result: dict
    with avg normalized edit distance plus insertion/deletion/substitution
    rates and whole-seq error rate."""

    def start(self):
        self.total_err = 0.0
        self.ins = self.dels = self.subs = 0.0
        self.seq_err = 0
        self.n_seq = 0

    def add_batch(self, outs, feed):
        from paddle_tpu_torch.ops.ctc import ctc_greedy_decode

        act = self._get(outs, feed, "input")
        label = self._get(outs, feed, "label")
        a = _np(act.value)  # [B,T,C]
        alens = _np(act.seq_lens)
        l = _np(label.ids).reshape(a.shape[0], -1)
        llens = _np(label.seq_lens)
        blank = self.conf.get("blank", 0)
        paths, plens = ctc_greedy_decode(
            torch.from_numpy(a), torch.from_numpy(alens.astype(np.int32)),
            blank=blank,
        )
        paths, plens = _np(paths), _np(plens)
        for b in range(a.shape[0]):
            hyp = paths[b, : int(plens[b])].tolist()
            ref = l[b, : int(llens[b])].tolist()
            dist, subs, dels, ins = _edit_distance(ref, hyp)
            mx = max(len(ref), len(hyp), 1)
            self.total_err += dist / mx
            self.subs += subs / mx
            self.dels += dels / mx
            self.ins += ins / mx
            self.seq_err += int(dist != 0)
            self.n_seq += 1

    def result(self):
        n = max(self.n_seq, 1)
        return {
            "edit_distance": self.total_err / n,
            "substitution": self.subs / n,
            "deletion": self.dels / n,
            "insertion": self.ins / n,
            "seq_error": self.seq_err / n,
        }


class _PrinterBase(Evaluator):
    """Printers (Evaluator.cpp:1009-1346) log tensors for debugging; they
    accumulate nothing. Output goes through `emit` (logging by default,
    or a user-supplied `printer` callable / `result_file` in conf)."""

    def start(self):
        self._fh = None

    def emit(self, line: str):
        # stream to the result file (no unbounded in-memory accumulation)
        path = self.conf.get("result_file")
        if path:
            if self._fh is None:
                self._fh = open(path, "a")
            self._fh.write(line + "\n")
        f = self.conf.get("printer")
        if f is not None:
            f(line)
        elif not path:
            import logging

            logging.getLogger("paddle_tpu_torch.eval").info("%s: %s", self.name, line)

    def result(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        return None


@EVALUATORS.register("value_printer")
class ValuePrinter(_PrinterBase):
    def add_batch(self, outs, feed):
        x = self._get(outs, feed, "input")
        v = x.value if x.value is not None else x.ids
        self.emit(np.array2string(_np(v), threshold=64))


@EVALUATORS.register("gradient_printer")
class GradientPrinter(_PrinterBase):
    """The reference prints a layer's output gradient. Gradients here are
    functional (autograd over the net): an output gradient is printed
    where the outputs hold it as `outs["<name>@GRAD"]` (a grad tap),
    else the layer's value statistics are."""

    def add_batch(self, outs, feed):
        g = outs.get(self.conf["input"] + "@GRAD")
        if g is not None:
            self.emit(np.array2string(_np(g.value), threshold=64))
        else:
            x = self._get(outs, feed, "input")
            self.emit(
                "[no grad tap] value mean=%.6g std=%.6g"
                % (np.mean(_np(x.value)), np.std(_np(x.value)))
            )


@EVALUATORS.register("max_id_printer")
class MaxIdPrinter(_PrinterBase):
    def add_batch(self, outs, feed):
        x = self._get(outs, feed, "input")
        self.emit(str(np.argmax(_np(x.value), axis=-1).tolist()))


@EVALUATORS.register("max_frame_printer")
class MaxFramePrinter(_PrinterBase):
    """Prints, per sequence, the frame with the max value."""

    def add_batch(self, outs, feed):
        x = self._get(outs, feed, "input")
        v = _np(x.value)
        m = _mask(x)
        score = (v.max(axis=-1) * m) + (m - 1) * 1e30
        self.emit(str(np.argmax(score, axis=-1).tolist()))


@EVALUATORS.register("seq_text_printer")
class SequenceTextPrinter(_PrinterBase):
    """Prints id sequences as text (Evaluator.cpp:1181). conf: input,
    optional dict_file (one token per line) mapping ids to words."""

    def start(self):
        super().start()
        self.vocab = None
        df = self.conf.get("dict_file")
        if df:
            with open(df) as fh:
                self.vocab = [ln.rstrip("\n") for ln in fh]

    def add_batch(self, outs, feed):
        x = self._get(outs, feed, "input")
        ids = _np(x.ids if x.ids is not None else x.value)
        ids = ids.reshape(ids.shape[0], -1)
        lens = (
            _np(x.seq_lens)
            if x.seq_lens is not None
            else np.full(ids.shape[0], ids.shape[1])
        )
        for b in range(ids.shape[0]):
            seq = ids[b, : int(lens[b])].tolist()
            if self.vocab:
                self.emit(" ".join(self.vocab[i] for i in seq))
            else:
                self.emit(" ".join(str(i) for i in seq))


@EVALUATORS.register("classification_error_printer")
class ClassificationErrorPrinter(_PrinterBase):
    def add_batch(self, outs, feed):
        pred = self._get(outs, feed, "input")
        label = self._get(outs, feed, "label")
        p, l, w = self._masked_pairs(pred, label)
        err = ((np.argmax(p, axis=-1) != l) & (w > 0)).astype(np.int64)
        self.emit(str(err.tolist()))


def create_evaluator(conf: dict) -> Evaluator:
    return EVALUATORS.get(conf["type"])(conf)


@EVALUATORS.register("detection_map")
class DetectionMAPEvaluator(Evaluator):
    """Mean average precision for SSD detection
    (gserver/evaluators/DetectionMAPEvaluator.cpp).

    conf: input = detection_output layer name (rows [label, score, box4]
    per image, score==0 padding), label = gt boxes Arg name ([B,G,4] with
    seq_lens), label_ids = gt label Arg name ([B,G] ids); optional
    overlap_threshold (0.5), ap_type "11point"|"integral",
    background_id (0). Accumulates per-class (score, tp) pairs and
    per-class gt counts on host; result() sweeps each class's detections
    by descending score, greedy-matching each to an unused gt with
    IoU > threshold (true positive) else false positive.
    """

    def start(self):
        from collections import defaultdict

        self.dets = defaultdict(list)  # cls -> [(score, tp)]
        self.n_gt = defaultdict(int)  # cls -> count

    @staticmethod
    def _iou(box, boxes):
        x1 = np.maximum(box[0], boxes[:, 0])
        y1 = np.maximum(box[1], boxes[:, 1])
        x2 = np.minimum(box[2], boxes[:, 2])
        y2 = np.minimum(box[3], boxes[:, 3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        a = (box[2] - box[0]) * (box[3] - box[1])
        b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        return inter / np.maximum(a + b - inter, 1e-10)

    def add_batch(self, outs, feed):
        det = self._get(outs, feed, "input")
        gt_box = self._get(outs, feed, "label")
        gt_label = self._get(outs, feed, "label_ids")
        thr = self.conf.get("overlap_threshold", 0.5)
        d = _np(det.value)
        d = d.reshape(d.shape[0], -1, 6)
        boxes = _np(gt_box.value)
        labels = _np(gt_label.ids)
        lens = _np(gt_box.seq_lens)
        for b in range(d.shape[0]):
            g_box = boxes[b, : lens[b]]
            g_lab = labels[b, : lens[b]]
            for c in np.unique(g_lab):
                self.n_gt[int(c)] += int((g_lab == c).sum())
            rows = d[b]
            rows = rows[rows[:, 1] > 0]
            used = np.zeros(len(g_box), bool)
            for cls, score, *box in rows[np.argsort(-rows[:, 1])]:
                # match to the overall best-overlap gt of this class; a
                # duplicate detection of an already-claimed gt is a FALSE
                # positive (DetectionMAPEvaluator.cpp), not re-matched
                cand = np.where(g_lab == int(cls))[0]
                tp = 0
                if len(cand):
                    ious = self._iou(_np(box), g_box[cand])
                    j = int(np.argmax(ious))
                    if ious[j] > thr and not used[cand[j]]:
                        used[cand[j]] = True
                        tp = 1
                self.dets[int(cls)].append((float(score), tp))

    def result(self):
        ap_type = self.conf.get("ap_type", "11point")
        aps = []
        for c, n in self.n_gt.items():
            if n == 0:
                continue
            pairs = sorted(self.dets.get(c, []), reverse=True)
            tp = np.cumsum([t for _, t in pairs]) if pairs else np.array([])
            if len(tp) == 0:
                aps.append(0.0)
                continue
            fp = np.arange(1, len(tp) + 1) - tp
            rec = tp / n
            prec = tp / np.maximum(tp + fp, 1e-10)
            if ap_type == "11point":
                ap = float(
                    np.mean(
                        [
                            prec[rec >= t].max() if (rec >= t).any() else 0.0
                            for t in np.linspace(0, 1, 11)
                        ]
                    )
                )
            else:  # integral
                ap = float(
                    np.sum(
                        (rec - np.concatenate(([0.0], rec[:-1]))) * prec
                    )
                )
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0
