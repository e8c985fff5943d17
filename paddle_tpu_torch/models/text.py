"""Text/sequence model zoo.

Reference configs: benchmark/paddle/rnn/rnn.py (IMDB stacked LSTM
classifier), v1_api_demo/quick_start (text classification),
v1_api_demo/sequence_tagging (bidi-RNN tagger).
"""

from __future__ import annotations

from paddle_tpu_torch import dsl
from paddle_tpu_torch.core.config import ModelConf


def stacked_lstm_classifier(
    vocab_size=30000,
    emb_dim=128,
    hidden=256,
    num_layers=2,
    num_classes=2,
    max_len=None,
) -> ModelConf:
    """IMDB LSTM benchmark config (benchmark/paddle/rnn/rnn.py:9-21:
    embedding -> N×(fc+lstmemory) -> max-pool over time -> fc softmax)."""
    with dsl.model() as g:
        ids = dsl.data("words", (1,), is_seq=True, is_ids=True)
        lbl = dsl.data("label", (1,), is_ids=True)
        h = dsl.embedding(ids, size=emb_dim, vocab_size=vocab_size)
        for i in range(num_layers):
            h = dsl.simple_lstm(h, hidden, name=f"lstm{i}")
        pooled = dsl.seq_pool(h, pool_type="max")
        out = dsl.fc(pooled, size=num_classes, name="output")
        dsl.classification_cost(out, lbl)
        g.conf.output_layer_names.append("output")
    return g.conf


def bidi_lstm_tagger(
    vocab_size=30000,
    emb_dim=64,
    hidden=128,
    num_tags=9,
) -> ModelConf:
    """Sequence tagging with a bidirectional LSTM and per-token softmax
    (v1_api_demo/sequence_tagging/rnn_crf.py without the CRF head for now)."""
    with dsl.model() as g:
        ids = dsl.data("words", (1,), is_seq=True, is_ids=True)
        tags = dsl.data("tags", (1,), is_seq=True, is_ids=True)
        emb = dsl.embedding(ids, size=emb_dim, vocab_size=vocab_size)
        h = dsl.bidirectional_lstm(emb, hidden)
        out = dsl.fc(h, size=num_tags, name="output")
        dsl.classification_cost(out, tags)
        g.conf.output_layer_names.append("output")
    return g.conf


def linear_crf_tagger(
    vocab_size=5000,
    num_tags=9,
    emb_dim=32,
    context_length=3,
) -> ModelConf:
    """Linear-chain CRF tagger (v1_api_demo/sequence_tagging/
    linear_crf.py): context-window features -> fc emissions -> crf cost,
    with crf_decoding sharing the "crfw" transition parameter for
    prediction (linear_crf.py:59-69)."""
    from paddle_tpu_torch.core.config import ParameterConf

    with dsl.model() as g:
        ids = dsl.data("words", (1,), is_seq=True, is_ids=True)
        tags = dsl.data("tags", (1,), is_seq=True, is_ids=True)
        emb = dsl.embedding(ids, size=emb_dim, vocab_size=vocab_size)
        feat = dsl.mixed(
            emb_dim * context_length,
            [dsl.context_projection(emb, context_length)],
            name="ctx_feat", bias=False,
        )
        emission = dsl.fc(feat, size=num_tags, name="emission")
        dsl.crf(emission, tags, num_tags=num_tags, name="crf_cost",
                param=ParameterConf(name="crfw"))
        dsl.crf_decoding(emission, num_tags=num_tags, name="decoded",
                         param=ParameterConf(name="crfw"))
        g.conf.output_layer_names.append("decoded")
    return g.conf


def rnn_crf_tagger(
    vocab_size=5000,
    num_tags=9,
    emb_dim=32,
    hidden=64,
) -> ModelConf:
    """Bidirectional-RNN + CRF tagger (v1_api_demo/sequence_tagging/
    rnn_crf.py): the neural emission model under the same CRF head."""
    from paddle_tpu_torch.core.config import ParameterConf

    with dsl.model() as g:
        ids = dsl.data("words", (1,), is_seq=True, is_ids=True)
        tags = dsl.data("tags", (1,), is_seq=True, is_ids=True)
        emb = dsl.embedding(ids, size=emb_dim, vocab_size=vocab_size)
        h = dsl.bidirectional_lstm(emb, hidden)
        emission = dsl.fc(h, size=num_tags, name="emission")
        dsl.crf(emission, tags, num_tags=num_tags, name="crf_cost",
                param=ParameterConf(name="crfw"))
        dsl.crf_decoding(emission, num_tags=num_tags, name="decoded",
                         param=ParameterConf(name="crfw"))
        g.conf.output_layer_names.append("decoded")
    return g.conf


def _attention_decoder_step(hidden, trg_vocab, emb_dim):
    """One decoder step: shared verbatim between the training
    recurrent_group and the generation BeamSearchDecoder so all parameter
    names line up (the reference reuses the SubModelConfig the same way:
    RecurrentGradientMachine builds both training frames and generation
    frames from one step net)."""
    from paddle_tpu_torch import dsl
    from paddle_tpu_torch.core.config import ParameterConf

    def step(trg_word, enc):
        emb = dsl.embedding(trg_word, size=emb_dim, vocab_size=trg_vocab,
                            param=ParameterConf(name="trg_emb"),
                            name="trg_emb_lookup")
        prev = dsl.memory("dec_state", size=hidden)
        # additive attention over the encoder sequence — the shared
        # helper generates the exact layer names the previous inline
        # block used, so checkpoints stay compatible
        ctx_vec = dsl.simple_attention(enc, enc, prev, name="att",
                                       size=hidden)
        s = dsl.fc(emb, prev, ctx_vec, size=hidden, act="tanh",
                   name="dec_state")
        return dsl.fc(s, size=trg_vocab, act="softmax", name="dec_prob")

    return step


def _attention_decoder_state_step(hidden, trg_vocab, emb_dim):
    """Training-time step: returns the decoder STATE only; the h->V
    softmax projection is applied OUTSIDE the scan as one batched GEMM
    (see seq2seq_attention). Same parameters, same math."""
    from paddle_tpu_torch import dsl
    from paddle_tpu_torch.core.config import ParameterConf

    def step(trg_word, enc):
        emb = dsl.embedding(trg_word, size=emb_dim, vocab_size=trg_vocab,
                            param=ParameterConf(name="trg_emb"),
                            name="trg_emb_lookup")
        prev = dsl.memory("dec_state", size=hidden)
        ctx_vec = dsl.simple_attention(enc, enc, prev, name="att",
                                       size=hidden)
        return dsl.fc(emb, prev, ctx_vec, size=hidden, act="tanh",
                      name="dec_state")

    return step


def seq2seq_attention(
    src_vocab=30000,
    trg_vocab=30000,
    emb_dim=128,
    hidden=256,
    fused_decoder=False,
) -> ModelConf:
    """Attention NMT trainer config (the quick_start seqToseq demo /
    SURVEY.md north-star NMT). Teacher forcing: decoder consumes
    `trg_in` (BOS-prefixed) and is scored against `trg_out` (EOS-suffixed).
    Encoder hidden size = `hidden` (bidi concat of hidden/2 each).

    fused_decoder=True runs the decoder recurrence as the fused layer
    (layers/fused_text.py: hoisted input/context projections, merged
    prev-GEMMs — identical math and parameter names). Built to test
    the r4 hypothesis that the step was bound on the scan's serial op
    chain; MEASURED LOSING 0.93x on a healthy chip (PERF.md round 5 —
    the hypothesis was wrong, XLA's scan lowering was not
    overhead-bound), so it ships opt-in and the bench NMT row keeps a
    permanent plain-vs-fused A/B tripwire. False (default) is the
    generic recurrent_group lowering of the step net."""
    from paddle_tpu_torch import dsl
    from paddle_tpu_torch.core.config import InputConf, ParameterConf

    # the projection is hoisted OUT of the decoder scan: the step emits
    # the decoder state, and one batched [B*T, h] @ [h, V] GEMM applies
    # dec_prob afterwards — identical math and parameter names (the
    # generation decoder still projects in-step), but the 30 MB
    # projection weight is read once per batch instead of once per
    # timestep, and the GEMM is T× larger for the MXU (measured: the
    # in-scan form ran the whole step at 16.5% analytic MFU)
    step = _attention_decoder_state_step(hidden, trg_vocab, emb_dim)
    with dsl.model() as g:
        src = dsl.data("src", (1,), is_seq=True, is_ids=True)
        trg_in = dsl.data("trg_in", (1,), is_seq=True, is_ids=True)
        trg_out = dsl.data("trg_out", (1,), is_seq=True, is_ids=True)
        src_emb = dsl.embedding(src, size=emb_dim, vocab_size=src_vocab,
                                param=ParameterConf(name="src_emb"),
                                name="src_emb_lookup")
        fwd = dsl.simple_gru(src_emb, hidden // 2, name="enc_fwd")
        bwd = dsl.simple_gru(src_emb, hidden // 2, name="enc_bwd",
                             reversed=True)
        enc = dsl.concat(fwd, bwd, name="enc")
        # backward GRU's output at t=0 has processed the whole source
        # (its scan runs right-to-left and is re-reversed to time order)
        enc_summary = dsl.first_seq(bwd, name="enc_summary")
        boot = dsl.fc(enc_summary, size=hidden, act="tanh", name="dec_boot")
        if fused_decoder:
            trg_emb = dsl.embedding(
                trg_in, size=emb_dim, vocab_size=trg_vocab,
                param=ParameterConf(name="trg_emb"),
                name="trg_emb_lookup",
            )
            states = dsl._add(
                "fused_att_decoder", [trg_emb, enc, boot],
                name="decoder", size=hidden, bias=True,
            )
        else:
            states = dsl.recurrent_group(
                step, [trg_in, dsl.StaticInput(enc)], name="decoder"
            )
        prob = dsl.fc(states, size=trg_vocab, act="softmax",
                      name="dec_prob")
        dsl.cross_entropy(prob, trg_out, name="cost")
        g.conf.output_layer_names.append("dec_prob")
    if not fused_decoder:
        # wire the decoder-state boot to the parent layer
        rg = g.conf.layer("decoder")
        for m in rg.attrs["memories"]:
            if m["layer"] == "dec_state":
                m["boot_layer"] = "dec_boot"
        rg.inputs.append(InputConf("dec_boot"))
    return g.conf


def seq2seq_attention_decoder(
    trg_vocab=30000,
    emb_dim=128,
    hidden=256,
    bos_id=0,
    eos_id=1,
    beam_size=4,
    max_length=50,
    tokens_per_dispatch=1,
):
    """Generation decoder sharing parameter names with
    seq2seq_attention (use the trained params dict directly).
    `tokens_per_dispatch=K` advances K steps per compiled dispatch
    (ISSUE 18) — bit-identical output, chain depth ceil(max_length/K)."""
    from paddle_tpu_torch.beam_search import BeamSearchDecoder

    step = _attention_decoder_step(hidden, trg_vocab, emb_dim)
    return BeamSearchDecoder(step, n_static=1, bos_id=bos_id, eos_id=eos_id,
                             beam_size=beam_size, max_length=max_length,
                             tokens_per_dispatch=tokens_per_dispatch)


def hierarchical_lstm_classifier(
    vocab_size=1000,
    emb_dim=16,
    hidden=32,
    num_classes=2,
) -> ModelConf:
    """Two-level document classifier over NESTED sequences (words
    grouped into sentences): the outer recurrent group walks sentences,
    its step encodes one sentence (embedding + rnn, last state) and
    chains a document memory across sentences — the
    RecurrentGradientMachine hierarchical mode
    (gserver/gradientmachines/RecurrentGradientMachine.cpp nested
    sequences, parameter/Argument.h:84-93; config analogue of the
    reference's gserver/tests/sequence_nest_rnn.conf)."""
    with dsl.model() as g:
        words = dsl.data("words", (1,), is_seq=True, is_ids=True,
                         has_subseq=True)
        lbl = dsl.data("label", (1,), is_ids=True)

        def sentence_step(w_sub):
            doc_prev = dsl.memory("doc", size=hidden)
            emb = dsl.embedding(w_sub, size=emb_dim,
                                vocab_size=vocab_size, name="word_emb")
            enc = dsl.recurrent(
                dsl.fc(emb, size=hidden, bias=True, name="sent_proj"),
                size=hidden, act="tanh", name="sent_rnn",
            )
            last = dsl.last_seq(enc, name="sent_vec")
            return dsl.mixed(
                hidden,
                [(last, "identity"), (doc_prev, "full_matrix")],
                act="tanh", bias=False, name="doc",
            )

        sent_seq = dsl.recurrent_group(sentence_step, [words],
                                       name="doc_enc")
        pooled = dsl.last_seq(sent_seq, name="doc_vec")
        out = dsl.fc(pooled, size=num_classes, name="output")
        dsl.classification_cost(out, lbl)
        g.conf.output_layer_names.append("output")
    return g.conf
