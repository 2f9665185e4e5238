/* Skip-gram negative-sampling training hot loop.
 *
 * Faithful stand-in for the reference's native hot op: DL4J's
 * SkipGram.java:215-272 dispatches an AggregateSkipGram whose
 * implementation is a libnd4j C++ kernel doing exactly this per
 * (center, context) pair: dot(syn0[w], syn1neg[c]) -> sigmoid ->
 * gradient axpy on both tables, negatives drawn from the unigram^0.75
 * table, linear learning-rate decay.  Used two ways:
 *   1. as the measured LOCAL BASELINE of what the reference's native
 *      path achieves on this host's CPU (profiles/w2v_baseline.py);
 *   2. as an optional native trainer behind Word2Vec (the same
 *      helper-SPI pattern as the cuDNN helpers / native CSV loader:
 *      an accelerator, never a hard dependency).
 *
 * Single-threaded: this image exposes one CPU core (nproc=1), so the
 * reference's HogWild thread fan-out has no parallelism to exploit
 * here; the kernel is the per-thread inner loop either way.
 */

#include <math.h>
#include <stddef.h>

#define MAX_EXP 6.0f
#define EXP_TABLE_SIZE 1024

static float exp_table[EXP_TABLE_SIZE];
static int exp_table_ready = 0;

static void build_exp_table(void) {
    for (int i = 0; i < EXP_TABLE_SIZE; i++) {
        float x = ((float)i / EXP_TABLE_SIZE * 2.0f - 1.0f) * MAX_EXP;
        float e = expf(x);
        exp_table[i] = e / (e + 1.0f);  /* sigmoid */
    }
    exp_table_ready = 1;
}

static inline float fast_sigmoid(float x) {
    if (x >= MAX_EXP) return 1.0f;
    if (x <= -MAX_EXP) return 0.0f;
    int idx = (int)((x + MAX_EXP) * (EXP_TABLE_SIZE / (2.0f * MAX_EXP)));
    if (idx < 0) idx = 0;
    if (idx >= EXP_TABLE_SIZE) idx = EXP_TABLE_SIZE - 1;
    return exp_table[idx];
}

static inline unsigned long long next_rand(unsigned long long *s) {
    *s = *s * 25214903917ULL + 11ULL; /* the classic word2vec LCG */
    return *s;
}

/* Train over a flat corpus of word indices with sentence boundaries
 * marked by -1.  Returns the number of (center, context) pairs trained.
 *
 * syn0, syn1neg: [vocab, layer] row-major float32, updated in place.
 * table: unigram^0.75 negative-sampling table of word indices.
 * alpha decays linearly to min_alpha over total_words * epochs. */
long skipgram_train(float *syn0, float *syn1neg, long vocab, long layer,
                    const int *corpus, long corpus_len,
                    const int *table, long table_len,
                    int window, int negative,
                    float alpha, float min_alpha, int epochs,
                    unsigned long long seed) {
    (void)vocab;
    if (!exp_table_ready) build_exp_table();
    if (window < 1) return -1; /* %0 in the reduced-window draw = SIGFPE */
    long pairs = 0;
    long total = (long)corpus_len * epochs;
    long seen = 0;
    unsigned long long rng = seed ? seed : 1ULL;
    float neu1e[4096]; /* layer <= 4096 */
    if (layer > 4096) return -1;

    for (int ep = 0; ep < epochs; ep++) {
        long sent_start = 0;
        for (long pos = 0; pos < corpus_len; pos++) {
            int w = corpus[pos];
            if (w < 0) { sent_start = pos + 1; continue; }
            seen++;
            float lr = alpha * (1.0f - (float)seen / (float)(total + 1));
            if (lr < min_alpha) lr = min_alpha;
            /* reduced window, word2vec convention */
            int b = (int)(next_rand(&rng) % (unsigned)window);
            for (long cpos = pos - window + b; cpos <= pos + window - b;
                 cpos++) {
                if (cpos == pos || cpos < sent_start || cpos >= corpus_len)
                    continue;
                int c = corpus[cpos];
                if (c < 0) break; /* sentence boundary */
                /* train pair (center=w predicts context=c):
                 * rows: syn0[c] is the input vector in the reference's
                 * convention (context predicts center across the window
                 * loop — symmetric over the corpus either way) */
                const long lw = (long)w * layer;
                float *in = syn0 + (long)c * layer;
                for (long k = 0; k < layer; k++) neu1e[k] = 0.0f;
                for (int d = 0; d < negative + 1; d++) {
                    long target;
                    float label;
                    if (d == 0) {
                        target = w;
                        label = 1.0f;
                    } else {
                        target = table[(next_rand(&rng) >> 16) % table_len];
                        if (target == w) continue;
                        label = 0.0f;
                    }
                    float *out = syn1neg + target * layer;
                    float dot = 0.0f;
                    for (long k = 0; k < layer; k++) dot += in[k] * out[k];
                    float g = (label - fast_sigmoid(dot)) * lr;
                    for (long k = 0; k < layer; k++) {
                        neu1e[k] += g * out[k];
                        out[k] += g * in[k];
                    }
                }
                for (long k = 0; k < layer; k++) in[k] += neu1e[k];
                pairs++;
                (void)lw;
            }
        }
    }
    return pairs;
}

/* Generic negative-sampling pair trainer: rows[i] (input vector in syn0)
 * predicts targets[i] (output row in syn1neg), negatives from the
 * unigram table.  The DBOW hot loop (reference: sequence/DBOW.java — a
 * document's label row predicts every document word) is exactly this
 * with rows = label per position; also reusable for any pre-generated
 * pair stream.  Same LR decay / sigmoid table / LCG as skipgram_train. */
long pairs_train(float *syn0, float *syn1neg, long layer,
                 const int *rows, const int *targets, long n_pairs,
                 const int *table, long table_len,
                 int negative, float alpha, float min_alpha, int epochs,
                 unsigned long long seed) {
    if (!exp_table_ready) build_exp_table();
    if (layer > 4096) return -1;
    long done = 0;
    long total = n_pairs * (long)epochs;
    unsigned long long rng = seed ? seed : 1ULL;
    float neu1e[4096];

    for (int ep = 0; ep < epochs; ep++) {
        for (long i = 0; i < n_pairs; i++) {
            int r = rows[i];
            int w = targets[i];
            if (r < 0 || w < 0) continue;
            done++;
            float lr = alpha * (1.0f - (float)done / (float)(total + 1));
            if (lr < min_alpha) lr = min_alpha;
            float *in = syn0 + (long)r * layer;
            for (long k = 0; k < layer; k++) neu1e[k] = 0.0f;
            for (int d = 0; d < negative + 1; d++) {
                long target;
                float label;
                if (d == 0) {
                    target = w;
                    label = 1.0f;
                } else {
                    target = table[(next_rand(&rng) >> 16) % table_len];
                    if (target == w) continue;
                    label = 0.0f;
                }
                float *out = syn1neg + target * layer;
                float dot = 0.0f;
                for (long k = 0; k < layer; k++) dot += in[k] * out[k];
                float g = (label - fast_sigmoid(dot)) * lr;
                for (long k = 0; k < layer; k++) {
                    neu1e[k] += g * out[k];
                    out[k] += g * in[k];
                }
            }
            for (long k = 0; k < layer; k++) in[k] += neu1e[k];
        }
    }
    return done;
}

/* CBOW / DM hot loop (reference: impl/elements/CBOW.java and
 * sequence/DM.java — DM is CBOW with the document's label row prepended
 * to every context window):  the averaged context (plus optional label
 * row) predicts the center word through negative sampling; the gradient
 * is distributed back to every contributing row.  labels may be NULL
 * (plain CBOW) or hold one syn0 row id per corpus position (-1 = none).
 * Same LR decay / sigmoid table / LCG as skipgram_train. */
long cbow_train(float *syn0, float *syn1neg, long layer,
                const int *corpus, long corpus_len,
                const int *labels,
                const int *table, long table_len,
                int window, int negative,
                float alpha, float min_alpha, int epochs,
                unsigned long long seed) {
    if (!exp_table_ready) build_exp_table();
    if (layer > 4096) return -1;
    if (window < 1) return -1; /* %0 in the reduced-window draw = SIGFPE */
    long trained = 0;
    long total = (long)corpus_len * epochs;
    long seen = 0;
    unsigned long long rng = seed ? seed : 1ULL;
    float neu1[4096], neu1e[4096];
    long ctx[2 * 64 + 1]; /* window <= 64 plus the optional label row */
    if (window > 64) return -1;

    for (int ep = 0; ep < epochs; ep++) {
        long sent_start = 0;
        for (long pos = 0; pos < corpus_len; pos++) {
            int w = corpus[pos];
            if (w < 0) { sent_start = pos + 1; continue; }
            seen++;
            float lr = alpha * (1.0f - (float)seen / (float)(total + 1));
            if (lr < min_alpha) lr = min_alpha;
            int b = (int)(next_rand(&rng) % (unsigned)window);
            long n_ctx = 0;
            for (long cpos = pos - window + b; cpos <= pos + window - b;
                 cpos++) {
                if (cpos == pos || cpos < sent_start || cpos >= corpus_len)
                    continue;
                int c = corpus[cpos];
                if (c < 0) break;
                ctx[n_ctx++] = c;
            }
            if (labels && labels[pos] >= 0)
                ctx[n_ctx++] = labels[pos];
            if (n_ctx == 0) continue;
            float inv = 1.0f / (float)n_ctx;
            for (long k = 0; k < layer; k++) {
                float acc = 0.0f;
                for (long j = 0; j < n_ctx; j++)
                    acc += syn0[ctx[j] * layer + k];
                neu1[k] = acc * inv;
                neu1e[k] = 0.0f;
            }
            for (int d = 0; d < negative + 1; d++) {
                long target;
                float label;
                if (d == 0) {
                    target = w;
                    label = 1.0f;
                } else {
                    target = table[(next_rand(&rng) >> 16) % table_len];
                    if (target == w) continue;
                    label = 0.0f;
                }
                float *out = syn1neg + target * layer;
                float dot = 0.0f;
                for (long k = 0; k < layer; k++) dot += neu1[k] * out[k];
                float g = (label - fast_sigmoid(dot)) * lr;
                for (long k = 0; k < layer; k++) {
                    neu1e[k] += g * out[k];
                    out[k] += g * neu1[k];
                }
            }
            for (long j = 0; j < n_ctx; j++) {
                float *in = syn0 + ctx[j] * layer;
                for (long k = 0; k < layer; k++) in[k] += neu1e[k];
            }
            trained++;
        }
    }
    return trained;
}
