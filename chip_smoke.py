"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. build the hand-written kernels (``deeplearning4j_torch/kernels``);
2. K1, flash-attention forward, against its plain PyTorch version at the
   slice's shape (f32 causal with and without a key mask, bf16), at the
   training shape [16, 8, 128, 32], at the JAX bench leg's bf16 training
   shape [32, 8, 512, 32] (phase 7c) and at T=2048, d=128, then head dims 8
   and 16 (f32, bf16, f16) and f16 at d = 32, 64, 128 (``FLASH_CASES``;
   f16 within ``F16_REL`` of max|o|), then the padded head dims
   ``PAD_DIMS`` (4, 24, 48, 80, 96, 120: f32 and bf16 causal, with and
   without a key mask; f16 at 48 and 96); two calls must be bitwise equal;
   timed beside the plain version and SDPA as a yardstick, each case with
   the width it runs at and D_pad/d;
3. K2, paged-attention read, against its plain gather version: decode
   (T=1), T=4 and T=5 (the two sides of the decode/chunk route boundary)
   and a 256-token prefill chunk, f32 and int8 pools, Tmax 512 and 2048,
   with a row on a page boundary and a row whose block table is all page 0;
   then chunk-route cases at Tmax 512: T=48 (the serve's second prefill
   round), T=64, a ragged T=100, d=64 and d=128 at T=256, and page size 8;
   then 16-bit queries (``PAGED16_CASES``): bf16 and f16 pools and int8
   pools under a bf16 query at T = 1, 4, 5, 48 and 256, d = 64 and 128,
   page size 8, each against the plain version on f32-widened inputs
   (one rounding of o: one ulp of max|o|) and at its own dtype (looser,
   ``PAGED16_TOL``); then head dims 8 and 16 (``PAGED_SMALL_CASES``):
   f32, bf16 and f16 queries over pages of their dtype and over int8
   pages, T = 1, 4, 5, 48, 256 at page size 16 and T = 1, 48 at page size
   8, under the same rule; then the padded head dims
   (``PAGED_PAD_CASES``: d = 4, 48, 80, 96, f32 and bf16 queries over
   their own and int8 pages, T = 1, 4, 5, 48, 256; page size 8 at d = 48);
   two calls must be bitwise equal, and each chunk case
   also runs its other walk (unsplit where the kernel's rule splits the
   walk, four ranges where it does not) within the same tolerance;
4. the slice model (zoo TransformerLM defaults, numpy-seeded weights) on
   the card: ``output()`` against a CPU run of the port's plain path;
5. serving: 16 greedy requests (prompts of 8..300 tokens, 32 new tokens)
   through ``GenerationServer`` with f32 and then int8 KV pages, each held
   token for token against the same server with ``paged_attention="stock"``;
4b. the model zip: the net saved with ``save_model`` (``coefficients.bin``
   byte for byte ``params_flat()``), loaded with ``load_model(...,
   device="cuda")``, its ``output()`` bitwise the in-memory net's and its
   greedy serve token for token phase 5's;
5b. sampling: the phase-5 prompts as one batch of 8 greedy and 8 sampled
   requests (temperature 0.8, top_k 40, a seed each) on the loaded net, f32
   KV, token for token the plain-read server's, repeated by a second serve,
   greedy requests equal to phase 5's;
5c. a bf16 TransformerLM (the same weights cast to bf16) served greedy
   through K2, bf16 and int8 KV, each stream equal to the plain-read bf16
   server's or leaving it only at a position whose own top-2 logit gap is
   within the gap spread of two right reads of the model (``gap_spread``,
   measured in the phase, at most ``NEAR_TIE_CAP``); identical requests and
   divergences reported;
4c. the JAX package's committed fixture
   (``tests/fixtures/regression_transformer_r5.zip``: d_model 16, 2 heads
   of d=8) loaded with ``load_model(..., device="cuda")``: ``output()`` on
   the npz's probe within atol 1e-5 of its ``output`` through K1, a greedy
   serve token for token the plain-read server's through K2 at d=8, and
   three Adam ``do_step``s against the CPU plain path (first-step
   gradients within 1e-4 of max|g|, losses within rtol 1e-4) through K3
   and K4;
5d. prefix sharing at full width: 16 requests sharing a 192-token system
   prompt with distinct 1-64-token suffixes (half sampled), the first
   served alone, with ``prefix_cache`` on, off, and through the plain read,
   f32 and int8 KV: token for token equal, at least 15 prefix hits, 192
   tokens reused per hit, a copy-on-write page, and every page free or
   cached after the drain; the same requests on a 40-page pool (at least
   one preemption, tokens unchanged); four live requests exported after at
   least 16 tokens, round-tripped through their bytes and adopted by a
   second server, f32 and int8 KV (completions equal to the uninterrupted
   streams, 4 resumes, no fallback);
5e. speculative decoding, serving roles, a migrating drain and chaos at
   full width: the phase-5b requests (half sampled) served with a draft
   (the target itself, and a numpy-seeded draft of d_model 64, 2 heads of
   32, 1 block) at ``spec_k`` 4 (K2's decode route verifies) and 5 (its
   chunk route verifies), f32 and int8 KV, each stream equal to the
   non-speculative server's or leaving it only at a position whose own
   decision gap is within the gap spread of two right reads (phase 5c's
   rule; a sampled position's gap is its two best perturbed scores'),
   accept rates, rounds and one round's launches and syncs reported; a
   prefill-role server exporting every request to a decode-role server
   (f32, int8; completions equal the unified server's, 16 exports and 16
   resumes); a ``drain(migrate=True)`` after at least 16 tokens whose
   snapshots a second server adopts (completions equal the uninterrupted
   streams); a seeded ``ChaosPolicy(transient_rate=0.2)`` (every request
   completes with phase 5's tokens, retries counted), then a kill (futures
   fail typed, one pool rebuild, the next batch equal to phase 5's);
5f. a TransformerLM of head dim 96 (``SLICE96``: d_model 384 in 4 heads,
   numpy-seeded weights): ``output()`` against a CPU run of the plain path;
   the phase-5 requests served greedy, f32 and int8 KV, by it and by its
   ``quantize_net`` int8-weight copy, each against the plain-read server on
   the same weights (f32 KV token for token; int8 KV under phase 5c's
   near-tie rule, each divergence reported), the int8-weight streams'
   ``greedy_agreement`` with the f32 streams and both parameter sizes; K1
   and both routes of K2 must launch at d = 96;
6. K3 and K4, the flash backward (dQ and dK/dV), against their plain
   PyTorch version at the training shape [16, 8, 128, 32] (f32 causal with
   and without a key mask, bf16), at the bench leg's [32, 8, 512, 32] bf16
   causal, at [2, 8, 2048, 128] causal (f32,
   bf16), at head dims 8 and 16 (f32, bf16, f16), in f16 at d = 32, 64,
   128 and at the padded head dims as in phase 2 (``BWD_TOL``); two calls
   must be bitwise equal; timed beside the plain version
   and the backward of SDPA as a yardstick (its device time per call and
   the SDPA backend that ran);
7. training: the full-width model trained with the conf's Adam through
   ``do_step`` on a 16 x 128-token batch, on the card and on the CPU from
   the same weights: first-step gradients and three steps' losses agree,
   each step launches K1, K3 and K4 ``n_blocks`` times, the loss falls over
   20 more steps on the batch, and the step time is reported;
7b. three Adam ``do_step``s of the phase-5f model on the phase-7 batch,
   card against CPU (first-step gradients within 1e-4 of max|g|, losses
   within rtol 1e-4), each step launching K1, K3 and K4 ``n_blocks`` times
   at d = 96;
7c. ``fit`` as the JAX package trains. Part 1: the JAX bench leg's
   TransformerLM (``bench.py::bench_transformer_lm``: vocab 256, T = 512,
   d_model 256 in 8 heads of 32, 4 blocks, ``compute_dtype="bfloat16"``;
   numpy-seeded f32 weights) on a stream of 10 batches of 32 from
   RandomState(6), one with a NaN in its features and a trailing partial
   batch of 20 rows, trained with ``fit(stream)`` at the defaults (K = 4,
   the health guard on) and with ``fit(stream, fused_steps=1)``: scores and
   params within 1e-6 (bitwise reported), exactly one skip, every param
   finite, the loss falling, K1/K3/K4 ``n_blocks`` launches a step in bf16
   at d = 32; the first step on 4 rows against the CPU's f32-compute
   gradients within twice the CPU bf16 path's error plus 1e-3 of max|g|;
   ms a step and training tokens/s over two fused blocks; the phase-5
   requests served greedy with ``compute_dtype`` set and unset, token for
   token. Part 2: the phase-7 model and batch with L1/L2, gradient
   clipping, dropout, a per-layer learning rate and ``remat`` on the
   attention vertices: dropout masks card = CPU, first-step gradients
   and three Adam losses against the CPU (phase 7's rule), K1 twice per
   attention vertex per step, ``remat`` against none within 1e-6.
8. the MultiLayerNetwork substrate, with cuDNN's TF32 flag at torch's
   default (on) for the whole phase, so the convolution layers must hold
   f32 themselves (a control convolution reports what a bare ``F.conv2d``
   loses under that flag). 8a: ``zoo.LeNet`` (28×28×1, 10 labels,
   AdaDelta) on the port's synthetic MNIST, 64 batches of 64 with one NaN
   batch: ``fit`` at the defaults (K = 4, the guard) bit for bit
   ``fit(fused_steps=1)``, one skip each; the first step against the CPU
   plain path (phase 7's rule); fused ``evaluate`` count for count the
   per-batch path's over 1,000 test images (a padded tail); the zip saved
   and loaded on the card; ms a step and images/s (launches a step and the
   idle share of a fused block with ``--profile``). 8b: the committed
   ``tests/fixtures/regression_convnet_r4.zip`` on the card against its
   npz (``params_sum`` within 1e-4, ``output`` within 1e-5), then one
   ``fit`` step against the CPU's. 8c: ``LeNet(quantize="int8")`` under
   the JAX package's eval-parity rule (confusion delta <= 0.05, outputs
   within 5e-2). 8d: SimpleCNN (48×48×1), AlexNet and VGG16 (224×224×3)
   against the CPU at batch 2 (first-step gradients in f64 under phase
   7's rule; in f32 every layer's activation within 1e-4 of its max and
   the loss within rtol 1e-4, the f32 gradient ratio reported: a ReLU
   flip makes deep f32 gradients incomparable leaf by leaf), then timed
   steps at batch 32 (VGG16 16) with the device busy share.
9. the serving fabric at the slice's width, on phase 5's weights. 9a: a
   ``ReplicaFleet`` of two phase-5 servers on the one card serves the 16
   phase-5 requests and the 8 sampled ones of phase 5b, once clean (its
   tokens/s beside one server's) and once with replica 0 killed while it
   decodes: every stream equal to phase 5's or 5b's, a death, nothing
   lost, the respawn, and ``torch.cuda.memory_allocated()`` before the
   fleet, with two live replicas and after the respawn (the killed
   replica's pool freed). 9b: a prefill/decode fleet (streams equal to
   phase 5's, TTFT and inter-token latency from ``fleet_ttft_ms`` /
   ``fleet_itl_ms``), then its decode tier dark (co-located serving,
   streams still phase 5's). 9c: 64 single-row submits through
   ``ParallelInference`` over LeNet (trained on 32 synthetic MNIST
   batches) and over the slice model: 4 forwards of 16 rows, each row bit
   for bit ``output()`` of its batch and within 1e-5 of max|y| of an
   unpadded ``output()``; int8 LeNet under phase 8c's rule. 9d:
   ``KerasBackendServer`` on port 0: eight concurrent ``/generate``
   through a two-replica fleet (phase 5's/5b's tokens), ``/predict`` (9c's
   rows bit for bit), ``/stats`` (the JAX server's keys), ``/metrics``
   and ``/fit`` on two batches of phase 7's shape (losses and parameters
   bit for bit ``fit`` called directly; ``/import`` runs in 14e). 9e: ``LoadGenerator.run_open`` Poisson arrivals
   against a fleet with an ``Autoscaler`` on a ``FleetTierTarget``:
   achieved req/s, p50/p99, the decisions, nothing lost, every stream
   phase 5's or 5b's.
10. retrieval and RAG, on stores drawn as ``bench.py`` draws them
   (RandomState(0), centers x 2.0 plus noise x 0.6, queries perturbed
   corpus rows). 10a: the exact f32 ``EmbeddingIndex`` at 1M x 32
   (cosine at 65,536 rows) bitwise ``DeviceBruteForceIndex`` and itself,
   64 queries against the CPU under the tie rule (``tie_rule``: squared
   distances within 2^-20 of the norms, ids equal where the exact
   distances are apart), 256 one-row submits coalesced (``max_batch``
   256, ``max_wait_ms`` 20) beside 64 serial ones (q/s, p99, dispatches),
   and one Q = 256 dispatch's device time, launches and peak transient
   beside its bound. 10b: the int8 flat store at 1M x 32 (recall@10 >=
   0.9, capacity >= 1.8x from twin 65,536-row stores, the peak transient
   of one dispatch with the f32 widening of the store in it, a bitwise
   rebuild after ``drain``/``close``). 10c: IVF int8 at 1M x 32 with
   1,024 partitions probed 8 deep (recall@10 >= 0.95, a full probe
   answering as the int8 flat store, build seconds, spills, the open
   loop). 10d: ``NearestNeighborsServer(backend="index")`` over HTTP
   (``/knn`` with a point and points as ``search_batch_arrays``,
   ``/encode`` with ``"add": true`` through a ``ParallelInference`` over a
   Dense MultiLayerNetwork, ``/status`` growing, the typed 400, 404, 413
   and 504). 10e: ``RagPipeline`` at ``bench.py::bench_serve_rag``'s
   configuration: a 10M x 16 int8 IVF store (recall@10 >= 0.95 at 10M),
   virtual 24-token passages, k = 2, page size 8, the full-width slice
   model on the generate tier through K2; 2 warm, 12 hot and 12 cold
   requests, then 96 Zipf (s = 1.1) requests over 64 hot documents with a
   60 s deadline: every stream equal to a plain-read server's on the
   assembled prompt, prefix hits, nothing lost or expired, req/s, p99 and
   hot/cold ms a turn; one ``/rag`` through ``attach_rag`` answering as
   ``submit``. 10f: ``BarnesHutTsne`` and ``Tsne`` on 2,000 x 50
   clustered points: the sparse P card against CPU within 1e-3 of its
   largest entry, ten iterations from the same P within 1e-2 of max|y|,
   timed.
11. recurrent nets, on numpy-seeded weights. 11a: ``zoo.TextGenerationLSTM``
   (GravesLSTM 256 x2, RmsProp, L2, TBPTT 50) on the JAX bench leg
   (``bench.py::bench_lstm``: vocab 77, batch 64, seq 50): the first
   step's gradients card against CPU within 1e-4 of max|g|, steady
   tokens/s (the median of marginal windows), launches a step and the idle
   share under the profiler; on DL4J's char-modelling shape (batch 32,
   1,000 steps, twenty 50-step segments of a seeded Markov text): each
   segment's step card against CPU from the same state (twenty losses
   within rtol 1e-4, the parameters after each within 1e-4 of the leaf's
   max|p|; the free-running ``fit`` of both reported, not gated, beside
   the CPU's f32 run against its f64 run: RmsProp amplifies f32
   rounding), ``fit`` at its defaults bit for bit a
   ``do_step`` loop over the segments with the carry, a NaN segment
   skipped by the guard. 11b: on the char-trained
   net, ``rnn_time_step`` in chunks of 7 equal to ``output()`` within 1e-5
   of max|y|; ``greedy_generate`` of 200 tokens after a 50-token prompt at
   batch 8, the device and host loops token for token and card against
   CPU under phase 5c's near-tie rule; a sampled stream card against CPU
   under the same rule on the perturbed scores; ms a generated token. 11c:
   the UCI synthetic-control shape (6 classes, 60 steps, lengths 30..60
   under a mask): a GravesBidirectionalLSTM -> LastTimeStep -> OutputLayer
   MultiLayerNetwork and an LSTM -> LastTimeStepVertex ->
   DuplicateToTimeSeriesVertex -> RnnOutputLayer graph, each trained by
   ``EarlyStoppingTrainer`` (MaxEpochs 3, ScoreImprovement 2) on the card
   and the CPU (the same termination and best epoch, scores within rtol
   1e-4), their best models' ``Evaluation``, ``EvaluationBinary``,
   ``ROCMultiClass`` and ``RegressionEvaluation`` card against CPU except
   at near-ties. The recurrent path runs no hand-written kernel (the JAX
   package's LSTM is a matmul and a ``lax.scan``, no Pallas kernel).
12. graphs and fine-tuning, on weights drawn from the zoo seeds. 12a: the
   zoo ResNet50 at the JAX bench leg (``bench.py::bench_resnet50``:
   224×224×3, 1,000 labels, batch 128, ``compute_dtype="bfloat16"``,
   synthetic device batches from a seed; not cut): at batch 2 against the
   CPU the f64 first step under phase 7's rule and, in f32, each vertex
   from the CPU's inputs to it within 1e-4 of max|a| (``graph_gates``);
   ``fit`` at the defaults against two ``fit(fused_steps=1)`` runs (bit
   for bit); the loss over 20 steps on a fixed batch; images/s (median of
   marginal windows), ms a step, launches a step, busy share and the share
   of the dense bf16 peak. 12b: GoogLeNet (224), FaceNetNN4Small2 (96) and
   InceptionResNetV1 (160) under the same gates, then timed at batch 32.
   12c: 12a's net rebuilt by ``TransferLearning.GraphBuilder``, frozen
   through ``res4f``, a 10-way head: ``fit`` on 5 batches of 64 leaves
   every frozen leaf and batch-norm statistic bit for bit, the head's f64
   first step against the CPU, ms a step, and ``TransferLearningHelper``
   giving the same head. 12d: ``MixtureOfExpertsLayer`` (512 wide, 8
   experts of 2048, top 2) on [64, 128, 512] under an Adam head: the first
   step and the selected experts against the CPU, ms a step. 12e:
   ``Solver`` (L-BFGS, conjugate gradient, line gradient descent) on
   LeNet at batch 64: f64 card and CPU take the same iterations and
   losses. 12f: a graph of every vertex saved on the CPU and loaded with
   ``load_model(..., device="cuda")``. No hand-written kernel runs there
   (convolutions, batch norm and the einsums are library calls, as the
   JAX package's are XLA's).
13. layer-wise pretraining, the data pipeline and listeners (no
   hand-written kernel: the JAX package computes them in XLA or on the
   host). 13a: dl4j-examples' ``DeepAutoEncoderExample`` stack (binary
   RBMs 784 -> 1000 -> 500 -> 250 -> 100 -> 30 and the mirrored decoder,
   a sigmoid MSE head; CD-1, Adam, batch 128) on ``CurvesDataSetIterator``:
   ``pretrain`` at 20 steps a layer, each layer's first CD step card
   against CPU from the same state and key (gradients within 1e-4 of
   max|g| once the card's hidden samples are handed to the CPU; the units
   where the CPU's own sample differs counted as flips), steps/s a layer,
   launches a step and the idle share, layer 0's reconstruction MSE before
   and after, then ``fit`` of the stack. 13b: ``VaeMNISTAnomaly``'s VAE
   (784 -> 256, 256 -> 32 -> 256, 256, Bernoulli(sigmoid), Adam 1e-3, L2
   1e-4) on synthetic MNIST: its first step card against CPU in f64
   (1e-6 of the bound) and f32 (reported), the -ELBO over 50 steps,
   steps/s. 13c: a stacked denoising AutoEncoder 784 -> 500 -> 250
   (corruption 0.3) on the curves under the same first-step rule, then
   ``fit``. 13d: LeNet ``fit`` through ``AsyncDataSetIterator(
   DevicePrefetchIterator(...))`` and through ``MultipleEpochsIterator``
   bit for bit their plain runs; an Iris MLP; ``ProfilerListener``'s
   Chrome trace holding kernel events of its window; ``threshold_encode``
   card = CPU bit for bit; ``DL4JClassifier`` bit for bit the net's own
   ``fit``/``output``.
14. the NLP embedding stack, DeepWalk and Keras import (no hand-written
   kernel: the JAX package trains embeddings in XLA or in host C and
   imports Keras on the host). 14a: Word2Vec at the JAX bench leg
   (``bench.py::bench_word2vec``: 50,000 sentences of 20 Zipf(1.3) words
   over 30,000, min frequency 2, layer 128, window 5, negative 5, batch
   8,192, one epoch; not cut) through ``backend="device"`` on the card
   and ``backend="native"`` on the C loop (which must have built and
   been taken): words/s of each, launches a batch and the idle share; a
   negative-sampling fit under the default ``"auto"`` keeps its tables
   on the card; an
   80-batch block card against CPU from the same tables and key (window
   and negative draws bitwise, tables within ``NLP_TABLE_ATOL``), run
   twice on the card (bitwise reported); the class defaults (HS) on the
   first 2,500 sentences card against CPU, ``words_nearest`` equal. 14b:
   ParagraphVectors DBOW at ``bench_doc2vec``'s shape (4,000 documents of
   40 words over 5,000, layer 100, negative 5) on the card, words/s;
   ``infer_vector`` card against CPU from the same state; a DM run card
   against CPU. 14c: GloVe on 14a's first 5,000 sentences: ``fit``, then
   one epoch card against CPU (the permutation bitwise). 14d: DeepWalk
   (vector 128, window 10, 1 walk of 40 a vertex) on a 2,000-vertex
   two-community graph: same-community similarity above cross. 14e: a
   Keras-1 MNIST CNN at LeNet's widths and a residual / concat functional
   model imported onto the card (card against CPU and a numpy forward),
   with ``quantize="int8"``; ``KerasBackendServer`` ``/import`` (through
   ``import_model`` from an ``InMemoryH5`` where h5py is absent, said on
   an earlier line), ``/predict`` and ``/fit`` over HTTP bit for bit
   direct calls; ``load_model_guess`` on a zip, both vector formats and
   an ``.h5``.
15. the data-ingest and telemetry stack. 15a: the synthetic MNIST test
   set written as the CSV users download (the label, then 784 integer
   pixels; 10,000 rows), read by ``CSVRecordReader`` (which must take the
   native parser) and ``RecordReaderDataSetIterator`` (batch 128, 10
   classes) into one epoch of ``examples/mnist_mlp.py``'s net (pixels
   scaled by 1/255): every batch bitwise the written arrays, the epoch
   bitwise the same batches from memory; rows/s of the reader and the
   iterator, images/s from the CSV and from memory, the CSV fit's idle
   share; then phase 11c's 600 synthetic-control series as one CSV per
   sequence through ``CSVSequenceRecordReader`` and
   ``SequenceRecordReaderDataSetIterator`` (batch 30, 6 classes): batches
   bitwise the numpy build of JAX's iterator, one epoch of 11c's graph
   net bitwise the same from memory. 15b: ``examples/
   streaming_training.py`` at its full size: a producer process, the
   broker and ``NDArrayRoute(buffer_batches=8)`` into ``fit`` (400
   iterations, no frame dropped, held-out accuracy over 0.85, bitwise the
   fit from memory), batches/s and the idle share; a producer that stops
   without END makes its consumer raise ``StreamStalled``. 15c: phase
   7c's bf16 TransformerLM through ``fit`` for 40 steps under
   ``StatsListener(reporting_frequency=10, collect_histograms=True)``
   into a ``FileStatsStorage``: bitwise the fit without the listener,
   reports at 10/20/30/40, the last norms within 1e-5 of f64 host norms,
   whole histogram counts, a ``UIServer`` over the reopened file
   answering over HTTP; ms a step with and without the listener
   (marginal windows); the three legacy listeners on LeNet (batch 512),
   the activation maps within 1e-5 of a CPU net's on the card's
   parameters.
16. several devices of one process, over meshes of distinct cards where
   the machine has enough and of ``cuda:0`` named several times where it
   does not (each line says which). 16a: K2 on the head shards of a tp = 2
   and tp = 4 pool (f32 and int8, decode and chunk routes, the full head
   count's split rule) against the plain version and, concatenated,
   bitwise the whole pool's read; the phase-5 requests served at tp = 1,
   2 and 4 with f32 and int8 KV, every stream phase 5's, K2's launches a
   token per route, tokens/s and peak pages a shard; a 300-token prompt's
   logits and one decode step's at tp = 2 and 4 bitwise tp = 1's. 16b: four
   live requests exported from tp = 2 (header ``shards=2``), round-tripped
   through their bytes, adopted at tp = 4 and tp = 1, f32 and int8:
   completions equal the uninterrupted streams. 16c: ``device_groups(2,
   tp=2)`` under a ``ReplicaFleet`` of two tp = 2 servers serving phase
   9's traffic, replica 0 killed mid-stream: streams phase 5's/5b's,
   nothing lost. 16d: ``ParallelInference`` over a 4-entry data mesh on
   the slice model (K1) and a trained LeNet within rtol 1e-5 / atol 1e-6
   of ``output()``; ``evaluate_on_mesh`` fused and per batch, counts
   equal ``net.evaluate``'s. 16e: ``ParallelWrapper`` over 4 workers on
   the phase-7 model, ``AVERAGING`` with Sgd and ``SHARED_GRADIENTS`` with
   Adam, two rounds against one device on the concatenated batches (rtol
   1e-5 / atol 1e-6 and 1e-4 / 1e-5), the first round against the CPU;
   then phase 7c's bench leg over 2 workers averaging every 2 steps for 10
   rounds: tokens/s, ``last_phase_timings``, skips, K1/K3/K4 a round.
17. sharded stores and one-process model parallelism, over the same kind
   of meshes (each line says which). 17a: bench.py's 1M x 32 f32 and int8
   flat stores sharded over 4 data entries against one card's (the tie
   rule, distances within 1e-5, recall), the sharded open loop's q/s
   beside phase 10a's, ``NearestNeighborsServer(mesh=)`` answering /knn as
   its index, bytes per entry; then the 10M x 16 int8 IVF trained by the
   sharded k-means and searched probe-local: recall@10 >= 0.95 and >= one
   card's global probe. 17b: ``ShardedTrainer`` on the slice TransformerLM
   over data 2 x model 2 at phase 7's 16 x 128 tokens with Adam: three
   steps within rtol 2e-4 / atol 2e-5 of one card's ``fit``, the attention
   core on 4-head shards, one shard's q/k/v through K1, K3 and K4 against
   the plain versions, K1/K3/K4 launches 4 x one card's, ms a step and
   params plus Adam bytes per entry. 17c: ``tp_mlp_train_step`` at JAX's
   test shapes against the dense step; ring and Ulysses attention on the
   slice's attention layer at T = 2,048 over a 4-entry ``seq`` axis,
   forward and gradients against the dense layer (JAX's 2e-5 and 3e-5);
   ``PipelineTrainer`` over 2 stages x 4 microbatches of LeNet against one
   card. 17d: parameter averaging of the phase-7 model over 4 workers
   through ``SparkComputationGraph`` equal to one machine (16e's rounds and
   tolerance), Word2Vec at 14a's corpus and width over tables sharded on 2
   entries against the unsharded fit (words/s of both),
   ``ParameterServerParallelWrapper`` on the phase-7 model: 16 pushes from
   2 workers, the score falls, the pulled params are the net's.
18. processes on one host. 18a: phase 7's model (phase 5's weights, six
   seeded [16, 128] batches an epoch, two epochs) trained by a
   ``FaultTolerantTrainer`` (a checkpoint every 4 iterations) in a child
   process that ``os._exit(137)``s after iteration 5; the same command
   resumes mid-epoch from its checkpoint; an
   uninterrupted run in a fresh directory runs beside the first: equal
   iteration counts, each batch trained once, weights within phase 7's
   1e-4 (bitwise said), K1/K3/K4 launched in every child; a
   ``FailureDetector`` sees the first child's ``Heartbeat`` advance while
   it trains and age out after the kill. 18b: two ``spawn_host``
   processes, each serving phase 9's fleet (``fed_fleet``: phase 1's
   kernel build loaded, never rebuilt) on the card, behind one
   ``FleetFederation``: phase 9's traffic, every stream equal to phase
   5's/5b's, both hosts dispatched, tokens/s beside 9a's in-process
   fleet and beside the same traffic through one host. 18c: two more hosts with a snapshot every step, one host
   SIGKILLed once the router holds its published snapshots: every stream
   equal, handoff resumes, a death, degraded mode, a balanced ledger, none
   lost, one scrape with both hosts' families. Each child process counts
   its own launches (a host's reach the router in its stats RPC), and
   each host must launch K2 on both routes.
19. process groups. 19a: two rank processes join a ``torch.distributed``
   group through ``parallel/distributed.py::initialize`` (gloo, both on
   the first card: NCCL refuses two ranks on one device), shard phase 7's
   model (phase 5's weights) over the global ``data_mesh()`` and train it
   five Adam steps through ``do_step`` on their rows of phase 7's batch
   (``make_array_from_process_local_data``): the ranks bitwise equal,
   both within rtol 1e-4 / atol 1e-5 of one process's steps on the whole
   batch, K1/K3/K4 launched in each rank, ms a step beside the one
   process's and phase 17b's one-process dp 2 x tp 2 step. 19b: the ranks
   ``save_checkpoint`` after step 4; a fresh pair (started beside them,
   held at a gate) ``load_checkpoint``s into its sharded net, bitwise the
   saved params, and takes step 5, bitwise the uninterrupted ranks' (where
   a rank drives two cards, within ``GROUP_RESUME_ATOL``); this process
   restores the checkpoint whole (``net=None``) on the card, bitwise the
   ranks' params at step 4; save and restore seconds. On a machine of two
   cards a leg runs a card a rank over NCCL, on four another runs two
   ranks of two cards each under ``data_model_mesh(2, 2)``. Each rank
   counts its own launches.
20. graftcheck. 20a: a child runs ``python3 -m
   deeplearning4j_torch.analysis --check`` on this tree: exit 0 (no
   unbaselined finding, no stale baseline entry) with no ``jax`` and
   nothing of ``deeplearning4j_tpu`` in its ``sys.modules``; files scanned,
   findings, baselined entries and seconds. 20b:
   ``analysis.instrument.install()``, then phase 9's two-replica fleet of
   the slice model (explicit ``RetryPolicy`` and ``CircuitBreaker`` a
   replica), phase 10's /rag route over the first 65,536 documents of its
   store (``KerasBackendServer.attach_rag``, an int8 ``EmbeddingIndex``), a
   ``NearestNeighborsServer`` (an f32 index) over the same documents, a
   ``ParallelInference`` coalescer over the slice model and a
   ``StreamingBroker`` fed by the 15b producer process; eight client
   threads serve phase 9's 24 fleet requests (streams bitwise phase 9's;
   tokens/s beside phase 9a's and beside the same serve on a plain fleet
   after ``uninstall()``), then all of it at once: the
   fleet requests again, RAG turns (half over /rag, each phase 10's route
   answer), k-NN queries (half over /knnVector, held to the serial answers
   by phase 10a's tie rule), coalesced rows (within 1e-5 of max|y| of
   ``output()`` alone) and the producer's 400 batches (bitwise). Every
   ranked lock of every instance built is rank-checked, no violation was
   raised on any thread, no serving loop crashed or restarted; K1 and both
   routes of K2 launch. 20c: still installed, a loop's tick holds a rank-70
   ``CircuitBreaker._lock`` and takes its rank-25 ``_cond``: the loop's
   ``crashed`` is a ``LockOrderViolation`` naming both. ``uninstall()``
   runs in a ``finally``.
21. GPT-J-6B's attention width (``GPTJ``: the zoo ``TransformerLM`` at
   d_model 4,096 in 16 heads of d = 256, FFN 16,384, from EleutherAI's
   config.json; cut to 2 blocks and the zoo's vocab 256, sinusoidal
   positions and sequential block, ``GPTJ_REDUCED``), numpy-seeded. 21a:
   ``output()`` of 2 rows x 128 tokens within 1e-4 of a CPU run of the
   port's plain path; the model through a zip, reloaded bitwise. 21b:
   phase 5's 16 requests served greedy, f32 KV token for token the
   plain-read server's, int8 KV and a bf16 model within phase 5c's
   near-tie rule; tokens/s. 21c: three Adam steps of ``fit`` at 4 x 512,
   the first step's loss and gradients at [1, 128] within phase 7's 1e-4
   of each leaf's max|g| of the CPU in f64 (stock f64 attention); ms a
   step. K1, K3, K4 and both routes of K2 launch at d = 256
   (``LAUNCHES_BY_D``), and no plain attention function runs on the card
   outside the comparisons (``plain_guard``).

Phases 2, 3 and 6 also hold every kernel at the head dims of
``WIDE_DIMS`` (1, 2, 3, 5, 6, 50, 130, 132, 160, 192, 200, 224, 256; f32,
bf16 and f16 causal under a key mask, K2 over its own and int8 pages at
T = 1, 4 and 48), the f32 case of each timed, and at phase 21's shapes.

Phases 2, 3 and 6 check every case and time the ones the kernels line
and PERF.md read (``TIMED_CASES``), each twice:
CUDA events around 50 wrapper calls (``ms``: the wrapper's host work included, which sets the pace once
a kernel takes a few µs) and the kernel's own device time per launch from
one short ``torch.profiler`` window (``device_ms``; for K2 per wrapper
call, the split chunk walk's merge pass included), with the plain
version's and the yardstick's device time per call beside it.

The main path is phases 4-5 (serving), phases 4b-5c (loading a zip,
sampled and bf16 serving), phase 4c (the d=8 fixture), phase 5d (prefix
sharing, preemption, handoff), phase 5e (speculative decoding, roles,
migration, chaos), phase 5f (the d=96 model, f32 and int8 weights), phase
7 (training), phase 7b (training at d=96), phase 7c (``fit``), phase
8 (the MultiLayerNetwork substrate, which runs no hand-written kernel:
its convolutions and pooling are library calls, as the JAX package's are
XLA's), phase 9 (the serving fabric: K1, both routes of K2, K3 and K4),
phase 10 (retrieval and RAG: both routes of K2 on the generate tier;
the stores' searches are matmuls and top-k, as the JAX package's are
XLA's), phase 11 (recurrent nets, which launch none of K1-K4), phase
12 (graphs and fine-tuning, which launch none either), phase 13
(pretraining and the data pipeline, none either), phase 14 (the NLP
stack and Keras import, none either) and phase 15 (data ingest and
telemetry: K1, K3 and K4 in 15c's bench-leg fit, none in 15a and 15b,
K2 nowhere; the counters are also read between its parts), phase 16
(several devices: K2 on head shards, both routes; K1, K3 and K4 in the
data-parallel forwards and training) and phase 17 (sharded stores and
model parallelism: K1, K3 and K4 on the dp x tp trainer's head shards,
K2 nowhere) and phase 18 (processes on one host: K1, K3 and K4 in 18a's
trainer processes, both routes of K2 in every host process of 18b and
18c, each child counting its own) and phase 19 (process groups: K1, K3
and K4 in every rank process, each counting its own) and phase 20
(graftcheck: K1 and both routes of K2 in the lock-checked serve) and
phase 21 (GPT-J-6B's width: all four at d = 256, both routes of K2). The
launch counters are zeroed just before each of the twenty-three and read just
after (phase 6's and the reference servers' and forwards' launches are
not counted); every kernel must have run on the main path, K2's chunk
route and its merge pass included, and each path but phases 8, 11, 12,
13 and 14 must have launched its own kernels (those five must launch
none). The script
prints the card's name and power limit, one ``{"kernels": [...]}`` line with
each kernel's launches, error, times and bound, and, last, the result line
``{"ok": true, "device": {...}}``. f32 matmuls run in full f32 (TF32
off); phase 7c's bf16 compute runs its products in bf16, as JAX's does.

Options: ``--out DIR`` also writes everything measured to
``DIR/chip_smoke.json``; ``--verbose-build`` prints the kernel build's
compiler lines; ``--profile`` adds, after the main path, one f32 serve, one
phase-5b mixed greedy/sampled serve and five training steps under
``torch.profiler`` (device busy time against the wall clock, kernels by
device time), then one fused phase-7c block, with their tables in
``DIR/serve_profile.txt``, ``DIR/serve_profile_sampled.txt``,
``DIR/train_profile.txt`` and ``DIR/bench_fit_profile.txt`` when ``--out``
is given.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import zipfile

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# bf16 tensor cores. "f32" is the least time f32-accurate work can take:
# three TF32 tensor-core products per product (hi·hi + hi·lo + lo·hi, as K1
# runs them) at 495 TFLOP/s, so 165 TFLOP/s, above the CUDA cores' 67.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"f32": 495e12 / 3, "bf16": 989e12}

SLICE = dict(num_labels=256, max_length=128, d_model=256, n_heads=8,
             n_blocks=4, max_cache=512)
SERVER = dict(slots=8, page_size=16, prefill_chunk=256, steps_per_dispatch=4)
#: phases 5f and 7b: the slice's vocab, depth and capacity at d_model 384 in
#: 4 heads of d = 96 (Phi-3-mini's head dim), which the kernels take padded
#: only since head dims other than 8, 16, 32, 64, 128 were added
SLICE96 = dict(num_labels=256, max_length=128, d_model=384, n_heads=4,
               n_blocks=4, max_cache=512)
D96 = SLICE96["d_model"] // SLICE96["n_heads"]
# phase-5 prompt lengths: 8..300 tokens, five past prefill_chunk
SERVE_LENS = [8, 300, 270, 257, 12, 64, 129, 31, 200, 16, 99, 280, 45, 150,
              9, 256]
# phase-7 training batch: 16 sequences of max_length tokens
TRAIN_BATCH = 16
TRAIN_STEPS = 20
DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16",
             torch.float16: "f16"}
#: the flash kernels' dtype codes (kernels/flash_fwd.cu)
FLASH_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: phases 2 and 6: head dims the kernels run padded (to 8, 48, 48, 80, 96,
#: 128), f32 and bf16; f16 at two of them
PAD_DIMS = (4, 24, 48, 80, 96, 120)
PAD_F16_DIMS = (48, 96)
#: phase 3: K2's padded head dims (decode route to 8, 64, 128, 128; chunk
#: route to 8, 48, 80, 96), f32 and bf16 queries over their own and int8
#: pages
PAGED_PAD_DIMS = (4, 48, 80, 96)
#: phases 2, 3 and 6: the head dims of ROADMAP B3 (a) and (b), which the
#: kernels take since the wide widths and the element staging were added:
#: they run at 8 (d = 1..6; 16-bit rows of odd d and int8 rows of
#: d % 4 != 0 staged by element loads), 64 (50), 160 (130, 132, 160), 192,
#: 224 (200, 224) and 256 (exact; K2's decode route at 256 from 130 on);
#: f32, bf16 and f16, causal under a key mask, K2 also over int8 pages on
#: both routes
WIDE_DIMS = (1, 2, 3, 5, 6, 50, 130, 132, 160, 192, 200, 224, 256)
#: ... and the f32 case timed at one head dim a width (8, 64, 160, 192,
#: 224, 256)
WIDE_TIMED_DIMS = (2, 50, 130, 192, 200, 256)
# phase-6 cases: (name, B, H, T, d, dtype, causal, masked); the first
# three are the training shape. Every case is checked, and timed where
# TIMED_CASES names it.
BWD_CASES = [
    ("slice_f32_causal", 16, 8, 128, 32, torch.float32, True, False),
    ("slice_f32_causal_mask", 16, 8, 128, 32, torch.float32, True, True),
    ("slice_bf16_causal", 16, 8, 128, 32, torch.bfloat16, True, False),
    # one head shard of phase 17b's dp 2 x tp 2 training step
    ("shard_f32_causal", 8, 4, 128, 32, torch.float32, True, False),
    # the JAX bench leg's bf16 training shape (phase 7c)
    ("bench_bf16_causal", 32, 8, 512, 32, torch.bfloat16, True, False),
    ("long_f32_causal", 2, 8, 2048, 128, torch.float32, True, False),
    ("long_bf16_causal", 2, 8, 2048, 128, torch.bfloat16, True, False),
] + [
    # head dims 8 and 16 (the JAX package's small models: the committed
    # fixture has 2 heads of d=8) in f32, bf16 and f16 at the training
    # batch, and f16 at d = 32, 64 and 128
    (f"d{d}_{DTYPE_TAG[dt]}_causal{'_mask' if m else ''}", 16, 8, 128, d, dt,
     True, m)
    for d in (8, 16) for dt, m in ((torch.float32, False),
                                   (torch.float32, True),
                                   (torch.bfloat16, False),
                                   (torch.float16, False))
] + [("slice_f16_causal", 16, 8, 128, 32, torch.float16, True, False),
     ("mid_f16_causal", 2, 8, 1024, 64, torch.float16, True, False),
     ("long_f16_causal", 2, 8, 2048, 128, torch.float16, True, False)] + [
    # the padded head dims (kernels.kernel_width): f32 and bf16 causal with
    # and without a key mask at the training batch, f16 at d = 48 and 96
    (f"d{d}_{DTYPE_TAG[dt]}_causal{'_mask' if m else ''}", 16, 8, 128, d, dt,
     True, m)
    for d in PAD_DIMS for dt, m in ((torch.float32, False),
                                    (torch.float32, True),
                                    (torch.bfloat16, False),
                                    (torch.bfloat16, True))
] + [(f"d{d}_f16_causal", 16, 8, 128, d, torch.float16, True, False)
     for d in PAD_F16_DIMS] + [
    # the head dims of WIDE_DIMS, then phase 21's training shape at
    # GPT-J-6B's 16 heads of d = 256
    (f"d{d}_{DTYPE_TAG[dt]}_causal_mask", 4, 8, 128, d, dt, True, True)
    for d in WIDE_DIMS for dt in (torch.float32, torch.bfloat16,
                                  torch.float16)
] + [("gptj_train_f32_causal", 4, 16, 512, 256, torch.float32, True, False)]
# phase-6 tolerances on max|err| / max|g|. Against the plain backward: f32
# runs each product on the tensor cores as three TF32 products (about 2^-21
# relative per product; one TF32 product would read ~1e-3) and sums each
# tile's dQ/dK/dV in fresh accumulators added by f32 adds, since the tensor
# core's truncating accumulation over the 2048 rows of the long case read
# 2.6e-5 of max|dV| (H100). The kernels measured at most 4.4e-6 at T=2048
# and 2.5e-6 at the training shape; the CPU rehearsal of the design
# (tests/test_torch_flash_backward.py) reads 1.3e-6. bf16: one bf16
# rounding step of the output; f16: 2^-8 (its outputs round once, at the
# end, to 2^-11 of the value). Against the SDPA backward, an independent
# implementation (bf16, f16: its own 16-bit roundings), looser.
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2.0 ** -8}
SDPA_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2, torch.float16: 2e-2}
#: K1's f16 tolerance on max|err| / max|o|: its output rounds once to f16
#: (2^-11 of the value), so 2^-8 holds a few roundings either way
F16_REL = 2.0 ** -8
REPORT: dict = {}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters=50, warmup=5):
    """Mean device time of one ``fn()`` from CUDA events around ``iters``
    calls, after ``warmup`` calls (L2 warm)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: profiler windows taken before a timing gives up: a short window now and
#: then records no device activity at all (a K2 case at d=8 saw none in
#: three windows in one run on an H100, and its kernel in the next run;
#: the cause is not known, see PERF.md's open questions)
PROFILER_WINDOWS = 6
#: how many windows each profiler timing needed: ``timings`` counts them
#: all, ``retried`` names each one that needed more than one window (what
#: it matched, windows taken); printed and kept in the report
WINDOW_LOG: dict = {"timings": 0, "retried": []}


def note_windows(match, taken):
    WINDOW_LOG["timings"] += 1
    if taken > 1:
        WINDOW_LOG["retried"].append([match or "any", taken])


def dev_us(e):
    """Self device time (µs) of one ``key_averages()`` row."""
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)


def device_ms(fn, match=None, iters=20, windows=PROFILER_WINDOWS):
    """Device time of ``fn()`` from a short ``torch.profiler`` window over
    ``iters`` calls (after 3 warm-up calls): with ``match``, the self device
    time of the kernels whose name holds it per launch, else every device
    activity's per call. Device activities are the rows with device time
    and no CPU time. A window that recorded no such activity is taken
    again, up to ``windows`` times. Returns ``(ms, launches per call)``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen = []
    for taken in range(1, windows + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = n = 0
        seen = []
        for e in prof.key_averages():
            if dev_us(e) > 0 and e.self_cpu_time_total == 0:
                seen.append(e.key[:60])
                if match is None or match in e.key:
                    us += dev_us(e)
                    n += e.count
        if n > 0:
            note_windows(match, taken)
            return (us / 1e3 / (n if match else iters)), n / iters
    note_windows(match, windows)
    raise AssertionError(f"profiler saw no device activity "
                         f"({match or 'any'}) in {windows} windows; "
                         f"device rows: {seen[:5]}")


def peak_kind(dtype):
    """The ``PEAK_FLOPS_S`` row of work in ``dtype``: f32 work runs three
    TF32 products, bf16 and f16 the 16-bit tensor cores."""
    return "f32" if dtype in (torch.float32, torch.int8) else "bf16"


def bound_ms(nbytes, flops, kind):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def visible_pairs(B, H, T, causal, mask):
    """(row, key) pairs the attention computes: keys at or before the row
    when causal, and valid in the key mask."""
    if mask is None:
        return B * H * (T * (T + 1) // 2 if causal else T * T)
    valid = (mask != 0).long().cpu()
    per_row = valid.cumsum(1) if causal else valid.sum(1, keepdim=True)
    return H * int(per_row.expand(B, T).sum())


def mask_for(g, B, T, dev):
    """A [B, T] key mask of right padding, row 0 unpadded; key 0 is valid
    in every row, so no causal query row is fully masked."""
    lens = torch.randint(1, T + 1, (B,), generator=g)
    lens[0] = T
    return (torch.arange(T)[None] < lens[:, None]).float().to(dev)


# ----------------------------------------------------------------- phase 2
# phase-2 cases: (name, B, H, T, d, dtype, causal, masked, atol); atol
# None is F16_REL of max|o|. Every case is checked, and timed where
# TIMED_CASES names it.
FLASH_CASES = [
    ("slice_f32_causal", 8, 8, 128, 32, torch.float32, True, False, 1e-4),
    ("slice_f32_causal_mask", 8, 8, 128, 32, torch.float32, True, True, 1e-4),
    ("slice_f32_full_mask", 8, 8, 128, 32, torch.float32, False, True, 1e-4),
    ("slice_bf16_causal", 8, 8, 128, 32, torch.bfloat16, True, False, 2e-2),
    # the training step's shape (phase 7)
    ("train_f32_causal", 16, 8, 128, 32, torch.float32, True, False, 1e-4),
    # one head shard of phase 17b's dp 2 x tp 2 training step
    ("shard_f32_causal", 8, 4, 128, 32, torch.float32, True, False, 1e-4),
    # the JAX bench leg's bf16 training shape (phase 7c)
    ("bench_bf16_causal", 32, 8, 512, 32, torch.bfloat16, True, False, 2e-2),
    ("long_f32_causal", 2, 8, 2048, 128, torch.float32, True, False, 1e-4),
    # at T=2048 a row averages hundreds of keys and |O| is a few
    # hundredths, so bf16 is held tighter than at the slice's shape
    ("long_bf16_causal", 2, 8, 2048, 128, torch.bfloat16, True, False, 8e-3),
] + [
    # head dims 8 and 16 in f32, bf16 and f16, and f16 at d = 32, 64, 128
    (f"d{d}_{DTYPE_TAG[dt]}_{'causal' if c else 'full'}"
     f"{'_mask' if m else ''}", 8, 8, 128, d, dt, c, m, tol)
    for d in (8, 16) for dt, c, m, tol in (
        (torch.float32, True, False, 1e-4), (torch.float32, True, True, 1e-4),
        (torch.float32, False, True, 1e-4), (torch.bfloat16, True, False, 2e-2),
        (torch.float16, True, False, None), (torch.float16, False, True, None))
] + [("slice_f16_causal", 8, 8, 128, 32, torch.float16, True, False, None),
     ("mid_f16_causal", 2, 8, 1024, 64, torch.float16, True, False, None),
     ("long_f16_causal", 2, 8, 2048, 128, torch.float16, True, False, None)
     ] + [
    # the padded head dims: f32 and bf16 causal, with and without a key
    # mask, and f16 at d = 48 and 96
    (f"d{d}_{DTYPE_TAG[dt]}_causal{'_mask' if m else ''}", 8, 8, 128, d, dt,
     True, m, tol)
    for d in PAD_DIMS for dt, m, tol in (
        (torch.float32, False, 1e-4), (torch.float32, True, 1e-4),
        (torch.bfloat16, False, 2e-2), (torch.bfloat16, True, 2e-2))
] + [(f"d{d}_f16_causal", 8, 8, 128, d, torch.float16, True, False, None)
     for d in PAD_F16_DIMS] + [
    # the head dims of WIDE_DIMS, causal under a key mask, then phase 21's
    # output() and training shapes at GPT-J-6B's 16 heads of d = 256
    (f"d{d}_{DTYPE_TAG[dt]}_causal_mask", 4, 8, 128, d, dt, True, True, tol)
    for d in WIDE_DIMS for dt, tol in ((torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, None))
] + [("gptj_f32_causal", 2, 16, 128, 256, torch.float32, True, False, 1e-4),
     ("gptj_train_f32_causal", 4, 16, 512, 256, torch.float32, True, False,
      1e-4)]


def phase_flash(dev):
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.ops import flash_attention as fa

    F = torch.nn.functional
    g = torch.Generator(device="cpu").manual_seed(1)
    results = {}

    def qkv(B, H, T, d, dtype):
        return [torch.randn(B, H, T, d, generator=g).to(dev, dtype)
                for _ in range(3)]

    for name, B, H, T, d, dtype, causal, masked, atol in FLASH_CASES:
        timed = name in TIMED_CASES
        q, k, v = qkv(B, H, T, d, dtype)
        m = mask_for(g, B, T, dev) if masked else None
        o, lse = fa.flash_attention_forward(q, k, v, causal=causal, mask=m)
        again = fa.flash_attention_forward(q, k, v, causal=causal, mask=m)
        po, plse = fa.flash_attention_plain(q, k, v, causal=causal, mask=m)
        torch.cuda.synchronize()
        if atol is None:                  # f16: relative to max|o|
            atol = F16_REL * po.float().abs().max().item()
        check(torch.equal(o, again[0]) and torch.equal(lse, again[1]),
              f"K1 {name}: two calls differ (not deterministic)")
        err = (o.float() - po.float()).abs().max().item()
        lerr = (lse - plse).abs().max().item()
        check(o.dtype == dtype and torch.isfinite(o.float()).all().item(),
              f"K1 {name}: dtype or non-finite output")
        check(err <= atol and lerr <= max(atol, 1e-4),
              f"K1 {name}: max |O err| {err:.3g}, |lse err| {lerr:.3g} > "
              f"{atol}")
        width = kernels.kernel_width(d)
        common = dict(shape=[B, H, T, d], dtype=str(dtype), width=width,
                      pad_ratio=width / d,
                      smem_bytes=kernels.load().flash_fwd_smem(
                          d, FLASH_DTYPE_CODE[dtype]),
                      causal=causal, masked=masked, max_abs_err=err,
                      lse_err=lerr, deterministic=True)
        if not timed:
            results[name] = dict(common, ms=None, device_ms=None,
                                 plain_ms=None, plain_device_ms=None,
                                 library_ms=None, library_device_ms=None,
                                 bound_ms=None, bound_by=None)
            log(f"  K1 {name:22s} err {err:.2e} lse {lerr:.2e} (atol "
                f"{atol:.3g}), bitwise repeatable; width {width}")
            continue
        kernel = lambda: fa.flash_attention_forward(  # noqa: E731
            q, k, v, causal=causal, mask=m)
        plain = lambda: fa.flash_attention_plain(  # noqa: E731
            q, k, v, causal=causal, mask=m)
        ms = time_ms(kernel)
        plain_ms = time_ms(plain, iters=20)
        if m is None:
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal)
        else:
            keep = (m != 0)[:, None, None, :]
            if causal:
                keep = keep & torch.ones(T, T, dtype=torch.bool,
                                         device=dev).tril()
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=keep)
        sdpa_ms = time_ms(sdpa)
        kdev, _ = device_ms(kernel, "flash_fwd_")
        plain_dev, _ = device_ms(plain, iters=5)
        sdpa_dev, _ = device_ms(sdpa)
        isz = torch.tensor([], dtype=dtype).element_size()
        nbytes = 4 * B * H * T * d * isz + B * H * T * 4 \
            + (B * T * 4 if masked else 0)
        flops = 4 * d * visible_pairs(B, H, T, causal, m)
        bms, by = bound_ms(nbytes, flops, peak_kind(dtype))
        results[name] = dict(common, ms=ms,
                             device_ms=kdev, plain_ms=plain_ms,
                             plain_device_ms=plain_dev, library_ms=sdpa_ms,
                             library_device_ms=sdpa_dev, bound_ms=bms,
                             bound_by=by)
        r = results[name]
        log(f"  K1 {name:22s} err {err:.2e} lse {lerr:.2e} (atol {atol}), "
            f"bitwise repeatable; width {r['width']} (D_pad/d "
            f"{r['pad_ratio']:.2f}, {r['smem_bytes']} B smem per CTA); "
            f"kernel {ms:.4f} ms (device {kdev:.4f})  "
            f"plain {plain_ms:.4f} ({plain_dev:.4f})  sdpa {sdpa_ms:.4f} "
            f"({sdpa_dev:.4f})  bound {bms:.4f} ms ({by})")
    return results


# ----------------------------------------------------------------- phase 6
def phase_flash_bwd(dev):
    """K3 (dQ) and K4 (dK/dV) against the plain backward on the same
    inputs, K1's own o and lse, and against the SDPA backward. Errors are
    relative to the largest reference gradient. Returns {case:
    measurements}."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.ops import flash_attention as fa

    F = torch.nn.functional
    ext = kernels.load()
    g = torch.Generator(device="cpu").manual_seed(6)
    results = {}

    def rel_errs(got, refs):
        return {n: ((a.float() - b.float()).abs().max()
                    / b.float().abs().max()).item()
                for n, a, b in zip(("dq", "dk", "dv"), got, refs)}

    for name, B, H, T, d, dtype, causal, masked in BWD_CASES:
        timed = name in TIMED_CASES
        tol, sdpa_tol = BWD_TOL[dtype], SDPA_TOL[dtype]
        q, k, v, do = [torch.randn(B, H, T, d, generator=g).to(dev, dtype)
                       for _ in range(4)]
        m = mask_for(g, B, T, dev) if masked else None
        o, lse = fa.flash_attention_forward(q, k, v, causal=causal, mask=m)
        grads = fa.flash_attention_backward(q, k, v, o, lse, do,
                                            causal=causal, mask=m)
        again = fa.flash_attention_backward(q, k, v, o, lse, do,
                                            causal=causal, mask=m)
        plain = fa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                                  causal=causal, mask=m)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        if m is None:
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        else:
            keep = (m != 0)[:, None, None, :]
            if causal:
                keep = keep & torch.ones(T, T, dtype=torch.bool,
                                         device=dev).tril()
            out = F.scaled_dot_product_attention(*leaves, attn_mask=keep)
        sdpa = torch.autograd.grad(out, leaves, do, retain_graph=True)
        sdpa_backend = type(out.grad_fn).__name__
        torch.cuda.synchronize()
        for gname, got in zip(("dq", "dk", "dv"), grads):
            check(got.dtype == dtype and torch.isfinite(got.float()).all()
                  .item(), f"flash bwd {name}: {gname} dtype or non-finite")
        errs, sdpa_errs = rel_errs(grads, plain), rel_errs(grads, sdpa)
        abs_errs = {n: (a.float() - b.float()).abs().max().item()
                    for n, a, b in zip(("dq", "dk", "dv"), grads, plain)}
        check(max(errs.values()) <= tol,
              f"flash bwd {name}: max|err|/max|g| vs plain {errs} > {tol}")
        check(max(sdpa_errs.values()) <= sdpa_tol,
              f"flash bwd {name}: max|err|/max|g| vs SDPA {sdpa_errs} > "
              f"{sdpa_tol}")
        check(all(torch.equal(a, b) for a, b in zip(grads, again)),
              f"flash bwd {name}: two calls differ (not deterministic)")
        width = kernels.kernel_width(d)
        common = dict(
            shape=[B, H, T, d], dtype=str(dtype), causal=causal, width=width,
            pad_ratio=width / d,
            smem_bytes=ext.flash_bwd_smem(d, FLASH_DTYPE_CODE[dtype]),
            masked=masked, rel_err=errs, max_abs_err=abs_errs,
            tolerance=tol, sdpa_rel_err=sdpa_errs, sdpa_tolerance=sdpa_tol,
            deterministic=True, library_backend=sdpa_backend)
        if not timed:
            results[name] = dict(common, dq=None, dkv=None, plain_ms=None,
                                 plain_device_ms=None, library_ms=None,
                                 library_device_ms=None)
            log(f"  K3/K4 {name:22s} rel err vs plain "
                f"{max(errs.values()):.2e} (tol {tol}), vs SDPA "
                f"{max(sdpa_errs.values()):.2e} (tol {sdpa_tol}), bitwise "
                f"repeatable; width {width}")
            continue
        args = (q, k, v, do, lse, fa.attention_delta(o, do), m, causal)
        dq_ms = time_ms(lambda: ext.flash_bwd_dq(*args))
        dkv_ms = time_ms(lambda: ext.flash_bwd_dkv(*args))
        dq_dev, _ = device_ms(lambda: ext.flash_bwd_dq(*args),
                              "flash_bwd_dq_")
        dkv_dev, _ = device_ms(lambda: ext.flash_bwd_dkv(*args),
                               "flash_bwd_dkv_")
        plain_bwd = lambda: fa.flash_attention_backward_plain(  # noqa: E731
            q, k, v, o, lse, do, causal=causal, mask=m)
        sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
            out, leaves, do, retain_graph=True)
        plain_ms = time_ms(plain_bwd, iters=20)
        plain_dev, _ = device_ms(plain_bwd, iters=5)
        sdpa_ms = time_ms(sdpa_bwd)
        sdpa_dev, _ = device_ms(sdpa_bwd)
        # bytes: q, k, v, dO in, the kernel's outputs, lse and delta (and
        # the mask); operations: 6d (K3) and 8d (K4) per visible pair
        isz = torch.tensor([], dtype=dtype).element_size()
        tensor = B * H * T * d * isz
        rows = 2 * B * H * T * 4 + (B * T * 4 if masked else 0)
        pairs = visible_pairs(B, H, T, causal, m)
        kind = peak_kind(dtype)
        dq_bound, dq_by = bound_ms(5 * tensor + rows, 6 * d * pairs, kind)
        dkv_bound, dkv_by = bound_ms(6 * tensor + rows, 8 * d * pairs, kind)
        results[name] = dict(
            common, pairs=pairs,
            dq=dict(ms=dq_ms, device_ms=dq_dev, bound_ms=dq_bound,
                    bound_by=dq_by),
            dkv=dict(ms=dkv_ms, device_ms=dkv_dev, bound_ms=dkv_bound,
                     bound_by=dkv_by),
            plain_ms=plain_ms, plain_device_ms=plain_dev,
            library_ms=sdpa_ms, library_device_ms=sdpa_dev)
        r = results[name]
        log(f"  K3/K4 {name:22s} rel err vs plain {max(errs.values()):.2e} "
            f"(tol {tol}), vs SDPA {max(sdpa_errs.values()):.2e} (tol "
            f"{sdpa_tol}), bitwise repeatable; width {r['width']} (D_pad/d "
            f"{r['pad_ratio']:.2f}, {r['smem_bytes']} B smem per CTA); "
            f"dq {dq_ms:.4f} ms (device "
            f"{dq_dev:.4f}, bound {dq_bound:.4f}, {dq_by})  dkv {dkv_ms:.4f} "
            f"ms (device {dkv_dev:.4f}, bound "
            f"{dkv_bound:.4f}, {dkv_by})  plain {plain_ms:.4f} ms (device "
            f"{plain_dev:.4f})  sdpa bwd {sdpa_ms:.4f} ms (device "
            f"{sdpa_dev:.4f}, {sdpa_backend})")
    return results


# ----------------------------------------------------------------- phase 3
def device_ms_beside(fn, plain, match, expect, iters, plain_iters,
                     windows=PROFILER_WINDOWS):
    """Device time per call of ``fn`` (its kernels whose name holds
    ``match``) and of ``plain`` (every other device activity) from one
    ``torch.profiler`` window over ``iters`` calls of ``fn`` and
    ``plain_iters`` of ``plain``, after warm-up calls. A window that did not
    see ``expect`` matching launches per call is taken again, up to
    ``windows`` times. Returns ``(ms, launches per call, plain ms)``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
        plain()
    torch.cuda.synchronize()
    for taken in range(1, windows + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            for _ in range(plain_iters):
                plain()
            torch.cuda.synchronize()
        us = n = other = 0
        for e in prof.key_averages():
            if dev_us(e) > 0 and e.self_cpu_time_total == 0:
                if match in e.key:
                    us += dev_us(e)
                    n += e.count
                else:
                    other += dev_us(e)
        if n > 0 and round(n / iters) == expect:
            break
    note_windows(match, taken)
    check(n > 0, f"profiler saw no device activity ({match}) in {windows} "
                 f"windows")
    return us / 1e3 / iters, n / iters, other / 1e3 / plain_iters


#: phase-3 16-bit tolerances on max|err| / max|o| (``o`` the reference).
#: Against the plain version run on f32-widened copies of the same inputs
#: and rounded to q's dtype (the Pallas kernel's own arithmetic: widen as
#: the pages land, f32 throughout, one rounding of o): one ulp of max|o| in
#: q's dtype, since the two sides may round a value either way of a
#: rounding boundary. Against the plain version at q's dtype (JAX's XLA
#: gather at that dtype: scores, softmax weights and w·V each rounded to
#: 16 bits, int8 pages dequantized in 16 bits), looser: about four times
#: what the plain version at q's dtype reads against its f32-widened run
#: on these cases on the CPU (bf16 up to 0.036 with int8 pools and 0.010
#: with bf16 pools; f16 up to 0.0011).
PAGED16_TOL = {torch.bfloat16: (2.0 ** -7, 2.0 ** -4),
               torch.float16: (2.0 ** -10, 2.0 ** -8)}
#: the same rule at head dims 8 and 16, where the plain f16 version strays
#: further from its f32-widened run: up to 0.0050 of max|o| on
#: PAGED_SMALL_CASES (int8 pages, T=48, page size 8; each case reports it as
#: ``plain_stray``), so its native f16 bound is 2^-6, about three times
#: that (bf16 keeps 2^-4: its stray is at most 0.040 there)
#: The same bound holds past a width of 128 (``WIDE_DIMS`` from 130 on),
#: where the plain f16 version's stray grows with the terms it sums in f16:
#: 4.38e-3 of max|o| at d = 192 over int8 pages, T = 48, on an H100 (over
#: 2^-8 = 3.9e-3, the bound at 32 <= d <= 128).
PAGED16_NATIVE_SMALL_D = {torch.bfloat16: 2.0 ** -4, torch.float16: 2.0 ** -6}
def paged_pool(g, B, H, ps, d, Tmax, quant, dev, dtype=torch.float32):
    """A seeded pool of B·NP + 1 pages (of ``dtype``, or int8 codes with
    scales) and a block table over its pages 1.., row B-1 read from page 0
    only."""
    NP = Tmax // ps
    P = B * NP + 1
    if quant:
        kp = torch.randint(-127, 128, (P, H, ps, d), generator=g,
                           dtype=torch.int8).to(dev)
        vp = torch.randint(-127, 128, (P, H, ps, d), generator=g,
                           dtype=torch.int8).to(dev)
        ks = (torch.rand(P, H, ps, generator=g) * 0.05).to(dev)
        vs = (torch.rand(P, H, ps, generator=g) * 0.05).to(dev)
    else:
        kp = torch.randn(P, H, ps, d, generator=g).to(dev, dtype)
        vp = torch.randn(P, H, ps, d, generator=g).to(dev, dtype)
        ks = vs = None
    bt = (torch.randperm(P - 1, generator=g)[:B * NP] + 1).reshape(
        B, NP).to(torch.int32)
    bt[B - 1] = 0                      # a row read from page 0 only
    return kp, vp, ks, vs, bt.to(dev)


def paged_case(g, T, pool, dev, lean=False, qdtype=torch.float32):
    """One K2 case on ``pool`` with a ``qdtype`` query: against the plain
    version (rows that see no column are checked finite only; a 16-bit
    query against the plain version on f32-widened inputs and at its own
    dtype), two calls bitwise equal, on the chunk route also the other walk
    (unsplit where the rule splits, four ranges where it does not), then
    timed where ``TIMED_CASES`` names it (``lean``: fewer calls). Returns
    (name, measurements)."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.nn.conf.layers import paged_attention as ppa

    kp, vp, ks, vs, bt = pool
    quant = ks is not None
    B, NP = bt.shape
    _P, H, ps, d = kp.shape
    Tmax = NP * ps
    pos = torch.randint(0, Tmax - T + 1, (B,), generator=g)
    pos[1] = (pos[1] // ps) * ps       # exactly on a page boundary
    pos = pos.to(torch.int32).to(dev)
    key_valid = None
    has_valid = torch.ones(B, H, T, 1, dtype=torch.bool, device=dev)
    if T > 1:
        mask = torch.ones(B, T)
        mask[2, 100:] = 0              # right padding
        mask[B - 1] = 0                # all masked, on page 0
        pos[B - 1] = 0
        mask = mask.to(dev)
        key_valid = ppa._key_valid_plane(mask, pos, T, Tmax).float()
        col = torch.arange(Tmax, device=dev)
        row = torch.arange(T, device=dev)
        vis = (col[None, None] <= pos.long()[:, None, None]
               + row[None, :, None]) & (key_valid[:, None] != 0)
        has_valid = vis.any(-1)[:, None, :, None].expand(B, H, T, 1)
    q = torch.randn(B, H, T, d, generator=g).to(dev, qdtype)
    args = (q, kp, vp, bt, pos)
    kw = dict(key_valid=key_valid, kscales=ks, vscales=vs)
    o = ppa.paged_attention(*args, **kw)
    again = ppa.paged_attention(*args, **kw)
    po = ppa.paged_attention_plain(*args, **kw)
    wide = qdtype != torch.float32
    if wide:
        # the Pallas kernel's arithmetic: every value widened to f32, one
        # rounding of o to q's dtype
        pw = ppa.paged_attention_plain(
            q.float(), kp if quant else kp.float(),
            vp if quant else vp.float(), bt, pos, **kw).to(qdtype)
    torch.cuda.synchronize()

    def err_of(x, ref):
        return torch.where(has_valid, (x.float() - ref.float()).abs(),
                           torch.zeros_like(x, dtype=torch.float32)
                           ).max().item()

    def top(ref):
        return torch.where(has_valid, ref.float().abs(),
                           torch.zeros_like(ref, dtype=torch.float32)
                           ).max().item()

    qtag = "" if qdtype == torch.float32 else DTYPE_TAG[qdtype]
    kvtag = "int8" if quant else DTYPE_TAG[kp.dtype]
    name = (f"{kvtag}{qtag if quant else ''}_T{T}_Tmax{Tmax}"
            + (f"_d{d}" if d != 32 else "") + (f"_ps{ps}" if ps != 16 else ""))
    timed = name in TIMED_CASES
    check(o.dtype == qdtype and torch.isfinite(o.float()).all().item(),
          f"K2 {name}: dtype or non-finite output (garbage page or masked "
          f"row)")
    if wide:
        rtol_w, rtol_n = PAGED16_TOL[qdtype]
        if d < 32 or d > 128:
            rtol_n = PAGED16_NATIVE_SMALL_D[qdtype]
        ref = pw
        atol = rtol_w * top(pw)
        native_err = err_of(o, po)
        native_atol = rtol_n * top(po)
        plain_stray = err_of(po, pw) / max(top(pw), 1e-30)
        check(native_err <= native_atol,
              f"K2 {name}: max |err| vs the plain version at "
              f"{DTYPE_TAG[qdtype]} {native_err:.3g} > {native_atol:.3g}")
    else:
        ref = po
        atol = 1e-3 if quant else 1e-4
        native_err = native_atol = plain_stray = None
    err = err_of(o, ref)
    check(err <= atol, f"K2 {name}: max |err| {err:.3g} > {atol:.3g}")
    check(torch.equal(o, again),
          f"K2 {name}: two calls differ (not deterministic)")
    # the route K2 takes: T <= 4 decode, else chunk
    route = "decode" if T <= ppa.DECODE_MAX_T else "chunk"
    splits, other, smem = 1, None, None
    if route == "chunk":
        ext = kernels.load()
        kind = ppa.pool_kind(kp)
        splits = ext.paged_attn_splits(B, H, T, d, ps, NP, kind)
        smem = ext.paged_chunk_smem(d, kind, NP)
        forced = 1 if splits > 1 else 4
        ow = ext.paged_attn(q, kp, vp, ks, vs, bt, pos, key_valid, forced)
        torch.cuda.synchronize()
        other = dict(splits=forced, max_abs_err=err_of(ow, ref))
        check(torch.isfinite(ow.float()).all().item()
              and other["max_abs_err"] <= atol,
              f"K2 {name} with {forced} split(s): max |err| "
              f"{other['max_abs_err']:.3g} > {atol:.3g} or non-finite")
    width = (kernels.decode_width(d) if route == "decode"
             else kernels.kernel_width(d))
    if not timed:
        log(f"  K2 {name:24s} {route:6s} width {width} err {err:.2e} (atol "
            f"{atol:.2e})"
            + ("" if native_err is None else
               f", at {DTYPE_TAG[qdtype]} {native_err:.2e} (atol "
               f"{native_atol:.2e})")
            + ("" if plain_stray is None else
               f" (plain stray {plain_stray:.2e} of max|o|)")
            + ", bitwise repeatable"
            + ("" if other is None else
               f" ({splits} split(s); {other['splits']}: err "
               f"{other['max_abs_err']:.2e})"))
        return name, dict(
            B=B, H=H, T=T, d=d, width=width, pad_ratio=width / d, ps=ps,
            Tmax=Tmax, quant=quant, dtype=DTYPE_TAG[qdtype],
            pool_dtype=kvtag, route=route, splits=splits, smem_bytes=smem,
            max_abs_err=err, max_rel_err=err / max(top(ref), 1e-30),
            tolerance=atol, native_max_abs_err=native_err,
            native_tolerance=native_atol, plain_stray=plain_stray,
            deterministic=True, other_walk=other, ms=None, device_ms=None,
            plain_ms=None, plain_device_ms=None, bound_ms=None,
            bound_by=None, library_ms=None)
    kernel = lambda: ppa.paged_attention(*args, **kw)  # noqa: E731
    plain = lambda: ppa.paged_attention_plain(*args, **kw)  # noqa: E731
    ms = time_ms(kernel, iters=20 if lean else 50)
    plain_ms = time_ms(plain, iters=5 if lean else 20)
    # per call: the chunk route's split walk is two launches (walk, merge)
    kdev, per_call, plain_dev = device_ms_beside(
        kernel, plain, "paged_", 2 if splits > 1 else 1,
        iters=10 if lean else 20, plain_iters=3 if lean else 5)
    # bytes this run's data needs: each distinct (page, offset) K/V slot
    # the rows walk, read once (row B-1 walks page 0 over and over: its ps
    # slots count once) at the pool's element size (and int8's two f32
    # scales), the walked block-table entries and plane columns, q and o at
    # q's element size, and pos
    lim = torch.clamp(pos.long() + T, max=Tmax).tolist()
    btc = bt.long().cpu()
    slots = torch.cat([btc[b, torch.arange(n) // ps] * ps
                       + torch.arange(n) % ps for b, n in enumerate(lim)])
    distinct = torch.unique(slots).numel()
    kv_row = d * kp.element_size() + (4 if quant else 0)
    nbytes = 2 * distinct * H * kv_row + 2 * B * H * T * d * q.element_size() \
        + sum(-(-n // ps) for n in lim) * 4 + B * 4 \
        + (sum(lim) * 4 if T > 1 else 0)
    flops = 4 * d * H * sum(sum(min(p + r + 1, Tmax) for r in range(T))
                            for p in pos.tolist())
    bms, by = bound_ms(nbytes, flops,
                       "bf16" if kp.element_size() == 2 else "f32")
    res = dict(B=B, H=H, T=T, d=d, width=width, pad_ratio=width / d,
               ps=ps, Tmax=Tmax, quant=quant,
               dtype=DTYPE_TAG[qdtype], pool_dtype=kvtag, route=route,
               splits=splits, smem_bytes=smem, max_abs_err=err,
               max_rel_err=err / max(top(ref), 1e-30), tolerance=atol, native_max_abs_err=native_err,
               native_tolerance=native_atol, plain_stray=plain_stray,
               deterministic=True,
               other_walk=other, ms=ms, device_ms=kdev,
               device_launches_per_call=per_call, plain_ms=plain_ms,
               plain_device_ms=plain_dev, bound_ms=bms, bound_by=by,
               bound_bytes=nbytes, library_ms=None)
    extra = "" if other is None else (
        f" ({splits} split(s); {other['splits']}: err "
        f"{other['max_abs_err']:.2e}; {smem} B smem per CTA)")
    native = "" if native_err is None else (
        f", at {DTYPE_TAG[qdtype]} {native_err:.2e} (atol "
        f"{native_atol:.2e})")
    log(f"  K2 {name:24s} {route:6s} width {width} err {err:.2e} (atol "
        f"{atol:.2e}){native}, bitwise repeatable{extra}; kernel {ms:.4f} "
        f"ms (device "
        f"{kdev:.4f})  plain {plain_ms:.4f} ({plain_dev:.4f})  bound "
        f"{bms:.4f} ms ({by})")
    return name, res


# phase-3 chunk-route cases added with its tensor-core design: (T, d, ps,
# quant) at Tmax 512, beside the decode/chunk boundary and 256-row cases:
# the serve's second-round bucket (48), one full q tile (64), two q tiles
# with a ragged second (100), the wide heads (d = 64, 128) and a page size
# other than 16
PAGED_EXTRA = [(48, 32, 16, False), (48, 32, 16, True), (64, 32, 16, False),
               (100, 32, 16, False), (100, 32, 16, True),
               (256, 64, 16, False), (256, 64, 16, True),
               (256, 128, 16, False), (256, 128, 16, True),
               (100, 32, 8, False)]
# phase-3 16-bit cases: (q dtype, int8 pools, T, d, ps) at Tmax 512:
# both routes (T = 1, 4 decode; 5, 48, 256 chunk) at the slice's d=32 in
# bf16, and f16 and int8-under-bf16 at the same T; d = 64, 128 and ps 8
PAGED16_CASES = (
    [(torch.bfloat16, False, T, 32, 16) for T in (1, 4, 5, 48, 256)]
    + [(torch.float16, False, T, 32, 16) for T in (1, 4, 5, 48, 256)]
    + [(torch.bfloat16, True, T, 32, 16) for T in (1, 4, 5, 48, 256)]
    + [(dt, False, T, d, 16) for dt in (torch.bfloat16, torch.float16)
       for d in (64, 128) for T in (1, 256)]
    + [(torch.bfloat16, True, 256, 128, 16), (torch.bfloat16, False, 100, 32, 8),
       (torch.float16, False, 48, 32, 8)])
# phase-3 head dims 8 and 16 (the JAX package's small models): every query
# dtype over pages of its own dtype and over int8 pages, at T = 1, 4
# (decode route), 5, 48, 256 (chunk route) with page size 16, and T = 1, 48
# with page size 8: (q dtype, int8 pools, T, d, ps) at Tmax 512
PAGED_SMALL_CASES = [
    (dt, quant, T, d, ps) for d in (8, 16)
    for dt in (torch.float32, torch.bfloat16, torch.float16)
    for quant in (False, True)
    for T, ps in ((1, 16), (4, 16), (5, 16), (48, 16), (256, 16), (1, 8),
                  (48, 8))]


# phase-3 padded head dims (kernels/common.cuh): f32 and bf16 queries over
# pages of their dtype and over int8 pages, T = 1, 4 (decode route, padded
# to a power of two), 5, 48, 256 (chunk route, padded to the next kernel
# width) at page size 16, and T = 1, 48 at page size 8 for d = 48: (q dtype,
# int8 pools, T, d, ps) at Tmax 512
PAGED_PAD_CASES = [
    (dt, quant, T, d, 16) for d in PAGED_PAD_DIMS
    for dt in (torch.float32, torch.bfloat16) for quant in (False, True)
    for T in (1, 4, 5, 48, 256)] + [
    (dt, quant, T, 48, 8) for dt in (torch.float32, torch.bfloat16)
    for quant in (False, True) for T in (1, 48)]


# phase-3 cases at the head dims of WIDE_DIMS: (q dtype, int8 pools, T, d)
# at B = 4, H = 4, Tmax 256, page size 16: every query dtype over its own
# and int8 pages at T = 1, 4 (decode route) and 48 (chunk route), and at
# WIDE_TIMED_DIMS the f32 chunk route at T = 256
WIDE_PAGED_CASES = [
    (dt, quant, T, d) for d in WIDE_DIMS
    for dt in (torch.float32, torch.bfloat16, torch.float16)
    for quant in (False, True) for T in (1, 4, 48)] + [
    (torch.float32, False, 256, d) for d in WIDE_TIMED_DIMS]
# phase-3 cases at phase 21's serve (GPT-J-6B's 16 heads of d = 256, 8
# slots, Tmax 512): (q dtype, int8 pools, T)
GPTJ_PAGED_CASES = [(torch.float32, False, 1), (torch.float32, False, 256),
                    (torch.float32, True, 1), (torch.bfloat16, False, 1)]


#: the cases of phases 2, 3 and 6 that are timed, by name (a phase times
#: its own case of a name here): the ones the kernels line and PERF.md
#: read. Every other case is checked and not timed.
TIMED_CASES = frozenset(
    # phases 2 and 6: the slice's f32 case, the bench shape, f16 at the
    # slice's shape, each head dim's f32 case (causal; under a key mask at
    # WIDE_TIMED_DIMS), phase 21's shapes
    {"slice_f32_causal", "bench_bf16_causal", "slice_f16_causal",
     "gptj_f32_causal", "gptj_train_f32_causal"}
    | {f"d{d}_f32_causal" for d in (8, 16) + PAD_DIMS}
    | {f"d{d}_f32_causal_mask" for d in WIDE_TIMED_DIMS}
    # phase 3: d = 32 at both Tmax over f32 and int8 pages, 16-bit queries,
    # the padded head dims' f32 decode and chunk steps, WIDE_TIMED_DIMS'
    # f32 decode and chunk steps, phase 21's serve shapes
    | {f"{kv}_T{T}_Tmax{Tmax}" for kv in ("f32", "int8")
       for T in (1, 4, 5, 256) for Tmax in (512, 2048)}
    | {"f32_T48_Tmax512", "bf16_T1_Tmax512", "bf16_T256_Tmax512",
       "f16_T1_Tmax512", "f16_T256_Tmax512"}
    | {f"f32_T{T}_Tmax512_d{d}" for T in (1, 256)
       for d in (8, 16) + PAGED_PAD_DIMS}
    | {f"f32_T{T}_Tmax256_d{d}" for T in (1, 256) for d in WIDE_TIMED_DIMS}
    | {f"{kv}_T{T}_Tmax512_d256" for kv, T in (
        ("f32", 1), ("f32", 256), ("int8", 1), ("bf16", 1))})


def phase_paged(dev):
    g = torch.Generator(device="cpu").manual_seed(2)
    results = {}
    B, H, ps, d = 8, 8, 16, 32
    for Tmax in (512, 2048):
        for quant in (False, True):
            pool = paged_pool(g, B, H, ps, d, Tmax, quant, dev)
            for T in (1, 4, 5, 256):
                name, res = paged_case(g, T, pool, dev)
                results[name] = res
    g = torch.Generator(device="cpu").manual_seed(5)
    for T, d, ps, quant in PAGED_EXTRA:
        pool = paged_pool(g, B, H, ps, d, 512, quant, dev)
        name, res = paged_case(g, T, pool, dev, lean=True)
        results[name] = res
    g = torch.Generator(device="cpu").manual_seed(12)
    for qdtype, quant, T, d, ps in PAGED16_CASES:
        pool = paged_pool(g, B, H, ps, d, 512, quant, dev, dtype=qdtype)
        name, res = paged_case(g, T, pool, dev, lean=True, qdtype=qdtype)
        results[name] = res
    g = torch.Generator(device="cpu").manual_seed(13)
    for qdtype, quant, T, d, ps in PAGED_SMALL_CASES:
        pool = paged_pool(g, B, H, ps, d, 512, quant, dev, dtype=qdtype)
        name, res = paged_case(g, T, pool, dev, lean=True, qdtype=qdtype)
        results[name] = res
    g = torch.Generator(device="cpu").manual_seed(14)
    for qdtype, quant, T, d, ps in PAGED_PAD_CASES:
        pool = paged_pool(g, B, H, ps, d, 512, quant, dev, dtype=qdtype)
        name, res = paged_case(g, T, pool, dev, lean=True, qdtype=qdtype)
        results[name] = res
    results.update(paged_wide_cases(dev))
    return results


def paged_wide_cases(dev):
    """Phase 3 at the head dims of ``WIDE_DIMS`` (``WIDE_PAGED_CASES``, one
    pool per head dim, query dtype and pool kind) and at phase 21's serve
    shape (``GPTJ_PAGED_CASES``, names prefixed ``gptj_``)."""
    g = torch.Generator(device="cpu").manual_seed(21)
    results, pools = {}, {}
    for qdtype, quant, T, d in WIDE_PAGED_CASES:
        key = (qdtype, quant, d)
        if key not in pools:
            pools[key] = paged_pool(g, 4, 4, 16, d, 256, quant, dev,
                                    dtype=qdtype)
        name, res = paged_case(g, T, pools[key], dev, lean=True,
                               qdtype=qdtype)
        results[name] = res
    pools.clear()
    for qdtype, quant, T in GPTJ_PAGED_CASES:
        pool = paged_pool(g, 8, 16, 16, 256, 512, quant, dev, dtype=qdtype)
        name, res = paged_case(g, T, pool, dev, lean=True, qdtype=qdtype)
        results["gptj_" + name] = res
    return results


# --------------------------------------------------------------- the model
def numpy_params(net, seed, gain=2.0):
    """Seeded weights drawn with numpy, at a gain that keeps the greedy
    streams varied."""
    rs = np.random.RandomState(seed)
    out = {}
    for v, p in net.params.items():
        out[v] = {}
        for k, t in p.items():
            shp = tuple(t.shape)
            if k.startswith("W"):
                a = rs.randn(*shp) * gain / np.sqrt(shp[0])
            elif k == "gamma":
                a = 1.0 + 0.1 * rs.randn(*shp)
            else:
                a = 0.1 * rs.randn(*shp)
            out[v][k] = a.astype(np.float32)
    return out


def build_nets():
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.utils.convert import params_from_jax

    net = TransformerLM(**SLICE).init(device="cuda")
    params = numpy_params(net, seed=0)
    params_from_jax(params, net)
    cpu = TransformerLM(**SLICE).init(device="cpu")
    params_from_jax(params, cpu)
    return net, cpu


def phase_model(net, cpu):
    from deeplearning4j_torch import kernels

    rs = np.random.RandomState(3)
    V, T = SLICE["num_labels"], SLICE["max_length"]
    x = np.eye(V, dtype=np.float32)[rs.randint(0, V, (8, T))]
    before = kernels.LAUNCHES["flash_fwd"]
    out = net.output(x)
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["flash_fwd"] - before
    ref = cpu.output(x)
    err = (out.cpu() - ref).abs().max().item()
    check(out.shape == (8, T, V) and torch.isfinite(out).all().item(),
          "model: output shape or non-finite values")
    check(err <= 1e-4, f"model: output() vs CPU plain path max |err| "
                       f"{err:.3g} > 1e-4")
    check(launches == SLICE["n_blocks"],
          f"model: K1 launched {launches} times in one output(), expected "
          f"{SLICE['n_blocks']}")
    with torch.inference_mode():
        ms = time_ms(lambda: net.output(x), iters=20)
    log(f"  output() [8, {T}, {V}]: max |err| vs CPU {err:.2e}, K1 "
        f"launches {launches}, {ms:.3f} ms")
    return dict(max_abs_err=err, k1_launches=launches, output_ms=ms)


def serve(net, reqs, vocab=SLICE["num_labels"], **kw):
    """Serve ``reqs``, each ``(prompt, max_tokens)`` or ``(prompt,
    max_tokens, sampling options)``, through one ``GenerationServer`` on
    the card. Returns (token lists, wall seconds, stats); the stats carry
    the server's prefill-round count as ``prefill_rounds``."""
    from deeplearning4j_torch.parallel.generation import GenerationServer

    srv = GenerationServer(net, vocab, device="cuda", **dict(SERVER, **kw))
    try:
        t0 = time.perf_counter()
        futs = [srv.submit(r[0], r[1], **(r[2] if len(r) > 2 else {}))
                for r in reqs]
        outs = [f.result(timeout=600).tolist() for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = server_stats(srv)
    finally:
        srv.close()
    return outs, wall, stats


def server_stats(srv):
    """``srv.stats()`` with the prefill-round count (which the JAX
    server's surface does not carry) beside it, and the peak pages in use
    from the peak resident bytes."""
    st = srv.stats()
    pg = st["pages"]
    pg["peak_pages"] = pg["peak_resident_kv_bytes"] // (
        pg["bytes_per_token"] * pg["page_size"])
    return dict(st, prefill_rounds=srv._prefill_rounds)


def serve_requests():
    """The phase-5 requests: seeded prompts of SERVE_LENS tokens, 32 new
    tokens each."""
    rs = np.random.RandomState(4)
    return [(rs.randint(0, SLICE["num_labels"], n), 32) for n in SERVE_LENS]


def first_divergence(got, want):
    return next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                None)


def phase_serve(net, card):
    from deeplearning4j_torch import kernels

    reqs = serve_requests()
    serve(net, reqs[:2])                              # warm-up
    results = {}
    for kv in (None, "int8"):
        tag = kv or "f32"
        before = kernels.LAUNCHES["paged_attn"]
        before_chunk = kernels.LAUNCHES["paged_attn_chunk"]
        outs, wall, st = serve(net, reqs, kv_dtype=kv)
        launches = kernels.LAUNCHES["paged_attn"] - before
        chunk = kernels.LAUNCHES["paged_attn_chunk"] - before_chunk
        expect = SLICE["n_blocks"] * (st["prefill_rounds"]
                                      + SERVER["steps_per_dispatch"]
                                      * st["decode_steps"])
        check(launches == expect and launches > 0,
              f"serve {tag}: K2 launched {launches} times, the schedule "
              f"needs {expect}")
        check(chunk == SLICE["n_blocks"] * st["prefill_rounds"],
              f"serve {tag}: K2's chunk route launched {chunk} times for "
              f"{st['prefill_rounds']} prefill rounds")
        ref, ref_wall, _ = serve(net, reqs, kv_dtype=kv,
                                 paged_attention="stock")
        for i, (got, want) in enumerate(zip(outs, ref)):
            if got != want:
                k = first_divergence(got, want)
                gap = top2_gap(net, reqs[i][0], want[:k])
                raise AssertionError(
                    f"serve {tag}: request {i} diverges from the stock "
                    f"server at token {k} ({got[k]} vs {want[k]}); top-2 "
                    f"log-prob gap there {gap:.3g}")
        ntok = sum(len(o) for o in outs)
        check(all(len(o) == 32 for o in outs), f"serve {tag}: short output")
        check(len({t for o in outs for t in o}) > 4,
              f"serve {tag}: degenerate greedy streams")
        results[tag] = dict(requests=len(reqs), tokens=ntok, wall_s=wall,
                            tokens_per_s=ntok / wall, stock_wall_s=ref_wall,
                            stock_tokens_per_s=ntok / ref_wall,
                            k2_launches=launches, k2_chunk_launches=chunk,
                            prefill_rounds=st["prefill_rounds"],
                            decode_steps=st["decode_steps"], streams=outs)
        log(f"  serve {tag}: {len(reqs)} requests, {ntok} tokens in "
            f"{wall:.3f} s = {ntok / wall:.1f} tok/s (stock paged read: "
            f"{ntok / ref_wall:.1f} tok/s); K2 launches {launches} "
            f"({st['prefill_rounds']} prefill rounds, {st['decode_steps']} "
            f"decode dispatches); tokens equal to stock; [{card}]")
    return results


def phase_zip(net, greedy, card):
    """Phase 4b: the full-width net through the port's model zip: saved
    with ``save_model`` (``coefficients.bin`` must be ``params_flat()`` as
    little-endian f32, byte for byte), loaded back with
    ``load_model(..., device="cuda")``, its ``output()`` on the phase-4
    probe bitwise the in-memory net's (same kernels, same parameters), and
    its greedy serve of the phase-5 requests token for token phase 5's
    (``greedy``). Returns (the loaded net, measurements)."""
    import tempfile

    from deeplearning4j_torch.utils.model_serializer import (load_model,
                                                             save_model)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "transformer_lm.zip")
        t0 = time.perf_counter()
        save_model(net, path)
        save_s = time.perf_counter() - t0
        with zipfile.ZipFile(path) as zf:
            coeff = zf.read("coefficients.bin")
            entries = sorted(zf.namelist())
        zip_bytes = os.path.getsize(path)
        check(coeff == net.params_flat().astype("<f4").tobytes(),
              "zip: coefficients.bin differs from params_flat() as <f4")
        t0 = time.perf_counter()
        loaded = load_model(path, device="cuda")
        load_s = time.perf_counter() - t0
    check(loaded.device.type == "cuda" and all(
        t.device.type == "cuda" for p in loaded.params.values()
        for t in p.values()), "zip: load_model(device='cuda') left a "
                              "parameter off the card")
    rs = np.random.RandomState(3)
    V, T = SLICE["num_labels"], SLICE["max_length"]
    x = np.eye(V, dtype=np.float32)[rs.randint(0, V, (8, T))]
    out, want = loaded.output(x), uncounted(net.output, x)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    check(torch.equal(out, want), f"zip: the loaded net's output() differs "
                                  f"from the in-memory net's (max |err| "
                                  f"{err:.3g})")
    outs, wall, _ = serve(loaded, serve_requests())
    check(outs == greedy, "zip: the loaded net's greedy serve differs from "
                          "phase 5's tokens")
    ntok = sum(len(o) for o in outs)
    log(f"  zip: {zip_bytes} bytes {entries}; coefficients.bin == "
        f"params_flat() as <f4; saved in {save_s:.3f} s, loaded on the card "
        f"in {load_s:.3f} s; output() bitwise equal; {len(outs)} greedy requests "
        f"equal to phase 5's ({ntok / wall:.1f} tok/s); [{card}]")
    return loaded, dict(zip_bytes=zip_bytes, entries=entries, save_s=save_s,
                        load_s=load_s, output_bitwise=True,
                        serve_tokens_equal=True, tokens_per_s=ntok / wall)


#: phase-5b sampling: the phase-5 prompts, odd ones sampled at this
#: temperature and top_k, each with its own seed
SAMPLED = dict(temperature=0.8, top_k=40)


def sampled_requests():
    """The phase-5 requests, the odd ones sampled (``SAMPLED``, seed
    1000 + i)."""
    return [(p, n, dict(SAMPLED, seed=1000 + i) if i % 2 else {})
            for i, (p, n) in enumerate(serve_requests())]


def phase_sampled(net, greedy, f32_tok_s, card):
    """Phase 5b: the phase-5 prompts as one mixed batch, 8 greedy and 8
    sampled (``SAMPLED``, seeds 1000 + i), f32 KV: the kernel server's
    streams equal the plain-read server's (``paged_attention="xla"``)
    token for token, a second identical serve repeats them, and the greedy
    requests equal phase 5's."""
    reqs = sampled_requests()
    outs, wall, st = serve(net, reqs)
    again, wall2, _ = serve(net, reqs)
    ref, ref_wall, _ = serve(net, reqs, paged_attention="xla")
    for i, (got, want) in enumerate(zip(outs, ref)):
        if got != want:
            k = first_divergence(got, want)
            gap = top2_gap(net, reqs[i][0], want[:k])
            raise AssertionError(
                f"sampled serve: request {i} diverges from the plain-read "
                f"server at token {k} ({got[k]} vs {want[k]}); top-2 "
                f"log-prob gap there {gap:.3g}")
    check(again == outs, "sampled serve: a second identical serve differs")
    check(all(outs[i] == greedy[i] for i in range(0, len(reqs), 2)),
          "sampled serve: a greedy request differs from phase 5's tokens")
    check(any(outs[i] != greedy[i] for i in range(1, len(reqs), 2)),
          "sampled serve: every sampled stream equals its greedy one")
    ntok = sum(len(o) for o in outs)
    log(f"  sampled serve f32: {(len(reqs) + 1) // 2} greedy + "
        f"{len(reqs) // 2} sampled (T={SAMPLED['temperature']}, top_k="
        f"{SAMPLED['top_k']}), {ntok} tokens in {wall:.3f} s = "
        f"{ntok / wall:.1f} tok/s (again {ntok / wall2:.1f}; plain read "
        f"{ntok / ref_wall:.1f}; phase 5 greedy {f32_tok_s:.1f}); equal to "
        f"the plain-read server and repeatable, greedy equal to phase 5; "
        f"[{card}]")
    return dict(requests=len(reqs), tokens=ntok, wall_s=wall,
                tokens_per_s=ntok / wall, again_tokens_per_s=ntok / wall2,
                plain_tokens_per_s=ntok / ref_wall,
                greedy_tokens_per_s=f32_tok_s,
                decode_steps=st["decode_steps"], streams=outs)


#: phase-5c near-tie rule: a bf16 model's greedy stream may leave the
#: plain-read server's only at a position whose own top-2 logit gap is
#: within the spread two right reads of the model give that gap (the
#: spread compares full-sequence reads, so it already holds the drift that
#: earlier positions carry). The spread is measured in the phase: the
#: largest change of the top-2 gap, over every position of the served
#: sequences, between a forward whose attention
#: rounds scores, weights and products to bf16 (``helper="stock"``, the
#: plain read's arithmetic) and one whose attention computes in f32 (K1,
#: as K2 does). A fixed gap of 2^-4 is too tight: on an H100 a stream left
#: the plain read's at a gap of 0.0681, and on the CPU the spread of this
#: model reads 0.125 over 1,327 positions (PERF.md §6). A spread over this
#: cap fails the phase (the plain read itself would be off).
NEAR_TIE_CAP = 2.0 ** -2


def logits_of(net, seq):
    """``[len(seq), V]`` f32 output logits (the output layer's
    preactivations) of one full-sequence forward of ``seq``."""
    V = SLICE["num_labels"]
    dtype = getattr(torch, net.conf.dtype)
    x = torch.from_numpy(np.eye(V, dtype=np.float32)[np.asarray(seq)][None]
                         ).to(net.device, dtype)
    with torch.inference_mode():
        _, _, _, ins = net._forward(net.params, net.state, [x], [None],
                                    collect_loss_inputs=True)
        out = net.conf.vertices["output"].layer.preactivate(
            net.params["output"], ins["output"])
    return out[0].float()


def top2_gap(net, prompt, tokens):
    """The gap between the two largest output logits after ``prompt +
    tokens`` (the top-2 log-prob gap, read before the softmax rounds) from
    a full-sequence forward, to show how close a divergence was."""
    seq = np.concatenate([np.asarray(prompt), np.asarray(tokens, np.int64)])
    top = torch.topk(logits_of(net, seq)[-1], 2).values
    return (top[0] - top[1]).item()


#: > 0 while a comparison run (``uncounted``) is in progress: the plain
#: attention functions may run on the card then (``plain_guard``)
COMPARING = [0]


def uncounted(fn, *args, **kw):
    """``fn(*args, **kw)`` with the kernels' launch counters left as they
    were: the comparison runs of a check are not the main path's
    launches."""
    from deeplearning4j_torch import kernels

    before = dict(kernels.LAUNCHES)
    before_d = dict(kernels.LAUNCHES_BY_D)
    COMPARING[0] += 1
    try:
        return fn(*args, **kw)
    finally:
        COMPARING[0] -= 1
        kernels.LAUNCHES.update(before)
        kernels.LAUNCHES_BY_D.clear()
        kernels.LAUNCHES_BY_D.update(before_d)


def gap_spread(net, seqs):
    """The largest change of the top-2 logit gap over every position of
    ``seqs`` between the bf16-rounding attention (``helper="stock"``) and
    K1's f32 attention, the same two tokens compared."""
    layers = [v.layer for v in net.conf.vertices.values()
              if getattr(getattr(v, "layer", None), "helper", None)]
    spread = 0.0
    for seq in seqs:
        for layer in layers:
            layer.helper = "stock"
        try:
            a = logits_of(net, seq)
        finally:
            for layer in layers:
                layer.helper = "auto"
        b = logits_of(net, seq)
        idx = torch.topk(a, 2, dim=-1).indices
        ga = a.gather(1, idx[:, :1]) - a.gather(1, idx[:, 1:])
        gb = b.gather(1, idx[:, :1]) - b.gather(1, idx[:, 1:])
        spread = max(spread, (ga - gb).abs().max().item())
    return spread


def phase_bf16(params, card):
    """Phase 5c (fault C1): ``TransformerLM(dtype="bfloat16")`` at full
    width, the phase-4 f32 weights cast to bf16, serves the phase-5
    requests greedy through K2 with default knobs, bf16 and int8 KV. Each
    stream equals the plain-read bf16 server's, or leaves it at a position
    where the plain stream's own top-2 logit gap is within the gap spread of
    two right reads of the model (``gap_spread``, measured on the served
    sequences); identical requests and each divergence (position, gap) are
    reported."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.utils.convert import params_from_jax

    net = TransformerLM(dtype="bfloat16", **SLICE).init(device="cuda")
    params_from_jax(params, net)
    check(net.params["attn0"]["Wq"].dtype == torch.bfloat16,
          "bf16: the model's weights are not bf16")
    reqs = serve_requests()
    results = {}
    for kv in (None, "int8"):
        tag = "bf16" if kv is None else "int8"
        before = kernels.LAUNCHES["paged_attn"]
        outs, wall, st = serve(net, reqs, kv_dtype=kv)
        launches = kernels.LAUNCHES["paged_attn"] - before
        check(launches == SLICE["n_blocks"] * (
            st["prefill_rounds"] + SERVER["steps_per_dispatch"]
            * st["decode_steps"]),
            f"bf16 serve {tag}: K2 launched {launches} times")
        ref, ref_wall, _ = serve(net, reqs, kv_dtype=kv,
                                 paged_attention="xla")
        check(all(len(o) == 32 for o in outs), f"bf16 serve {tag}: short "
                                               f"output")
        spread = uncounted(gap_spread, net, [
            np.concatenate([p, w]) for (p, _), w in zip(reqs, ref)])
        check(spread <= NEAR_TIE_CAP, f"bf16 serve {tag}: two reads of the "
                                      f"model move the top-2 gap by "
                                      f"{spread:.4f} > {NEAR_TIE_CAP}")
        divergences = []
        for i, (got, want) in enumerate(zip(outs, ref)):
            k = first_divergence(got, want)
            if k is None:
                continue
            gap = uncounted(top2_gap, net, reqs[i][0], want[:k])
            divergences.append(dict(request=i, position=k, gap=gap,
                                    tokens=[got[k], want[k]]))
            check(gap <= spread, f"bf16 serve {tag}: request {i} diverges "
                                 f"at token {k} ({got[k]} vs {want[k]}) at "
                                 f"a top-2 logit gap of {gap:.4f}, over the "
                                 f"spread {spread:.4f}")
        ntok = sum(len(o) for o in outs)
        same = len(reqs) - len(divergences)
        results[tag] = dict(tokens=ntok, wall_s=wall, tokens_per_s=ntok / wall,
                            plain_tokens_per_s=ntok / ref_wall,
                            k2_launches=launches, identical_requests=same,
                            divergences=divergences, gap_spread=spread)
        log(f"  bf16 model, {tag} KV: {len(reqs)} greedy requests served "
            f"through K2 "
            f"({launches} launches), {ntok / wall:.1f} tok/s (plain read "
            f"{ntok / ref_wall:.1f}); {same}/{len(reqs)} identical to the "
            f"plain-read server; gap spread of two reads {spread:.4f}; "
            f"divergences (request, token, top-2 logit gap there): "
            f"{[(d['request'], d['position'], round(d['gap'], 5)) for d in divergences]}; "
            f"[{card}]")
    return results


# ---------------------------------------------------------------- phase 4c
FIXTURE = os.path.join("tests", "fixtures", "regression_transformer_r5.zip")
FIXTURE_EXPECTED = os.path.join("tests", "fixtures",
                                "regression_transformer_r5_expected.npz")
#: phase-4c serve: prompt lengths on both K2 routes' sides (decode after a
#: short prefill, chunked prefill of 40 and 70 tokens), 12 new tokens each
FIXTURE_SERVE_LENS = [3, 9, 20, 40, 70]
FIXTURE_TRAIN_STEPS = 3


def fixture_batch(V, T, dev=None):
    """The seeded phase-4c training batch: 4 sequences of T one-hot tokens
    and their next-token labels."""
    rs = np.random.RandomState(10)
    tok = rs.randint(0, V, (4, T + 1))
    eye = np.eye(V, dtype=np.float32)
    x, y = eye[tok[:, :-1]], eye[tok[:, 1:]]
    if dev is None:
        return torch.from_numpy(x), torch.from_numpy(y)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def phase_fixture(card):
    """Phase 4c: the JAX package's committed d=8 fixture (TransformerLM,
    d_model 16, 2 heads of d=8, one block) loaded onto the card with
    ``load_model(..., device="cuda")``: ``output()`` on the npz's probe
    within atol 1e-5 of its ``output`` (``tests/test_format_regression.py``'s
    own tolerance) through K1; a greedy serve token for token the plain-read
    server's through K2 at d=8 (both routes); three Adam ``do_step``s
    against the CPU plain path from the same zip (first-step gradients
    within 1e-4 of max|g|, losses within rtol 1e-4) through K3 and K4."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.optimize.fused_fit import value_and_grad
    from deeplearning4j_torch.utils.model_serializer import load_model

    exp = np.load(FIXTURE_EXPECTED)
    net = load_model(FIXTURE, device="cuda")
    layer = net.conf.vertices["attn0"].layer
    d = layer.n_out // layer.n_heads
    check(d == 8, f"fixture: head dim {d}, expected 8")
    before = dict(kernels.LAUNCHES)
    out = net.output(exp["probe"])
    torch.cuda.synchronize()
    k1 = kernels.LAUNCHES["flash_fwd"] - before["flash_fwd"]
    err = float(np.abs(out.cpu().numpy() - exp["output"]).max())
    check(err <= 1e-5, f"fixture: output() vs the committed output max "
                       f"|err| {err:.3g} > 1e-5")
    check(k1 >= 1, "fixture: output() did not launch K1")

    V = exp["probe"].shape[-1]
    rs = np.random.RandomState(9)
    reqs = [(rs.randint(0, V, n), 12) for n in FIXTURE_SERVE_LENS]
    before = dict(kernels.LAUNCHES)
    outs, wall, st = serve(net, reqs, vocab=V)
    k2 = {k: kernels.LAUNCHES[k] - before[k]
          for k in ("paged_attn", "paged_attn_chunk")}
    ref, ref_wall, _ = uncounted(serve, net, reqs, V,
                                 paged_attention="stock")
    for i, (got, want) in enumerate(zip(outs, ref)):
        check(got == want, f"fixture serve: request {i} diverges from the "
                           f"plain-read server at token "
                           f"{first_divergence(got, want)}")
    check(all(len(o) == 12 for o in outs), "fixture serve: short output")
    check(k2["paged_attn"] > k2["paged_attn_chunk"] > 0,
          f"fixture serve: K2 launches {k2} miss a route")

    cpu = load_model(FIXTURE, device="cpu")
    T = exp["probe"].shape[1]
    x, y = fixture_batch(V, T)
    xd, yd = fixture_batch(V, T, net.device)
    loss_d, g_d = value_and_grad(net, net.params, net.state, [xd], [yd])
    loss_c, g_c = value_and_grad(cpu, cpu.params, cpu.state, [x], [y])
    grad_err = max(((g_d[v][p].cpu() - g_c[v][p]).abs().max()
                    / g_c[v][p].abs().max()).item()
                   for v in g_c for p in g_c[v])
    check(grad_err <= 1e-4, f"fixture train: first-step gradients card vs "
                            f"CPU, worst leaf max|err|/max|g| "
                            f"{grad_err:.3g}")
    before = dict(kernels.LAUNCHES)
    card_losses = [float(net.do_step(xd, yd)[0])
                   for _ in range(FIXTURE_TRAIN_STEPS)]
    bwd = {k: kernels.LAUNCHES[k] - before[k]
           for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    cpu_losses = [float(cpu.do_step(x, y)[0])
                  for _ in range(FIXTURE_TRAIN_STEPS)]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                        cpu_losses))
    check(loss_err <= 1e-4, f"fixture train: losses card {card_losses} vs "
                            f"CPU {cpu_losses} (rel {loss_err:.3g})")
    check(all(n == FIXTURE_TRAIN_STEPS for n in bwd.values()),
          f"fixture train: launches over {FIXTURE_TRAIN_STEPS} steps {bwd}")
    ntok = sum(len(o) for o in outs)
    log(f"  fixture (d_model 16, 2 heads of d=8) on the card: output() max "
        f"|err| vs the committed output {err:.2e} (atol 1e-5), K1 "
        f"launches {k1}; [{card}]")
    log(f"  fixture serve: {len(reqs)} greedy requests, {ntok} tokens equal "
        f"to the plain-read server's, K2 launches {k2}, {ntok / wall:.1f} "
        f"tok/s (plain read {ntok / ref_wall:.1f}); [{card}]")
    log(f"  fixture train: first-step grads vs CPU {grad_err:.2e}, "
        f"{FIXTURE_TRAIN_STEPS} Adam steps' losses vs CPU {loss_err:.2e} "
        f"({card_losses[0]:.5f} -> {card_losses[-1]:.5f}), launches {bwd}; "
        f"[{card}]")
    return dict(head_dim=d, output_max_abs_err=err, k1_launches=k1,
                serve_tokens=ntok, serve_tokens_per_s=ntok / wall,
                plain_tokens_per_s=ntok / ref_wall, k2_launches=k2,
                grad_rel_err=grad_err, loss_rel_err=loss_err,
                losses=card_losses, cpu_losses=cpu_losses,
                train_launches=bwd, streams=outs)


# ---------------------------------------------------------------- phase 5d
#: phase-5d shared-prefix traffic: a 192-token system prompt (12 pages)
#: followed by a distinct 1-64-token suffix per request, 32 new tokens,
#: the odd requests sampled (``SAMPLED``)
PREFIX_TOKENS = 192
#: phase-5d preemption: a pool of 40 pages (39 usable) holds the 12 shared
#: prefix pages and a few slots' private pages, not eight slots' growth
#: (a pool much smaller makes each admission preempt a running slot)
PREEMPT_PAGES = 40
#: phase-5d handoff: requests exported after at least this many tokens,
#: out of HANDOFF_TOKENS
HANDOFF_AFTER = 16
HANDOFF_TOKENS = 64


def prefix_requests(new_tokens=32):
    """The phase-5d requests: the shared system prompt plus 16 distinct
    suffixes of 1..64 tokens (distinct lengths, so no two share a tail)."""
    rs = np.random.RandomState(8)
    V = SLICE["num_labels"]
    system = rs.randint(0, V, PREFIX_TOKENS)
    lens = rs.choice(np.arange(1, 65), 16, replace=False)
    return [(np.concatenate([system, rs.randint(0, V, n)]), new_tokens,
             dict(SAMPLED, seed=3000 + i) if i % 2 else {})
            for i, n in enumerate(lens)]


def serve_after_first(net, reqs, **kw):
    """``serve`` with the first request served alone before the rest are
    submitted together, so its prefix is registered when they arrive.
    Returns (token lists, wall seconds, stats after the drain)."""
    from deeplearning4j_torch.parallel.generation import GenerationServer

    srv = GenerationServer(net, SLICE["num_labels"], device="cuda",
                           **dict(SERVER, **kw))
    try:
        t0 = time.perf_counter()
        sub = [lambda r=r: srv.submit(r[0], r[1], **r[2]) for r in reqs]
        outs = [sub[0]().result(timeout=600).tolist()]
        futs = [f() for f in sub[1:]]
        outs += [f.result(timeout=600).tolist() for f in futs]
        check(srv.drain(timeout=60), "prefix serve: drain timed out")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = server_stats(srv)
    finally:
        srv.close()
    return outs, wall, stats


def check_streams(tag, outs, ref, what):
    for i, (got, want) in enumerate(zip(outs, ref)):
        check(got == want, f"{tag}: request {i} diverges from {what} at "
                           f"token {first_divergence(got, want)}")


def check_pages_returned(tag, st):
    pg = st["pages"]
    check(pg["pages_refcounted"] == 0
          and pg["pages_free"] + pg["pages_cached"] == pg["pages_total"] - 1,
          f"{tag}: pages not returned after the drain: {pg}")


def handoff_round(net, reqs, kv, source=None, adopters=(None,)):
    """Export ``reqs`` live from one server after at least HANDOFF_AFTER
    tokens (the periodic snapshot marks the moment), round-trip each
    snapshot through its bytes, adopt them into a second server (one per
    entry of ``adopters``), and hold each completion against the first
    server's uninterrupted stream. ``source`` and each adopter is a
    tensor-parallel mesh, or None for one card; a snapshot's header says
    its source's shard count."""
    from deeplearning4j_torch.parallel.generation import GenerationServer
    from deeplearning4j_torch.parallel.handoff import KVSnapshot

    V = SLICE["num_labels"]

    def server(mesh, **kw):
        return GenerationServer(net, V, kv_dtype=kv, mesh=mesh, **SERVER,
                                **({} if mesh is not None
                                   else dict(device="cuda")), **kw)

    src = server(source, snapshot_every=HANDOFF_AFTER)
    try:
        futs = [src.submit(p, HANDOFF_TOKENS, **o) for p, _, o in reqs]
        snaps = []
        for f in futs:
            t_end = time.monotonic() + 120
            while getattr(f, "_kv_snapshot", None) is None:
                check(not f.done() and time.monotonic() < t_end,
                      "handoff: no periodic snapshot before the end")
                time.sleep(0.0005)
            snaps.append(src.export_request(f, timeout=60))
        full = [f.result(timeout=600).tolist() for f in futs]
        src_stats = src.stats()
    finally:
        src.close()
    shards = 1 if source is None else source.size
    wires = []
    for snap in snaps:
        check(HANDOFF_AFTER <= snap.count < HANDOFF_TOKENS,
              f"handoff: exported at token {snap.count}")
        check(snap.shards == shards and snap.head_layout == "canonical",
              f"handoff: header shards={snap.shards} layout "
              f"{snap.head_layout!r} from a {shards}-shard source")
        blob = snap.to_bytes()
        back = KVSnapshot.from_bytes(blob)
        check(back.to_bytes() == blob, "handoff: to_bytes/from_bytes is "
                                       "not a byte-for-byte round trip")
        wires.append(back)
    adopted = []
    for mesh in adopters:
        tp = 1 if mesh is None else mesh.size
        dst = server(mesh)
        try:
            t0 = time.perf_counter()
            outs = [f.result(timeout=600).tolist()
                    for f in [dst.adopt_request(w) for w in wires]]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = dst.stats()
        finally:
            dst.close()
        check_streams(f"handoff {kv or 'f32'} to tp={tp}", outs, full,
                      "its uninterrupted stream")
        ho = st["handoff"]
        check(ho["resumes"] == len(reqs) and ho["fallbacks"] == 0,
              f"handoff to tp={tp}: adopter stats {ho}")
        adopted.append(dict(tp=tp, resumes=ho["resumes"],
                            fallbacks=ho["fallbacks"],
                            tokens_saved=ho["tokens_saved"],
                            adopt_wall_s=wall))
    return dict(exported_at=[s.count for s in snaps], shards=shards,
                wire_bytes=[len(w.to_bytes()) for w in wires],
                source_snapshots=src_stats["handoff"]["snapshots"],
                adopted=adopted)


def phase_prefix(net, card):
    """Phase 5d at full width: the shared-prefix serve (prefix cache on,
    off, and the plain read) in f32 and int8 KV, a preemption serve on a
    small pool, and a live handoff of 4 requests between two servers in f32
    and int8 KV."""
    reqs = prefix_requests()
    results = {}
    for kv in (None, "int8"):
        tag = kv or "f32"
        outs, wall, st = serve_after_first(net, reqs, kv_dtype=kv)
        off, off_wall, off_st = uncounted(serve_after_first, net, reqs,
                                          kv_dtype=kv, prefix_cache=False)
        plain, plain_wall, _ = uncounted(
            serve_after_first, net, reqs, kv_dtype=kv, prefix_cache=False,
            paged_attention="stock")
        check_streams(f"prefix {tag}", outs, off, "the unshared server")
        check_streams(f"prefix {tag}", outs, plain, "the plain-read server")
        pg = st["pages"]
        check(pg["prefix_hits"] >= 15, f"prefix {tag}: {pg['prefix_hits']} "
                                       f"prefix hits")
        check(pg["prefix_tokens_reused"] == PREFIX_TOKENS * pg["prefix_hits"],
              f"prefix {tag}: {pg['prefix_tokens_reused']} tokens reused "
              f"over {pg['prefix_hits']} hits")
        check(pg["cow_copies"] >= 1, f"prefix {tag}: no copy-on-write")
        check_pages_returned(f"prefix {tag}", st)
        check(any(len(set(o)) > 4 for o in outs), f"prefix {tag}: "
                                                  f"degenerate streams")
        ntok = sum(len(o) for o in outs)
        results[tag] = dict(
            tokens=ntok, wall_s=wall, tokens_per_s=ntok / wall,
            unshared_wall_s=off_wall, unshared_tokens_per_s=ntok / off_wall,
            plain_tokens_per_s=ntok / plain_wall,
            prefill_rounds=st["prefill_rounds"],
            unshared_prefill_rounds=off_st["prefill_rounds"],
            pages={k: pg[k] for k in ("prefix_hits", "prefix_tokens_reused",
                                      "cow_copies", "pages_cached",
                                      "evictions", "peak_pages")},
            unshared_peak_pages=off_st["pages"]["peak_pages"])
        log(f"  prefix {tag}: 16 requests over a {PREFIX_TOKENS}-token shared "
            f"prompt, {ntok} tokens equal to the unshared and plain-read "
            f"servers'; {pg['prefix_hits']} prefix hits, "
            f"{pg['prefix_tokens_reused']} tokens reused, {pg['cow_copies']} "
            f"copy-on-write pages; peak pages {pg['peak_pages']} (unshared "
            f"{off_st['pages']['peak_pages']}); {ntok / wall:.1f} tok/s "
            f"(unshared {ntok / off_wall:.1f}, plain read "
            f"{ntok / plain_wall:.1f}); [{card}]")
    roomy = uncounted(serve_after_first, net, reqs)[0]
    outs, wall, st = serve_after_first(net, reqs, pages=PREEMPT_PAGES)
    check_streams("preemption", outs, roomy, "the roomy server")
    pg = st["pages"]
    check(pg["preempted"] >= 1, f"preemption: no slot preempted on a "
                                f"{PREEMPT_PAGES}-page pool")
    check_pages_returned("preemption", st)
    results["preemption"] = dict(
        pages=PREEMPT_PAGES, preempted=pg["preempted"],
        preempt_resumes=st["handoff"]["preempt_resumes"],
        evictions=pg["evictions"], wall_s=wall,
        tokens_per_s=sum(len(o) for o in outs) / wall)
    log(f"  preemption: {PREEMPT_PAGES}-page pool, {pg['preempted']} "
        f"preemptions ({st['handoff']['preempt_resumes']} resumed from a "
        f"snapshot), {pg['evictions']} cached pages evicted; tokens equal to "
        f"the roomy server's; [{card}]")
    for kv in (None, "int8"):
        tag = kv or "f32"
        r = results[f"handoff_{tag}"] = handoff_round(net, reqs[1:5], kv)
        a = r["adopted"][0]
        log(f"  handoff {tag}: 4 requests exported at tokens "
            f"{r['exported_at']} ({r['wire_bytes']} wire bytes, byte-for-byte "
            f"round trips), adopted by a second server: {a['resumes']} "
            f"resumes, {a['fallbacks']} fallbacks, completions equal to the "
            f"uninterrupted streams; [{card}]")
    return results


# ---------------------------------------------------------------- phase 5e
#: phase-5e small draft: the slice's vocab and capacity, d_model 64, 2
#: heads of 32, 1 block, numpy-seeded weights
DRAFT = dict(num_labels=256, max_length=128, d_model=64, n_heads=2,
             n_blocks=1, max_cache=512)
SPEC_KS = (4, 5)
#: phase-5e chaos: transient faults on a fifth of the dispatches, each
#: retried within ten attempts (a request fails only after ten faults of
#: one dispatch in a row)
CHAOS_RETRY = dict(max_attempts=10, base_s=1e-4, cap_s=1e-3, seed=0)
#: phase-5e migrating drain: live requests leave after at least this many
#: tokens, out of HANDOFF_TOKENS
MIGRATE_AFTER = 16


def decision_gap(net, prompt, tokens, opts):
    """How close the selection after ``prompt + tokens`` was, from a
    full-sequence forward, in logit units: a greedy request's top-2 logit
    gap (``top2_gap``); a sampled one's gap between its two best perturbed
    scores (logit plus temperature times the request's Gumbel noise for
    that token index, the serial key schedule's, within the top-k cut). A
    read whose logit differences move by less than the gap cannot change
    the selection."""
    from deeplearning4j_torch.ops import random

    if not opts.get("temperature"):
        return top2_gap(net, prompt, tokens)
    seq = np.concatenate([np.asarray(prompt), np.asarray(tokens, np.int64)])
    z = logits_of(net, seq)[-1].cpu()
    key = random.fold_in(random.PRNGKey(opts["seed"], device="cpu"),
                         len(tokens))
    score = z + opts["temperature"] * random.gumbel(key, tuple(z.shape))
    if opts.get("top_k"):
        kth = torch.topk(z, opts["top_k"]).values[-1]
        score = torch.where(z >= kth, score, torch.full_like(score, -1e30))
    top = torch.topk(score, 2).values
    return (top[0] - top[1]).item()


def build_draft():
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.utils.convert import params_from_jax

    draft = TransformerLM(**DRAFT).init(device="cuda")
    params_from_jax(numpy_params(draft, seed=1), draft)
    return draft


def round_profile(net, reqs, **kw):
    """Serve ``reqs`` with the third speculative round held until a
    ``torch.profiler`` window opens in this thread around it: the kernels
    it launches and the CUDA runtime calls that copy or synchronise (each
    host-to-device copy of pageable memory waits for the stream), by
    name. The runtime calls are traced process-wide, so the loop thread's
    show."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_torch.parallel.generation import GenerationServer

    srv = GenerationServer(net, SLICE["num_labels"], device="cuda",
                           **dict(SERVER, **kw))
    real, seen = srv._spec_decode_once, [0]
    ready, go, done = (threading.Event() for _ in range(3))

    def gated():
        seen[0] += 1
        if seen[0] != 3:
            return real()
        ready.set()
        go.wait(120)
        try:
            real()
            torch.cuda.synchronize()
        finally:
            done.set()

    srv._spec_decode_once = gated
    try:
        futs = [srv.submit(p, n, **o) for p, n, o in reqs]
        check(ready.wait(120), "round profile: no third round")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            go.set()
            check(done.wait(120), "round profile: the round never ended")
        for f in futs:
            f.result(timeout=600)
    finally:
        go.set()
        srv.close()
    calls = {e.key: e.count for e in prof.key_averages()
             if e.key.startswith(("cuda", "cu"))}
    launches = sum(n for k, n in calls.items() if "LaunchKernel" in k)
    copies = sum(n for k, n in calls.items() if k.startswith("cudaMemcpy"))
    syncs = sum(n for k, n in calls.items() if "Synchronize" in k)
    check(launches > 0, f"round profile: no launch seen in {calls}")
    return dict(launches=launches, copies=copies, syncs=syncs,
                runtime_calls=calls)


def spec_serves(net, drafts, card):
    """The speculative serves: the 16 phase-5b requests (half sampled)
    with each draft at each ``spec_k``, f32 and int8 KV, each stream held
    against the non-speculative server's under phase 5c's near-tie rule,
    and K2's launches held to the round schedule (the verify at
    ``spec_k`` 4 on the decode route, at 5 on the chunk route)."""
    from deeplearning4j_torch import kernels

    reqs = sampled_requests()
    nb = SLICE["n_blocks"]
    results = {}
    for kv in (None, "int8"):
        tag = kv or "f32"
        ref, ref_wall, _ = uncounted(serve, net, reqs, kv_dtype=kv)
        spread = uncounted(gap_spread, net, [
            np.concatenate([p, w]) for (p, _, _), w in zip(reqs, ref)])
        ntok = sum(len(o) for o in ref)
        results[tag] = dict(plain_tokens_per_s=ntok / ref_wall,
                            gap_spread=spread)
        for dname, draft in drafts.items():
            for k in SPEC_KS:
                before = dict(kernels.LAUNCHES)
                outs, wall, st = serve(net, reqs, kv_dtype=kv,
                                       draft_net=draft, spec_k=k)
                paged = kernels.LAUNCHES["paged_attn"] - before["paged_attn"]
                chunk = kernels.LAUNCHES["paged_attn_chunk"] \
                    - before["paged_attn_chunk"]
                pg = st["pages"]
                rounds = pg["spec_rounds"]
                verify_chunk = rounds if k > 4 else 0
                check(chunk == nb * (st["prefill_rounds"] + verify_chunk)
                      and paged - chunk == nb * (rounds - verify_chunk),
                      f"spec {tag} {dname} k={k}: K2 launched {paged} times "
                      f"({chunk} chunk route) for {st['prefill_rounds']} "
                      f"prefill rounds and {rounds} verify rounds")
                near = []
                for i, (got, want) in enumerate(zip(outs, ref)):
                    j = first_divergence(got, want)
                    if j is None:
                        continue
                    gap = uncounted(decision_gap, net, reqs[i][0], want[:j],
                                    reqs[i][2])
                    near.append(dict(request=i, position=j, gap=gap,
                                     tokens=[got[j], want[j]]))
                name = f"{dname}_k{k}"
                results[tag][name] = r = dict(
                    tokens_per_s=ntok / wall, wall_s=wall, spec_rounds=rounds,
                    spec_proposed=pg["spec_proposed"],
                    spec_accepted=pg["spec_accepted"],
                    accept_rate=pg["spec_accept_rate"], k2_launches=paged,
                    k2_chunk_launches=chunk,
                    identical_requests=len(reqs) - len(near),
                    divergences=near)
                log(f"  spec {tag} KV, {dname} draft, spec_k {k}: accept "
                    f"rate {r['accept_rate']:.4f} ({pg['spec_accepted']}/"
                    f"{pg['spec_proposed']}), {rounds} rounds, "
                    f"{ntok / wall:.1f} tok/s (non-speculative "
                    f"{ntok / ref_wall:.1f}); K2 {paged} launches ({chunk} "
                    f"chunk route); {r['identical_requests']}/{len(reqs)} "
                    f"identical to the non-speculative server; divergences "
                    f"(request, token, decision gap): "
                    f"{[(d['request'], d['position'], round(d['gap'], 6)) for d in near]}; "
                    f"gap spread {spread:.6f}; [{card}]")
                for d in near:
                    check(d["gap"] <= spread,
                          f"spec {tag} {dname} k={k}: request {d['request']} "
                          f"leaves the non-speculative stream at token "
                          f"{d['position']} at a decision gap of "
                          f"{d['gap']:.6f}, over the spread {spread:.6f}")
    for dname, draft in drafts.items():
        for k in SPEC_KS:
            prof = uncounted(round_profile, net, reqs, draft_net=draft,
                             spec_k=k)
            results[f"round_{dname}_k{k}"] = prof
            log(f"  one speculative round ({dname} draft, spec_k {k}, f32): "
                f"{prof['launches']} kernel launches, {prof['copies']} "
                f"copies, {prof['syncs']} stream synchronisations; [{card}]")
    return results


def roles_round(net, reqs, kv, ref):
    """A prefill-role server exports each request as a snapshot holding its
    first token; a decode-role server adopts them all; the completions
    equal ``ref`` (the unified server's)."""
    from deeplearning4j_torch.parallel.generation import GenerationServer
    from deeplearning4j_torch.parallel.handoff import KVSnapshot

    V = SLICE["num_labels"]
    tag = kv or "f32"
    pre = GenerationServer(net, V, device="cuda", kv_dtype=kv,
                           role="prefill", **SERVER)
    try:
        t0 = time.perf_counter()
        snaps = [f.result(timeout=600) for f in
                 [pre.submit(p, n, **o) for p, n, o in reqs]]
        pre_wall = time.perf_counter() - t0
        pst = pre.stats()
    finally:
        pre.close()
    check(all(isinstance(s, KVSnapshot) and s.count == 1
              and s.tokens == w[:1] for s, w in zip(snaps, ref)),
          f"roles {tag}: an export is not a snapshot of the first token")
    dec = GenerationServer(net, V, device="cuda", kv_dtype=kv,
                           role="decode", **SERVER)
    try:
        t0 = time.perf_counter()
        outs = [f.result(timeout=600).tolist()
                for f in [dec.adopt_request(s) for s in snaps]]
        dec_wall = time.perf_counter() - t0
        dst = dec.stats()
    finally:
        dec.close()
    check_streams(f"roles {tag}", outs, ref, "the unified server")
    exports = pst["handoff"]["prefill_exports"]
    resumes = dst["handoff"]["resumes"]
    check(exports == len(reqs) and resumes == len(reqs)
          and pst["active_slots"] == 0,
          f"roles {tag}: {exports} prefill exports, {resumes} resumes")
    wire = [s.wire_bytes() for s in snaps]
    return dict(prefill_exports=exports, resumes=resumes,
                wire_bytes_total=sum(wire), wire_bytes_max=max(wire),
                prefill_wall_s=pre_wall, decode_wall_s=dec_wall)


def migrate_round(net, reqs):
    """Drain a serving server with ``migrate=True`` once its live requests
    hold at least MIGRATE_AFTER tokens: every future fails
    ``RequestMigrated``, each live one with a snapshot, which a second
    server adopts (the queued ones it serves afresh); the completions
    equal the uninterrupted streams."""
    from deeplearning4j_torch.parallel.generation import GenerationServer
    from deeplearning4j_torch.parallel.handoff import RequestMigrated

    V = SLICE["num_labels"]
    reqs = [(p, HANDOFF_TOKENS, o) for p, _, o in reqs]
    full = uncounted(serve, net, reqs)[0]
    src = GenerationServer(net, V, device="cuda", **SERVER)
    try:
        futs = [src.submit(p, n, **o) for p, n, o in reqs]
        # midway between MIGRATE_AFTER and HANDOFF_TOKENS, so a request of
        # a later admission wave has its tokens too and none has finished
        steps = (MIGRATE_AFTER + HANDOFF_TOKENS) // (
            2 * SERVER["steps_per_dispatch"])
        t_end = time.monotonic() + 120
        while src.stats()["decode_steps"] < steps:
            check(time.monotonic() < t_end, "migrate: no decode progress")
            time.sleep(0.0005)
        check(src.drain(timeout=120, migrate=True), "migrate: drain timed "
                                                     "out")
        check(all(isinstance(f.exception(timeout=60), RequestMigrated)
                  for f in futs), "migrate: a future did not fail "
                                  "RequestMigrated")
        snaps = [getattr(f, "_kv_snapshot", None) for f in futs]
        sst = src.stats()
    finally:
        src.close()
    live = [s for s in snaps if s is not None]
    check(len(live) == SERVER["slots"]
          and all(s.count >= MIGRATE_AFTER for s in live),
          f"migrate: {len(live)} snapshots at tokens "
          f"{[s.count for s in live]}")
    check(sst["handoff"]["migrated"] == len(reqs),
          f"migrate: {sst['handoff']['migrated']} migrated")
    dst = GenerationServer(net, V, device="cuda", **SERVER)
    try:
        futs = [dst.submit(p, n, **o) if s is None else dst.adopt_request(s)
                for (p, n, o), s in zip(reqs, snaps)]
        outs = [f.result(timeout=600).tolist() for f in futs]
        dst_st = dst.stats()
    finally:
        dst.close()
    check_streams("migrate", outs, full, "its uninterrupted stream")
    check(dst_st["handoff"]["resumes"] == len(live), "migrate: resumes")
    return dict(migrated=sst["handoff"]["migrated"], snapshots=len(live),
                migrated_at=[s.count for s in live],
                wire_bytes=[s.wire_bytes() for s in live],
                resumes=dst_st["handoff"]["resumes"])


def chaos_rounds(net, greedy):
    """A seeded transient-fault policy on every dispatch: every request
    completes with phase 5's tokens and retries show. Then a kill on the
    next dispatch once decoding runs: every future resolves (phase 5's
    tokens, or ``ReplicaKilled``), the device state is rebuilt once, and
    the same server serves phase 5's tokens again."""
    from deeplearning4j_torch.parallel.generation import GenerationServer
    from deeplearning4j_torch.parallel.resilience import (ChaosPolicy,
                                                          ReplicaKilled,
                                                          RetryPolicy)

    V = SLICE["num_labels"]
    reqs = serve_requests()
    chaos = ChaosPolicy(seed=5, transient_rate=0.2)
    outs, wall, st = serve(net, reqs, chaos=chaos,
                           retry=RetryPolicy(**CHAOS_RETRY))
    check_streams("chaos transient", outs, greedy, "phase 5's")
    check(st["retried"] > 0 and st["failed"] == 0
          and st["completed"] == len(reqs),
          f"chaos transient: {st['retried']} retries, {st['failed']} "
          f"failed, {st['completed']} completed")
    out = dict(transient=dict(injected=chaos.injected_transient,
                              retried=st["retried"], wall_s=wall,
                              tokens_per_s=sum(map(len, outs)) / wall))
    kill = ChaosPolicy(seed=6)
    srv = GenerationServer(net, V, device="cuda", chaos=kill, **SERVER)
    try:
        futs = [srv.submit(p, n) for p, n in reqs]
        t_end = time.monotonic() + 120
        while srv.stats()["decode_steps"] < 1:
            check(time.monotonic() < t_end, "chaos kill: no decode")
            time.sleep(0.0005)
        kill.kill_rate = 1.0
        killed = 0
        for i, f in enumerate(futs):
            exc = f.exception(timeout=120)
            if exc is None:
                check(f.result().tolist() == greedy[i], "chaos kill: a "
                      "completed stream differs from phase 5's")
            else:
                check(isinstance(exc, ReplicaKilled), f"chaos kill: a "
                      f"future failed {exc!r}")
                killed += 1
        kill.kill_rate = 0.0
        kst = srv.stats()
        check(killed >= 1 and kst["pool_rebuilds"] == 1,
              f"chaos kill: {killed} futures failed, "
              f"{kst['pool_rebuilds']} pool rebuilds")
        again = [f.result(timeout=600).tolist()
                 for f in [srv.submit(p, n) for p, n in reqs]]
    finally:
        srv.close()
    check_streams("chaos kill", again, greedy, "phase 5's")
    out["kill"] = dict(failed=killed, pool_rebuilds=kst["pool_rebuilds"],
                       injected=kill.injected_kill)
    return out


def phase_spec(net, greedy, card):
    """Phase 5e at full width: speculative serves (the target itself and a
    small numpy-seeded draft, ``spec_k`` 4 and 5, f32 and int8 KV), a
    prefill-role server handing every request to a decode-role server (f32
    and int8), a migrating drain adopted by a second server, and seeded
    chaos (transient faults retried, then a kill and a rebuild)."""
    results = dict(spec=spec_serves(net, {"target": net,
                                          "small": build_draft()}, card))
    reqs = sampled_requests()
    for kv in (None, "int8"):
        tag = kv or "f32"
        unified = uncounted(serve, net, reqs, kv_dtype=kv)[0]
        r = results[f"roles_{tag}"] = roles_round(net, reqs, kv, unified)
        log(f"  roles {tag}: {r['prefill_exports']} prefill exports, "
            f"{r['resumes']} resumes, {r['wire_bytes_total']} wire bytes "
            f"({r['wire_bytes_max']} the largest); completions equal the "
            f"unified server's; [{card}]")
    r = results["migrate"] = migrate_round(net, reqs)
    log(f"  migrating drain: {r['migrated']} requests migrated, "
        f"{r['snapshots']} with snapshots at tokens {r['migrated_at']}, "
        f"{r['resumes']} resumed elsewhere; completions equal the "
        f"uninterrupted streams; [{card}]")
    r = results["chaos"] = chaos_rounds(net, greedy)
    log(f"  chaos: {r['transient']['injected']} transient faults, "
        f"{r['transient']['retried']} retries, tokens equal to phase 5's; "
        f"kill: {r['kill']['failed']} futures failed typed, "
        f"{r['kill']['pool_rebuilds']} pool rebuild, the next batch equal "
        f"to phase 5's; [{card}]")
    return results


# ---------------------------------------------------------------- phase 5f
def build_d96_nets():
    """The d = 96 model (``SLICE96``, numpy-seeded weights) on the card and
    on the CPU."""
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.utils.convert import params_from_jax

    net = TransformerLM(**SLICE96).init(device="cuda")
    params = numpy_params(net, seed=9)
    params_from_jax(params, net)
    cpu = TransformerLM(**SLICE96).init(device="cpu")
    params_from_jax(params, cpu)
    return net, cpu


def param_bytes(net):
    return sum(t.numel() * t.element_size() for p in net.params.values()
               for t in p.values())


def phase_d96(net, cpu, card):
    """Phase 5f: the d = 96 model's ``output()`` against a CPU run of the
    port's plain path; then the phase-5 requests served greedy by it and by
    its ``quantize_net`` int8-weight copy, f32 and int8 KV, each against
    the plain-read server (``paged_attention="stock"``) on the same weights:
    token for token with f32 KV, and with int8 KV equal or leaving it only
    at a position within phase 5c's near-tie rule (each one reported); the
    int8-weight streams' ``greedy_agreement`` with the f32 streams and the
    parameter bytes of both."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.optimize.quantize import (greedy_agreement,
                                                        quantize_net)

    rs = np.random.RandomState(3)
    V, T = SLICE96["num_labels"], SLICE96["max_length"]
    x = np.eye(V, dtype=np.float32)[rs.randint(0, V, (8, T))]
    out = net.output(x)
    torch.cuda.synchronize()
    err = (out.cpu() - cpu.output(x)).abs().max().item()
    check(out.shape == (8, T, V) and torch.isfinite(out).all().item(),
          "d96: output shape or non-finite values")
    check(err <= 1e-4, f"d96: output() vs CPU plain path max |err| "
                       f"{err:.3g} > 1e-4")
    qnet = quantize_net(net)
    check(qnet.params["attn0"]["Wq"].dtype == torch.int8
          and net.params["attn0"]["Wq"].dtype == torch.float32,
          "d96: quantize_net did not give int8 weights beside the source's")
    reqs = serve_requests()
    nb = SLICE96["n_blocks"]
    results = dict(output_max_abs_err=err, param_bytes=param_bytes(net),
                   int8w_param_bytes=param_bytes(qnet))
    streams = {}
    for wtag, model in (("f32", net), ("int8w", qnet)):
        uncounted(serve, model, reqs[:2])                 # warm-up
        for kv in (None, "int8"):
            tag = f"{wtag}_{kv or 'f32'}kv"
            before = dict(kernels.LAUNCHES)
            outs, wall, st = serve(model, reqs, kv_dtype=kv)
            k2 = kernels.LAUNCHES["paged_attn"] - before["paged_attn"]
            chunk = kernels.LAUNCHES["paged_attn_chunk"] \
                - before["paged_attn_chunk"]
            check(k2 == nb * (st["prefill_rounds"]
                              + SERVER["steps_per_dispatch"]
                              * st["decode_steps"])
                  and chunk == nb * st["prefill_rounds"],
                  f"d96 serve {tag}: K2 launched {k2} times ({chunk} chunk "
                  f"route) for {st['prefill_rounds']} prefill rounds and "
                  f"{st['decode_steps']} decode dispatches")
            ref, ref_wall, _ = uncounted(serve, model, reqs, kv_dtype=kv,
                                         paged_attention="stock")
            check(all(len(o) == 32 for o in outs),
                  f"d96 serve {tag}: short output")
            check(len({t for o in outs for t in o}) > 4,
                  f"d96 serve {tag}: degenerate greedy streams")
            spread = None
            near = []
            for i, (got, want) in enumerate(zip(outs, ref)):
                k = first_divergence(got, want)
                if k is None:
                    continue
                gap = uncounted(top2_gap, model, reqs[i][0], want[:k])
                near.append(dict(request=i, position=k, gap=gap,
                                 tokens=[got[k], want[k]]))
            if kv is None:
                check(not near, f"d96 serve {tag}: streams leave the "
                                f"plain-read server's: {near}")
            elif near:
                spread = uncounted(gap_spread, model, [
                    np.concatenate([p, w]) for (p, _), w in zip(reqs, ref)])
                for d in near:
                    check(d["gap"] <= spread,
                          f"d96 serve {tag}: request {d['request']} leaves "
                          f"the plain-read stream at token {d['position']} "
                          f"at a top-2 logit gap of {d['gap']:.6f}, over the "
                          f"spread {spread:.6f}")
            ntok = sum(len(o) for o in outs)
            streams[tag] = outs
            results[tag] = dict(tokens=ntok, wall_s=wall,
                                tokens_per_s=ntok / wall,
                                plain_tokens_per_s=ntok / ref_wall,
                                k2_launches=k2, k2_chunk_launches=chunk,
                                prefill_rounds=st["prefill_rounds"],
                                decode_steps=st["decode_steps"],
                                identical_requests=len(reqs) - len(near),
                                divergences=near, gap_spread=spread,
                                streams=outs)
            log(f"  d96 {tag}: {len(reqs)} requests, {ntok / wall:.1f} tok/s "
                f"(plain read {ntok / ref_wall:.1f}); K2 {k2} launches "
                f"({chunk} chunk route); {len(reqs) - len(near)}/{len(reqs)} "
                f"identical to the plain-read server; divergences (request, "
                f"token, top-2 gap): "
                f"{[(d['request'], d['position'], round(d['gap'], 6)) for d in near]}"
                f"; [{card}]")
    for kv in ("f32", "int8"):
        results[f"int8w_greedy_agreement_{kv}kv"] = greedy_agreement(
            np.concatenate(streams[f"int8w_{kv}kv"]),
            np.concatenate(streams[f"f32_{kv}kv"]))
    log(f"  d96: output() max |err| vs CPU {err:.2e}; int8 weights' greedy "
        f"agreement with f32 weights "
        f"{results['int8w_greedy_agreement_f32kv']:.4f} (f32 KV), "
        f"{results['int8w_greedy_agreement_int8kv']:.4f} (int8 KV); "
        f"parameter bytes f32 {results['param_bytes']}, int8 weights "
        f"{results['int8w_param_bytes']}")
    return results


def phase_train_d96(net, cpu, card):
    """Phase 7b: three Adam ``do_step``s of the d = 96 model on the phase-7
    batch, card against the CPU plain path from the same weights; each step
    launches K1, K3 and K4 ``n_blocks`` times at d = 96."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.optimize.fused_fit import value_and_grad

    x, y = train_batch()
    xd, yd = train_batch(net.device)
    _, g_d = value_and_grad(net, net.params, net.state, [xd], [yd])
    _, g_c = value_and_grad(cpu, cpu.params, cpu.state,
                            [torch.from_numpy(x)], [torch.from_numpy(y)])
    grad_err = max(((g_d[v][p].cpu() - g_c[v][p]).abs().max()
                    / g_c[v][p].abs().max()).item()
                   for v in g_c for p in g_c[v])
    check(grad_err <= 1e-4, f"d96 train: first-step gradients card vs CPU, "
                            f"worst leaf max|err|/max|g| {grad_err:.3g}")
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    before = {k: kernels.LAUNCHES_BY_D.get((k, D96), 0) for k in names}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_losses = [float(net.do_step(xd, yd)[0]) for _ in range(3)]
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    per_step = {k: (kernels.LAUNCHES_BY_D.get((k, D96), 0) - before[k]) / 3
                for k in names}
    cpu_losses = [float(cpu.do_step(x, y)[0]) for _ in range(3)]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                        cpu_losses))
    check(loss_err <= 1e-4, f"d96 train: Adam losses card {card_losses} vs "
                            f"CPU {cpu_losses} (rel {loss_err:.3g})")
    check(all(n == SLICE96["n_blocks"] for n in per_step.values()),
          f"d96 train: launches per step at d={D96} {per_step}, expected "
          f"{SLICE96['n_blocks']} each")
    log(f"  d96 train [{TRAIN_BATCH}, {SLICE96['max_length']}] Adam: "
        f"first-step grads vs CPU {grad_err:.2e}, losses vs CPU "
        f"{loss_err:.2e} ({card_losses[0]:.4f} -> {card_losses[-1]:.4f}); "
        f"launches per step at d={D96} {per_step}; {step_ms:.3f} ms/step "
        f"(three steps, first included); [{card}]")
    return dict(grad_rel_err=grad_err, loss_rel_err=loss_err,
                first_losses=card_losses, cpu_losses=cpu_losses,
                launches_per_step=per_step, step_ms=step_ms)


def profile_serve(net, card, out_dir, reqs=None, tag="f32"):
    """One f32 serve of ``reqs`` (the phase-5 requests; ``tag`` names
    them) under ``torch.profiler``: device busy time against the wall
    clock, and the kernels by device time (table in
    ``out_dir/serve_profile.txt``, or ``serve_profile_{tag}.txt``)."""
    from torch.profiler import ProfilerActivity, profile

    reqs = serve_requests() if reqs is None else reqs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        outs, wall, st = serve(net, reqs)
    fname = "serve_profile.txt" if tag == "f32" else \
        f"serve_profile_{tag}.txt"
    busy_s, launches, top = profile_table(
        prof, out_dir, fname, f"{card}\nwall {wall:.6f} s\n")
    steps = st["prefill_rounds"] + SERVER["steps_per_dispatch"] \
        * st["decode_steps"]
    # K2's chunk route: its kernels (the walk and, when split, the merge)
    # are the paged kernels other than the decode route's
    chunk = [(dev_us(e), e.count, e.key) for e in prof.key_averages()
             if dev_us(e) > 0 and e.self_cpu_time_total == 0
             and "paged_" in e.key and "paged_decode" not in e.key]
    chunk_ms = sum(us for us, _, _ in chunk) / 1e3
    chunk_calls = SLICE["n_blocks"] * st["prefill_rounds"]
    log(f"  profiled serve {tag}: wall {wall:.4f} s, device busy "
        f"{busy_s:.4f} s (idle share {1 - busy_s / wall:.3f}), {launches} "
        f"kernel launches over {steps} forwards; K2 chunk route "
        f"{chunk_ms:.4f} ms over {chunk_calls} calls; [{card}]")
    for t in top[:6]:
        log(f"    {t['device_ms']:9.3f} ms  x{t['count']:<6d} {t['kernel']}")
    return dict(wall_s=wall, device_busy_s=busy_s,
                idle_share=1 - busy_s / wall, kernel_launches=launches,
                forwards=steps, tokens=sum(len(o) for o in outs), top=top,
                k2_chunk_device_ms=chunk_ms, k2_chunk_calls=chunk_calls,
                k2_chunk_kernels=[dict(kernel=k[:80], device_ms=us / 1e3,
                                       count=c) for us, c, k in chunk])


def train_batch(dev=None):
    """The seeded phase-7 batch: one-hot tokens and next-token labels,
    [16, 128, 256] each (on ``dev`` when given)."""
    rs = np.random.RandomState(7)
    V, T = SLICE["num_labels"], SLICE["max_length"]
    tok = rs.randint(0, V, (TRAIN_BATCH, T + 1))
    eye = np.eye(V, dtype=np.float32)
    x, y = eye[tok[:, :-1]], eye[tok[:, 1:]]
    if dev is None:
        return x, y
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def phase_train(net, cpu, card):
    """Adam training of the full-width model through ``do_step``, card
    against the CPU plain path from the same weights."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.optimize.fused_fit import value_and_grad

    x, y = train_batch()
    xd, yd = train_batch(net.device)
    loss_d, g_d = value_and_grad(net, net.params, net.state, [xd], [yd])
    loss_c, g_c = value_and_grad(cpu, cpu.params, cpu.state,
                                 [torch.from_numpy(x)], [torch.from_numpy(y)])
    grad_err = max(((g_d[v][p].cpu() - g_c[v][p]).abs().max()
                    / g_c[v][p].abs().max()).item()
                   for v in g_c for p in g_c[v])
    check(grad_err <= 1e-4, f"train: first-step gradients card vs CPU, "
                            f"worst leaf max|err|/max|g| {grad_err:.3g}")
    before = dict(kernels.LAUNCHES)
    card_losses = [float(net.do_step(xd, yd)[0]) for _ in range(3)]
    per_step = {k: (kernels.LAUNCHES[k] - before[k]) / 3
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    cpu_losses = [float(cpu.do_step(x, y)[0]) for _ in range(3)]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                        cpu_losses))
    check(loss_err <= 1e-4, f"train: Adam losses card {card_losses} vs CPU "
                            f"{cpu_losses} (rel {loss_err:.3g})")
    check(all(n == SLICE["n_blocks"] for n in per_step.values()),
          f"train: launches per step {per_step}, expected "
          f"{SLICE['n_blocks']} each")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [net.do_step(xd, yd)[0] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(l) for l in losses]
    check(all(np.isfinite(losses)) and losses[-1] < 0.9 * losses[0],
          f"train: the loss did not fall over {TRAIN_STEPS} steps: "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    step_ms = wall / TRAIN_STEPS * 1e3
    tokens = TRAIN_BATCH * SLICE["max_length"]
    log(f"  train [{TRAIN_BATCH}, {SLICE['max_length']}] Adam: first-step "
        f"grads vs CPU {grad_err:.2e}, losses vs CPU {loss_err:.2e} "
        f"({card_losses[0]:.4f} -> {card_losses[-1]:.4f}); launches per "
        f"step {per_step}; {TRAIN_STEPS} steps {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; {step_ms:.3f} ms/step = "
        f"{tokens / step_ms * 1e3:.0f} tokens/s; [{card}]")
    return dict(grad_rel_err=grad_err, loss_rel_err=loss_err,
                first_losses=card_losses, cpu_losses=cpu_losses,
                launches_per_step=per_step, losses=losses,
                step_ms=step_ms, tokens_per_step=tokens,
                tokens_per_s=tokens / step_ms * 1e3)


# ---------------------------------------------------------------- phase 7c
#: phase 7c part 1: the JAX package's TransformerLM bench leg
#: (``bench.py::bench_transformer_lm``): vocab 256, T = 512, d_model 256 in
#: 8 heads of 32, 4 blocks, bf16 compute over f32 params, batches of 32
BENCH = dict(num_labels=256, max_length=512, d_model=256, n_heads=8,
             n_blocks=4, max_cache=512, compute_dtype="bfloat16")
BENCH_BATCH = 32
#: its stream: 10 batches (not a multiple of K = 4) from RandomState(6); a
#: NaN in batch 2's features (inside the first fused block) and a trailing
#: partial batch of 20 rows (the unfused tail)
BENCH_BATCHES = 10
BENCH_NAN_AT = 2
BENCH_PARTIAL_ROWS = 20
#: the rows of the first step held to the CPU's plain bf16 path
BENCH_CPU_ROWS = 4


def bench_stream():
    """The phase-7c stream: one-hot tokens and next-token labels as numpy
    (the host data a user's ``fit`` reads), as the bench draws them."""
    from deeplearning4j_torch.datasets.dataset import DataSet

    V, T = BENCH["num_labels"], BENCH["max_length"]
    rs = np.random.RandomState(6)
    eye = np.eye(V, dtype=np.float32)
    out = []
    for i in range(BENCH_BATCHES):
        idx = rs.randint(0, V, (BENCH_BATCH, T + 1))
        x, y = eye[idx[:, :-1]], eye[idx[:, 1:]]
        if i == BENCH_NAN_AT:
            x[0, 0, 0] = np.nan
        if i == BENCH_BATCHES - 1:
            x, y = x[:BENCH_PARTIAL_ROWS], y[:BENCH_PARTIAL_ROWS]
        out.append(DataSet(x, y))
    return out


def bench_net(params, device, compute_dtype="bfloat16"):
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.utils.convert import params_from_jax

    net = TransformerLM(**dict(BENCH, compute_dtype=compute_dtype)).init(
        device=device)
    if params is not None:
        params_from_jax(params, net)
    return net


def grad_rule(got, ref, own):
    """``test_torch_mixed_precision.py``'s rule, per leaf: ``got``'s max
    error against the f32-compute gradients ``ref`` at most twice the
    reference bf16 path's (``own``) plus 1e-3 of max|g|. Returns the worst
    leaf's (error / bound) and that leaf."""
    worst = (0.0, None)
    for v in ref:
        for p in ref[v]:
            r = ref[v][p].double()
            err = (got[v][p].cpu().double() - r).abs().max().item()
            bound = 2 * (own[v][p].double() - r).abs().max().item() \
                + 1e-3 * r.abs().max().item()
            if err / bound > worst[0]:
                worst = (err / bound, f"{v}.{p}")
    return worst


class _DtypeProbe:
    """Records the (dtype, head dim) of every flash forward and backward
    wrapper call while installed (the launch counters count by head dim
    only)."""

    def __init__(self):
        from deeplearning4j_torch.ops import flash_attention as fa

        self.fa = fa
        self.seen = []
        self._fwd, self._bwd = fa.flash_attention_forward, \
            fa.flash_attention_backward

    def __enter__(self):
        def fwd(q, *a, **kw):
            self.seen.append(("fwd", q.dtype, q.shape[-1]))
            return self._fwd(q, *a, **kw)

        def bwd(q, *a, **kw):
            self.seen.append(("bwd", q.dtype, q.shape[-1]))
            return self._bwd(q, *a, **kw)

        self.fa.flash_attention_forward = fwd
        self.fa.flash_attention_backward = bwd
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention_forward = self._fwd
        self.fa.flash_attention_backward = self._bwd


def phase_bench_train(card):
    """Phase 7c part 1: the JAX bench leg's bf16 TransformerLM trained with
    ``fit(stream)`` at the defaults (K = 4 on CUDA, the guard on) against
    ``fit(stream, fused_steps=1)`` on the card; the first step against the
    CPU's plain bf16 path; the bf16 K1/K3/K4 launches; a greedy serve with
    ``compute_dtype`` set and unset (F1); the step time."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.optimize.fused_fit import value_and_grad
    from deeplearning4j_torch.optimize.listeners import (
        CollectScoresIterationListener, HealthListener)

    nb = BENCH["n_blocks"]
    d = BENCH["d_model"] // BENCH["n_heads"]
    probe_net = bench_net(None, "cpu")
    params = numpy_params(probe_net, seed=1)
    del probe_net
    stream = bench_stream()
    steps = len(stream)

    # the first step on BENCH_CPU_ROWS rows: card bf16 against the CPU's
    # f32-compute gradients, under the CPU bf16 path's own error
    rows = [torch.from_numpy(stream[0].features[:BENCH_CPU_ROWS]),
            torch.from_numpy(stream[0].labels[:BENCH_CPU_ROWS])]
    cpu32 = bench_net(params, "cpu", None)
    cpu16 = bench_net(params, "cpu")
    l32, g32 = value_and_grad(cpu32, cpu32.params, cpu32.state, [rows[0]],
                              [rows[1]], train=True)
    l16, g16 = value_and_grad(cpu16, cpu16.params, cpu16.state, [rows[0]],
                              [rows[1]], train=True)
    del cpu32, cpu16
    net = bench_net(params, "cuda")
    ld, gd = value_and_grad(net, net.params, net.state,
                            [rows[0].cuda()], [rows[1].cuda()], train=True)
    rule, leaf = grad_rule(gd, g32, g16)
    loss_rel = abs(float(ld) - float(l16)) / abs(float(l16))
    check(rule <= 1.0, f"bench train: first-step card bf16 gradients vs the "
                       f"CPU f32-compute gradients exceed 2x the CPU bf16 "
                       f"error + 1e-3 max|g| at {leaf} ({rule:.3g} of it)")
    check(loss_rel <= 1e-2, f"bench train: first-step loss card {float(ld)} "
                            f"vs CPU bf16 {float(l16)}")
    check(all(g.dtype == torch.float32 for p in gd.values()
              for g in p.values()), "bench train: gradients not f32")

    # fit(stream) at the defaults against fit(stream, fused_steps=1)
    ref = bench_net(params, "cuda")
    runs = {}
    for tag, n, kw in (("defaults", net, {}),
                       ("unfused", ref, dict(fused_steps=1))):
        scores, health = CollectScoresIterationListener(), \
            HealthListener(log_events=False)
        n.set_listeners(scores, health)
        before = {k: kernels.LAUNCHES_BY_D.get((k, d), 0)
                  for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        with _DtypeProbe() as probe:
            n.fit(stream, **kw)
        torch.cuda.synchronize()
        per_step = {k: (kernels.LAUNCHES_BY_D.get((k, d), 0) - before[k])
                    / steps for k in before}
        runs[tag] = dict(
            scores=[float(s) for _, s in scores.scores],
            iterations=[i for i, _ in scores.scores],
            skips=sum(r.get("skipped_in_block", 0) for r in health.reports
                      if r["action"] == "skip"),
            actions=[r["action"] for r in health.reports],
            launches_per_step=per_step,
            dtypes=sorted({(k, str(t), dd) for k, t, dd in probe.seen}))
        n.set_listeners()
    a, b = runs["defaults"], runs["unfused"]
    check(net.iteration == ref.iteration == steps
          and a["iterations"] == b["iterations"] == list(range(1, steps + 1)),
          f"bench train: iterations {a['iterations']} vs {b['iterations']}")
    check(a["skips"] == b["skips"] == 1 and a["actions"] == ["skip"],
          f"bench train: the guard skipped {a['skips']} (defaults) and "
          f"{b['skips']} (unfused) steps, reports {a['actions']}; expected "
          "one skip")
    finite = [(x, y) for x, y in zip(a["scores"], b["scores"])
              if np.isfinite(x) or np.isfinite(y)]
    check(len(finite) == steps - 1
          and not np.isfinite(a["scores"][BENCH_NAN_AT]),
          f"bench train: scores {a['scores']}")
    score_err = max(abs(x - y) / abs(y) for x, y in finite)
    pmax = max(t.abs().max().item() for p in ref.params.values()
               for t in p.values())
    perr = max((net.params[v][k] - ref.params[v][k]).abs().max().item()
               for v in ref.params for k in ref.params[v])
    bitwise = all(torch.equal(net.params[v][k], ref.params[v][k])
                  for v in ref.params for k in ref.params[v]) and \
        [x for x, _ in finite] == [y for _, y in finite]
    check(score_err <= 1e-6 and perr <= 1e-6 * pmax,
          f"bench train: defaults vs fused_steps=1: scores rel {score_err:.3g}"
          f", params max|err| {perr:.3g} vs 1e-6 of max|p| {pmax:.3g}")
    check(all(torch.isfinite(t).all().item() for p in net.params.values()
              for t in p.values()), "bench train: a param is not finite")
    fin = [x for x in a["scores"] if np.isfinite(x)]
    check(fin[-1] < fin[0], f"bench train: the loss did not fall: {fin}")
    check(all(n == nb for n in a["launches_per_step"].values())
          and all(n == nb for n in b["launches_per_step"].values()),
          f"bench train: launches per step at d={d} {a['launches_per_step']}"
          f" / {b['launches_per_step']}, expected {nb} each")
    check(a["dtypes"] == [("bwd", "torch.bfloat16", d),
                          ("fwd", "torch.bfloat16", d)],
          f"bench train: flash calls {a['dtypes']}, expected bf16 at d={d}")

    # the step time: two fused blocks of clean full batches from the host
    clean = [ds for i, ds in enumerate(stream)
             if i not in (BENCH_NAN_AT, BENCH_BATCHES - 1)][:8]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(clean)
    float(net.score())
    wall = time.perf_counter() - t0
    step_ms = wall / len(clean) * 1e3
    tokens = BENCH_BATCH * BENCH["max_length"]

    # F1 on the card: the compute_dtype net serves (in its param dtype)
    # the tokens it serves with compute_dtype unset
    reqs = serve_requests()
    got, wall_bf, _ = serve(net, reqs, vocab=BENCH["num_labels"])
    net.conf.compute_dtype = None
    want, _, _ = serve(net, reqs, vocab=BENCH["num_labels"])
    net.conf.compute_dtype = "bfloat16"
    check(got == want, "bench train: the compute_dtype net's greedy serve "
                       "differs from its compute_dtype=None serve")
    log(f"  bench train [{BENCH_BATCH}, {BENCH['max_length']}] bf16 compute: "
        f"first step ({BENCH_CPU_ROWS} rows) vs CPU {rule:.3f} of the "
        f"bound (worst {leaf}), loss rel {loss_rel:.2e}; fit defaults (K=4, "
        f"guard) vs fused_steps=1 over {steps} batches: scores rel "
        f"{score_err:.2e}, params {perr:.2e} (max|p| {pmax:.3f}), bitwise "
        f"{bitwise}; 1 skip; loss {fin[0]:.4f} -> {fin[-1]:.4f}; launches "
        f"per step at d={d} {a['launches_per_step']} (bf16); {step_ms:.3f} "
        f"ms/step = {tokens / step_ms * 1e3:.0f} tokens/s over "
        f"{len(clean)} steps; compute_dtype serve equal to the unset one "
        f"({sum(len(o) for o in got)} tokens); [{card}]")
    return net, dict(first_step_rule=rule, first_step_worst_leaf=leaf,
                     first_step_loss_rel=loss_rel, runs=runs,
                     score_rel_err=score_err, param_max_err=perr,
                     param_max=pmax, bitwise=bitwise, step_ms=step_ms,
                     tokens_per_step=tokens,
                     tokens_per_s=tokens / step_ms * 1e3,
                     serve_tokens=sum(len(o) for o in got),
                     serve_wall_s=wall_bf)


def fields_conf(net):
    """Part 2's training fields on a phase-7 model: L2 (with L2 on the
    biases, the JAX package's decay) on the FFN layers and L1 on embed,
    clip_l2_per_layer everywhere, dropout 0.1 on ff{i}a and the attention
    vertices, a per-layer learning rate on the output layer."""
    for name, v in net.conf.vertices.items():
        layer = getattr(v, "layer", None)
        if layer is None or not hasattr(layer, "l1"):
            continue
        layer.gradient_normalization = "clip_l2_per_layer"
        if name.startswith("ff"):
            layer.l2, layer.l2_bias = 1e-3, 1e-4
        if name == "embed":
            layer.l1 = 1e-5
        if name.startswith("attn") or (name.startswith("ff")
                                       and name.endswith("a")):
            layer.dropout = 0.1
        if name == "output":
            layer.learning_rate = 1e-3
    return net


def fields_net(params, device, remat):
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.utils.convert import params_from_jax

    net = TransformerLM(**SLICE).init(device=device)
    for name, v in net.conf.vertices.items():
        if name.startswith("attn"):
            v.remat = remat
    params_from_jax(params, fields_conf(net))
    return net


def phase_train_fields(params, card):
    """Phase 7c part 2: the phase-7 model and batch with the training
    fields (``fields_conf``) and ``remat`` on the attention vertices, three
    Adam steps on the card against the CPU; the dropout masks across
    devices; K1 twice per attention vertex per step; remat against no
    remat."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.ops import random as prandom
    from deeplearning4j_torch.optimize.fused_fit import value_and_grad

    nb = SLICE["n_blocks"]
    net = fields_net(params, "cuda", remat=True)
    plain = fields_net(params, "cuda", remat=False)
    cpu = fields_net(params, "cpu", remat=False)
    x, y = train_batch()
    xd, yd = train_batch(net.device)

    # the masks: each dropout vertex's key and draw, card and CPU
    order = net.conf.topo_order
    masks_equal = True
    for it in range(3):
        kd = prandom.split(net._step_rng(it), len(order))
        kc = prandom.split(cpu._step_rng(it), len(order))
        for i, name in enumerate(order):
            layer = getattr(net.conf.vertices[name], "layer", None)
            if (getattr(layer, "dropout", 0) or 0) > 0:
                shape = (TRAIN_BATCH, SLICE["max_length"], SLICE["d_model"])
                md = prandom.bernoulli(kd[i], 1 - layer.dropout, shape)
                mc = prandom.bernoulli(kc[i], 1 - layer.dropout, shape)
                masks_equal &= torch.equal(md.cpu(), mc)
    check(masks_equal, "train fields: a dropout mask differs card vs CPU")

    _, g_d = value_and_grad(net, net.params, net.state, [xd], [yd],
                            train=True, rng=net._step_rng(0))
    _, g_c = value_and_grad(cpu, cpu.params, cpu.state,
                            [torch.from_numpy(x)], [torch.from_numpy(y)],
                            train=True, rng=cpu._step_rng(0))
    grad_err = max(((g_d[v][p].cpu() - g_c[v][p]).abs().max()
                    / g_c[v][p].abs().max()).item()
                   for v in g_c for p in g_c[v])
    check(grad_err <= 1e-4, f"train fields: first-step gradients card vs "
                            f"CPU, worst leaf max|err|/max|g| {grad_err:.3g}")
    before = dict(kernels.LAUNCHES)
    losses = [float(net.do_step(xd, yd)[0]) for _ in range(3)]
    per_step = {k: (kernels.LAUNCHES[k] - before[k]) / 3
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    plain_losses = [float(plain.do_step(xd, yd)[0]) for _ in range(3)]
    cpu_losses = [float(cpu.do_step(x, y)[0]) for _ in range(3)]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    check(loss_err <= 1e-4, f"train fields: losses card {losses} vs CPU "
                            f"{cpu_losses} (rel {loss_err:.3g})")
    check(per_step == {"flash_fwd": 2 * nb, "flash_bwd_dq": nb,
                       "flash_bwd_dkv": nb},
          f"train fields: launches per step {per_step}, expected K1 "
          f"{2 * nb} (remat recompute) and K3/K4 {nb}")
    pmax = max(t.abs().max().item() for p in plain.params.values()
               for t in p.values())
    remat_err = max((net.params[v][k] - plain.params[v][k]).abs().max()
                    .item() for v in net.params for k in net.params[v])
    remat_loss = max(abs(a - b) / abs(b)
                     for a, b in zip(losses, plain_losses))
    check(remat_err <= 1e-6 * pmax and remat_loss <= 1e-6,
          f"train fields: remat vs no remat params {remat_err:.3g}, losses "
          f"rel {remat_loss:.3g}")
    log(f"  train fields [{TRAIN_BATCH}, {SLICE['max_length']}] (L1/L2, "
        f"clip_l2_per_layer, dropout 0.1, output lr, remat): masks card = "
        f"CPU; first-step grads vs CPU {grad_err:.2e}, losses vs CPU "
        f"{loss_err:.2e} ({losses[0]:.4f} -> {losses[-1]:.4f}); launches "
        f"per step {per_step}; remat vs none: params {remat_err:.2e}, "
        f"losses {remat_loss:.2e}, bitwise {remat_err == 0.0}; [{card}]")
    return dict(masks_equal=masks_equal, grad_rel_err=grad_err,
                loss_rel_err=loss_err, card_losses=losses,
                cpu_losses=cpu_losses, launches_per_step=per_step,
                remat_param_err=remat_err, remat_loss_rel=remat_loss)


def profile_bench_fit(net, card, out_dir):
    """One fused block (K = 4 clean bench batches through ``fit`` at the
    defaults) under ``torch.profiler``: device busy time against the wall
    clock, launches per step, kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    stream = bench_stream()
    clean = [ds for i, ds in enumerate(stream)
             if i not in (BENCH_NAN_AT, BENCH_BATCHES - 1)][:4]
    net.fit(clean)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(clean)
        float(net.score())
        wall = time.perf_counter() - t0
    busy_s, launches, top = profile_table(
        prof, out_dir, "bench_fit_profile.txt",
        f"{card}\none fused block of {len(clean)} steps, wall {wall:.6f} s\n")
    steps = len(clean)
    log(f"  profiled bench fit: one K={steps} block, wall {wall:.4f} s, "
        f"device busy {busy_s:.4f} s (idle share {1 - busy_s / wall:.3f}), "
        f"{launches / steps:.0f} kernel launches per step; [{card}]")
    for t in top[:6]:
        log(f"    {t['device_ms']:9.3f} ms  x{t['count']:<6d} {t['kernel']}")
    return dict(steps=steps, wall_s=wall, device_busy_s=busy_s,
                idle_share=1 - busy_s / wall,
                kernel_launches_per_step=launches / steps, top=top)


def profile_table(prof, out_dir, fname, header):
    """Device busy seconds (sum of the device activities' self times; one
    stream, so they do not overlap), the launch count and the kernels by
    device time of one ``torch.profiler`` run; the table goes to
    ``out_dir/fname`` (if ``out_dir``). Device activities are the rows with
    device time and no CPU time: an operator row launched from the
    profiled thread also carries its kernels' device time, and counting
    it too would count that time twice."""
    events = prof.key_averages()
    kernels = sorted(((dev_us(e), e.count, e.key) for e in events
                      if dev_us(e) > 0 and e.self_cpu_time_total == 0),
                     reverse=True)
    busy_s = sum(us for us, _, _ in kernels) / 1e6
    if out_dir:
        key = ("self_device_time_total"
               if hasattr(events[0], "self_device_time_total")
               else "self_cuda_time_total")
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write(header)
            f.write(events.table(sort_by=key, row_limit=40))
    top = [dict(kernel=k[:80], device_ms=us / 1e3, count=c)
           for us, c, k in kernels[:12]]
    return busy_s, sum(c for _, c, _ in kernels), top


def profile_train(net, card, out_dir, steps=5):
    """``steps`` training steps on the phase-7 batch under
    ``torch.profiler``: device busy time against the wall clock and the
    kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    xd, yd = train_batch(net.device)
    net.do_step(xd, yd)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            net.do_step(xd, yd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_s, launches, top = profile_table(
        prof, out_dir, "train_profile.txt",
        f"{card}\n{steps} steps, wall {wall:.6f} s\n")
    log(f"  profiled train: {steps} steps, wall {wall:.4f} s, device busy "
        f"{busy_s:.4f} s (idle share {1 - busy_s / wall:.3f}), "
        f"{launches / steps:.0f} kernel launches per step; [{card}]")
    for t in top[:6]:
        log(f"    {t['device_ms']:9.3f} ms  x{t['count']:<6d} {t['kernel']}")
    return dict(steps=steps, wall_s=wall, device_busy_s=busy_s,
                idle_share=1 - busy_s / wall,
                kernel_launches_per_step=launches / steps, top=top)


# ----------------------------------------------------------------- phase 8
#: phase 8a: LeNet on the port's synthetic MNIST, batches of 64, a NaN in
#: one batch's features; its test set (a short last batch) for evaluate
LENET_BATCH = 64
LENET_BATCHES = 64
LENET_NAN_AT = 5
LENET_TEST = 1000
#: phase 8b: the JAX package's committed conv-net fixture
CONVNET = os.path.join("tests", "fixtures", "regression_convnet_r4.zip")
CONVNET_EXPECTED = os.path.join("tests", "fixtures",
                                "regression_convnet_r4_expected.npz")
#: phase 8d: (zoo model, input shape, timed batch); gradients at batch 2
BIG_CNNS = [("SimpleCNN", (48, 48, 1), 32), ("AlexNet", (224, 224, 3), 32),
            ("VGG16", (224, 224, 3), 16)]
BIG_CNN_TIMED_STEPS = 5


def mnist_nhwc(train, n, batch):
    """The port's synthetic MNIST as NHWC batches (numpy, the host data a
    user's ``fit`` reads)."""
    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.datasets.mnist import MnistDataSetIterator

    it = MnistDataSetIterator(batch_size=batch, train=train, num_examples=n)
    check(it.synthetic, "phase 8: MNIST files were found; the phase runs "
                        "on the synthetic set")
    return [DataSet(ds.features.reshape(-1, 28, 28, 1), ds.labels)
            for ds in it]


def twin(name, device, params=None, **kw):
    """Zoo model ``name`` on ``device``, on ``params`` (a tree of tensors,
    cast to the model's dtype) when given, else drawn from its seed."""
    from deeplearning4j_torch.models import zoo

    dt = getattr(torch, kw.get("dtype", "float32"))
    return getattr(zoo, name)(**kw).init(
        None if params is None else
        {k: {n: t.detach().to(dt, copy=True) for n, t in p.items()}
         for k, p in params.items()}, device=device)


def zero_grad_leaves(net):
    """The biases of convolutions feeding a training-mode batch norm: their
    exact gradient is 0 (the batch mean takes the bias out), so both
    devices' values are rounding noise."""
    from deeplearning4j_torch.nn.conf.layers.normalization import (
        BatchNormalization)

    if not hasattr(net, "layers"):
        return graph_zero_grad_leaves(net)
    return {(str(i), "b") for i in range(len(net.layers) - 1)
            if isinstance(net.layers[i + 1], BatchNormalization)
            and "b" in net.params[str(i)]}


def step_grads(net, x, y, seed=0):
    """Loss and gradients (f64, on the host) of ``net``'s first training
    step on numpy ``x``, ``y``, its dropout keyed by ``PRNGKey(seed)`` on
    the net's device."""
    from deeplearning4j_torch.ops import random
    from deeplearning4j_torch.optimize.fused_fit import value_and_grad

    dev, dt = net.device, getattr(torch, net.conf.dtype)
    loss, g = value_and_grad(
        net, net.params, net.state, torch.from_numpy(x).to(dev, dt),
        torch.from_numpy(y).to(dev, dt), train=True,
        rng=random.PRNGKey(seed, device=dev))
    return float(loss), {k: {n: t.detach().cpu().double()
                             for n, t in p.items()} for k, p in g.items()}


def worst_leaf(got, ref, bound):
    """The largest per-leaf max|got - ref| / bound(leaf) and its leaf."""
    worst = (0.0, None)
    for v in ref:
        for k in ref[v]:
            r = (got[v][k] - ref[v][k]).abs().max().item() / bound(v, k)
            if r > worst[0]:
                worst = (r, f"{v}.{k}")
    return worst


def rule_1e4(net, ref):
    """Phase 7's gradient bound per leaf: 1e-4 of the leaf's max|g| (of
    the net's max|g| for a leaf whose exact gradient is 0)."""
    top = max(g.abs().max().item() for p in ref.values() for g in p.values())
    zero = zero_grad_leaves(net)

    def bound(v, k):
        scale = top if (v, k) in zero else ref[v][k].abs().max().item()
        return 1e-4 * max(scale, 1e-300)

    return bound


def first_step_rule(net, cpu, x, y, seed=0):
    """Phase 7's rule on a MultiLayerNetwork's first training step: the
    card's gradients within ``rule_1e4`` of the CPU plain path's, the loss
    within rtol 1e-4. Returns (worst leaf ratio, leaf, loss rel, card
    loss)."""
    ld, gd = step_grads(net, x, y, seed)
    lc, gc = step_grads(cpu, x, y, seed)
    rule, leaf = worst_leaf(gd, gc, rule_1e4(cpu, gc))
    return rule, leaf, abs(ld - lc) / abs(lc), ld


def busy_share(fn, steps):
    """Device busy seconds over the wall clock of ``fn()`` (``steps`` steps
    ending in a sync) under ``torch.profiler``, and kernel launches per
    step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_s, launches, top = profile_table(prof, None, None, "")
    return dict(wall_s=wall, device_busy_s=busy_s,
                busy_share=busy_s / wall, idle_share=1 - busy_s / wall,
                kernel_launches_per_step=launches / steps, top=top[:6])


def phase_lenet(card, profile):
    """Phase 8a: ``zoo.LeNet`` at its published width on the port's
    synthetic MNIST. ``fit`` at the defaults (K = 4, the guard on) against
    ``fit(fused_steps=1)`` over the same stream with one NaN batch: params
    bitwise equal, one skip each; the first step against the CPU plain
    path (phase 7's rule); fused ``evaluate`` count for count the
    per-batch path's; the model zip saved and loaded on the card; ms a
    step and images/s (and, with ``--profile``, launches a step and the
    idle share of one fused block)."""
    from deeplearning4j_torch.optimize.health import HealthPolicy
    from deeplearning4j_torch.utils.model_serializer import (load_model,
                                                             save_model)

    stream = mnist_nhwc(True, LENET_BATCH * LENET_BATCHES, LENET_BATCH)
    stream[LENET_NAN_AT].features[3, 10, 11, 0] = np.nan
    cpu = twin("LeNet", "cpu")
    net = twin("LeNet", "cuda", cpu.params)
    rule, leaf, loss_rel, _ = first_step_rule(
        net, cpu, stream[0].features, stream[0].labels)
    check(rule <= 1.0 and loss_rel <= 1e-4,
          f"lenet: first step card vs CPU: {rule:.3g} of the bound at "
          f"{leaf}, loss rel {loss_rel:.3g}")
    ref = twin("LeNet", "cuda", cpu.params)
    skips = []
    for n, kw in ((net, {}), (ref, dict(fused_steps=1))):
        policy = HealthPolicy()
        n.fit(stream, health_guard=policy, **kw)
        skips.append(policy.total_skips)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(net.params[v][k], ref.params[v][k])
                  for v in ref.params for k in ref.params[v])
    check(net.iteration == ref.iteration == LENET_BATCHES,
          f"lenet: iterations {net.iteration} / {ref.iteration}")
    check(skips == [1, 1], f"lenet: skips {skips}, expected one each")
    check(bitwise, "lenet: fit at the defaults differs from "
                   "fit(fused_steps=1)")
    check(all(torch.isfinite(t).all().item() for p in net.params.values()
              for t in p.values()), "lenet: a param is not finite")

    test = mnist_nhwc(False, LENET_TEST, LENET_BATCH)
    fused = net.evaluate(test)
    plain = net.evaluate(test, fused=False)
    check(np.array_equal(fused.confusion, plain.confusion)
          and fused.confusion.sum() == LENET_TEST,
          "lenet: fused evaluate differs from the per-batch path")
    check(fused.accuracy() > 0.5, f"lenet: accuracy {fused.accuracy()} "
                                  "after one epoch")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lenet.zip")
        save_model(net, path)
        back = load_model(path, device="cuda")
    x = torch.from_numpy(test[0].features).cuda()
    check(type(back).__name__ == "MultiLayerNetwork"
          and back.device.type == "cuda"
          and np.array_equal(back.params_flat(), net.params_flat())
          and all(torch.equal(back.state[k][n], net.state[k][n])
                  for k in net.state for n in net.state[k])
          and torch.equal(back.output(x), net.output(x)),
          "lenet: the zip saved on the card loads back different")

    clean = [ds for i, ds in enumerate(stream) if i != LENET_NAN_AT][:32]
    net.fit(clean[:4])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(clean)
    float(net.score())
    wall = time.perf_counter() - t0
    step_ms = wall / len(clean) * 1e3
    prof = None
    if profile:
        prof = busy_share(lambda: net.fit(clean[:4]), 4)
    log(f"  lenet [{LENET_BATCH}, 28, 28, 1] AdaDelta: first step vs CPU "
        f"{rule:.3f} of the bound ({leaf}), loss rel {loss_rel:.2e}; fit "
        f"defaults (K=4, guard) vs fused_steps=1 over {LENET_BATCHES} "
        f"batches bitwise {bitwise}, skips {skips}; evaluate fused = "
        f"per-batch ({LENET_TEST} images, accuracy {fused.accuracy():.4f}); "
        f"zip round trip on the card equal; {step_ms:.3f} ms/step = "
        f"{LENET_BATCH / step_ms * 1e3:.0f} images/s over {len(clean)} "
        f"steps" + ("" if prof is None else
                    f"; one K=4 block: {prof['kernel_launches_per_step']:.0f}"
                    f" launches a step, idle share {prof['idle_share']:.3f}")
        + f"; [{card}]")
    return dict(first_step_rule=rule, first_step_worst_leaf=leaf,
                first_step_loss_rel=loss_rel, bitwise=bitwise, skips=skips,
                accuracy=fused.accuracy(), step_ms=step_ms,
                images_per_s=LENET_BATCH / step_ms * 1e3, profile=prof)


def phase_convnet_fixture(card):
    """Phase 8b: the committed conv-net zip loaded on the card: its
    ``params_sum`` within 1e-4 and ``output(probe)`` within 1e-5 of the
    npz (``tests/test_format_regression.py``'s rule), then one ``fit`` step
    against the CPU's within 1e-5 of max|p|."""
    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.utils.model_serializer import load_model

    exp = np.load(CONVNET_EXPECTED)
    net = load_model(CONVNET, device="cuda")
    psum = float(net.params_flat().sum())
    out_err = float(np.abs(net.output(exp["probe"]).cpu().numpy()
                           - exp["output"]).max())
    check(abs(psum - float(exp["params_sum"])) < 1e-4 and out_err <= 1e-5,
          f"convnet fixture: params_sum {psum} vs {float(exp['params_sum'])}"
          f", output max|err| {out_err:.3g}")
    rs = np.random.RandomState(0)
    ds = DataSet(rs.randn(8, 8, 8, 1).astype(np.float32),
                 np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)])
    cpu = load_model(CONVNET, device="cpu")
    net.fit(ds)
    cpu.fit(ds)
    pmax = float(np.abs(cpu.params_flat()).max())
    perr = float(np.abs(net.params_flat() - cpu.params_flat()).max())
    check(net.iteration == 7 and perr <= 1e-5 * pmax,
          f"convnet fixture: one fit step card vs CPU max|err| {perr:.3g}")
    log(f"  convnet fixture: params_sum {psum:.6f}, output max|err| "
        f"{out_err:.2e}; one fit step vs CPU {perr:.2e}; [{card}]")
    return dict(params_sum=psum, output_max_err=out_err,
                fit_step_param_err=perr)


def phase_int8_lenet(card):
    """Phase 8c: ``LeNet(quantize="int8")`` on the card under the JAX
    package's eval-parity rule (``tests/test_quantize.py``): confusion delta
    against the f32 net at most 0.05, outputs within 5e-2."""
    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.models.zoo import LeNet
    from deeplearning4j_torch.optimize.quantize import confusion_delta

    net = LeNet(num_labels=10, seed=1).init(device="cuda")
    qnet = LeNet(num_labels=10, seed=1, quantize="int8").init(device="cuda")
    check(qnet.params["0"]["W"].dtype == torch.int8,
          "int8 lenet: the conv kernel is not int8")
    rs = np.random.RandomState(2)
    x = rs.randn(64, 28, 28, 1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 64)]
    delta = confusion_delta(net.evaluate(DataSet(x, y)),
                            qnet.evaluate(DataSet(x, y)))
    out_err = (qnet.output(x) - net.output(x)).abs().max().item()
    check(delta <= 0.05 and out_err <= 5e-2,
          f"int8 lenet: confusion delta {delta}, outputs {out_err:.3g}")
    log(f"  int8 lenet: confusion delta {delta:.4f}, outputs max|err| "
        f"{out_err:.2e}; [{card}]")
    return dict(confusion_delta=delta, output_max_err=out_err)


def phase_big_cnns(card):
    """Phase 8d: SimpleCNN, AlexNet and VGG16 at their zoo input shapes
    against the CPU plain path at batch 2. The first step's gradients
    (dropout keyed alike) in f64 on both devices under phase 7's rule
    (``rule_1e4``, losses rtol 1e-4): the code is the same on both. In
    f32 the gradients of a deep ReLU net are not comparable leaf by leaf
    across two implementations: a pre-activation within rounding of 0
    flips its ReLU (and a max-pool choice), which moves a whole gradient
    contribution (VGG16: the CPU's own f32 gradients miss its f64 ones
    by tens of times phase 7's bound; reported). So in f32 every layer's
    activation is held to the CPU's within 1e-4 of that layer's max|a|
    (the forward is continuous; a TF32 convolution misses it, see
    ``tf32_control``), the loss within rtol 1e-4,
    and the leaf-by-leaf f32 gradient ratio is reported. Then timed
    ``do_step``s at the timed batch: ms a step, images/s and the device
    busy share of three steps."""
    out = {}
    for name, shape, batch in BIG_CNNS:
        kw = dict(num_labels=10, input_shape=shape)
        rs = np.random.RandomState(3)
        x = rs.rand(2, *shape).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 2)]
        cpu = twin(name, "cpu", **kw)
        c32_loss, c32 = step_grads(cpu, x, y, seed=4)
        c64_loss, c64 = step_grads(
            twin(name, "cpu", cpu.params, dtype="float64", **kw),
            x.astype(np.float64), y.astype(np.float64), seed=4)
        d64_loss, d64 = step_grads(
            twin(name, "cuda", cpu.params, dtype="float64", **kw),
            x.astype(np.float64), y.astype(np.float64), seed=4)
        net = twin(name, "cuda", cpu.params, **kw)
        loss, d32 = step_grads(net, x, y, seed=4)
        f64_rule, f64_leaf = worst_leaf(d64, c64, rule_1e4(cpu, c64))
        plain, plain_leaf = worst_leaf(d32, c32, rule_1e4(cpu, c32))
        # the CPU's own f32 gradients against its f64 ones: what rounding
        # alone moves, on one implementation
        own, own_leaf = worst_leaf(c32, c64, rule_1e4(cpu, c64))
        acts = max(
            ((a.cpu().double() - b.double()).abs().max()
             / b.double().abs().max().clamp_min(1e-30)).item()
            for a, b in zip(net.feed_forward(x), cpu.feed_forward(x)))
        loss_rel = abs(loss - c32_loss) / abs(c32_loss)
        f64_loss_rel = abs(d64_loss - c64_loss) / abs(c64_loss)
        del cpu
        check(f64_rule <= 1.0 and f64_loss_rel <= 1e-4,
              f"{name}: f64 first step card vs CPU: {f64_rule:.3g} of the "
              f"bound at {f64_leaf}, loss rel {f64_loss_rel:.3g}")
        check(acts <= 1e-4 and loss_rel <= 1e-4,
              f"{name}: f32 card vs CPU: activations {acts:.3g} of max|a|, "
              f"loss rel {loss_rel:.3g}")
        xb = torch.rand((batch, *shape), generator=torch.Generator()
                        .manual_seed(5)).cuda()
        yb = torch.eye(10)[torch.randint(0, 10, (batch,),
                                         generator=torch.Generator()
                                         .manual_seed(6))].cuda()
        net.do_step(xb, yb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BIG_CNN_TIMED_STEPS):
            net.do_step(xb, yb)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / BIG_CNN_TIMED_STEPS * 1e3

        def three():
            for _ in range(3):
                net.do_step(xb, yb)

        prof = busy_share(three, 3)
        check(np.isfinite(float(net.score())), f"{name}: loss not finite")
        log(f"  {name} {list(shape)}: batch 2 card vs CPU: f64 first "
            f"step {f64_rule:.3f} of phase 7's bound ({f64_leaf}), loss rel "
            f"{f64_loss_rel:.2e}; f32 activations {acts:.2e} of max|a|, "
            f"loss rel {loss_rel:.2e}, gradients {plain:.3f} of phase 7's "
            f"bound ({plain_leaf}; the CPU's f32 against its f64 "
            f"{own:.3f}, {own_leaf}); "
            f"batch {batch}: {step_ms:.3f} ms/step = "
            f"{batch / step_ms * 1e3:.0f} images/s, device busy share "
            f"{prof['busy_share']:.3f}, "
            f"{prof['kernel_launches_per_step']:.0f} launches a step; "
            f"[{card}]")
        out[name] = dict(f64_rule=f64_rule, f64_worst_leaf=f64_leaf,
                         f64_loss_rel=f64_loss_rel, f32_act_rel=acts,
                         f32_grad_rule=plain, f32_grad_worst_leaf=plain_leaf,
                         cpu_f32_vs_f64_rule=own,
                         cpu_f32_vs_f64_worst_leaf=own_leaf,
                         f32_loss_rel=loss_rel, batch=batch,
                         step_ms=step_ms,
                         images_per_s=batch / step_ms * 1e3, profile=prof)
        del net, xb, yb
        torch.cuda.empty_cache()
    return out


def tf32_control(card):
    """The precision the convolution layers own: a VGG-sized convolution
    ([16, 56, 56, 128] by 3×3×128×128, f32) through ``ConvolutionLayer``
    and through a bare ``F.conv2d``, both on the card under torch's
    default cuDNN flags (TF32 allowed), against an f64 CPU reference. The
    layer must be f32-accurate (1e-5 of max|y|); the bare call shows what
    the flag would have cost."""
    import torch.nn.functional as F

    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers.convolution import (
        ConvolutionLayer)

    check(torch.backends.cudnn.allow_tf32, "tf32 control: run it with "
                                           "cuDNN's TF32 flag on")
    g = torch.Generator().manual_seed(7)
    x = torch.randn(16, 56, 56, 128, generator=g)
    W = torch.randn(3, 3, 128, 128, generator=g) / 34.0
    layer = ConvolutionLayer(n_out=128, kernel_size=3,
                             convolution_mode="same")
    layer.finalize(None)
    layer.set_n_in(InputType.convolutional(56, 56, 128))
    p = {"W": W.cuda(), "b": torch.zeros(128, device="cuda")}
    ref = layer.preactivate({"W": W.double(), "b": torch.zeros(
        128, dtype=torch.float64)}, x.double())
    got = layer.preactivate(p, x.cuda()).cpu().double()
    bare = F.conv2d(x.cuda().permute(0, 3, 1, 2), W.cuda().permute(
        3, 2, 0, 1), padding=1).permute(0, 2, 3, 1).cpu().double()
    scale = ref.abs().max().item()
    layer_err = (got - ref).abs().max().item() / scale
    bare_err = (bare - ref).abs().max().item() / scale
    check(layer_err <= 1e-5, f"tf32 control: the layer's f32 convolution "
                             f"is {layer_err:.3g} of max|y| off")
    log(f"  tf32 control: ConvolutionLayer {layer_err:.2e} of max|y| from "
        f"f64, a bare F.conv2d under torch's default flags "
        f"{bare_err:.2e}; [{card}]")
    return dict(layer_rel_err=layer_err, bare_conv2d_rel_err=bare_err)


def phase_multilayer(card, profile):
    """Phase 8: the MultiLayerNetwork substrate at the zoo widths, with
    cuDNN's TF32 flag at torch's default (True) for the whole phase: the
    convolution layers must hold f32 themselves."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        control = tf32_control(card)
        log("phase 8a: LeNet on synthetic MNIST: fit, evaluate, zip")
        lenet = phase_lenet(card, profile)
        log("phase 8b: the committed conv-net fixture on the card")
        fixture = phase_convnet_fixture(card)
        log("phase 8c: int8 LeNet eval parity")
        int8 = phase_int8_lenet(card)
        log("phase 8d: SimpleCNN, AlexNet and VGG16 at their zoo shapes")
        big = phase_big_cnns(card)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return dict(tf32_control=control, lenet=lenet, convnet_fixture=fixture,
                int8_lenet=int8, big_cnns=big)


# ----------------------------------------------------------------- phase 9
#: phase-9 fleets: replicas of the phase-5 server, all on the one card
FLEET_REPLICAS = 2
#: phase 9c: single-row submits through ParallelInference, coalesced into
#: full batches of PI_BATCH consecutive rows (a 10 s window never expires)
PI_SUBMITS = 64
PI_BATCH = 16
#: phase 9c trains its LeNet on this many synthetic MNIST batches first
PI_TRAIN_BATCHES = 32
#: phase 9e: open-loop Poisson arrivals against a fleet
LOAD_RATE = 12.0
LOAD_SECONDS = 4.0
#: phase 9d: the keys of the JAX KerasBackendServer's /stats with a
#: generation fleet and a ParallelInference attached (tests/test_metrics.py's
#: SERVER_KEYS, then the blocks those two add)
SERVER_STATS_KEYS = ["retried", "expired", "rejected_circuit", "completed",
                     "failed", "accepted", "rejected", "pending",
                     "breaker_state", "models", "generation", "handoff",
                     "inference"]


def fabric_net():
    """The slice model on the card with phase 5's weights (phase 7 trains
    the phase-5 net in place)."""
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.utils.convert import params_from_jax

    net = TransformerLM(**SLICE).init(device="cuda")
    params_from_jax(numpy_params(net, seed=0), net)
    return net


def fabric_requests(net, greedy=None, sampled=None):
    """Phase 9's traffic: the 16 phase-5 requests, then the 8 sampled ones
    of phase 5b, each with the tokens it must return (phase 5's and 5b's
    streams; a run of phase 9 alone serves them once through one server)."""
    reqs = [(p, n, {}) for p, n in serve_requests()]
    mixed = sampled_requests()
    if greedy is None:
        greedy = uncounted(serve, net, reqs)[0]
    if sampled is None:
        sampled = uncounted(serve, net, mixed)[0]
    want = list(greedy)
    for i in range(1, len(mixed), 2):
        reqs.append(mixed[i])
        want.append(sampled[i])
    return reqs, want


def fleet_of(net, roles=None, **kw):
    """A ``ReplicaFleet`` of ``FLEET_REPLICAS`` phase-5 servers on the
    card (``roles``: one serving role per replica)."""
    from deeplearning4j_torch.parallel.fleet import ReplicaFleet
    from deeplearning4j_torch.parallel.generation import GenerationServer

    def factory(rid):
        return GenerationServer(net, SLICE["num_labels"], device="cuda",
                                role=roles[rid] if roles else "unified",
                                **SERVER)
    return ReplicaFleet(factory, replicas=FLEET_REPLICAS, roles=roles, **kw)


def fleet_serve(fleet, reqs, after_submit=None):
    """Submit every request, run ``after_submit()``, wait for all: (token
    lists, wall seconds)."""
    t0 = time.perf_counter()
    futs = [fleet.submit(p, n, **o) for p, n, o in reqs]
    if after_submit is not None:
        after_submit()
    outs = [f.result(timeout=300).tolist() for f in futs]
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def wait_for(pred, timeout, what):
    limit = time.monotonic() + timeout
    while not pred():
        check(time.monotonic() < limit, f"timed out waiting for {what}")
        time.sleep(0.005)


def check_fleet(tag, st, completed):
    """Zero lost futures: every accepted request completed."""
    ledger = {k: st[k] for k in ("submitted", "completed", "failed",
                                 "expired", "rejected_submits", "inflight",
                                 "parked")}
    check(ledger["completed"] == completed and ledger["failed"] == 0
          and ledger["expired"] == 0 and ledger["inflight"] == 0
          and ledger["parked"] == 0
          and ledger["submitted"] == completed + ledger["rejected_submits"],
          f"{tag}: fleet ledger {ledger}")


def phase_fleet_failover(net, reqs, want, card):
    """Phase 9a: a two-replica fleet on the card serves the phase-9
    traffic once clean (its tokens/s beside one server's on the same
    requests), then again with replica 0 killed once it is decoding: every
    stream equal to phase 5's or 5b's, one death, nothing lost, and the
    killed replica's server gone and its pool freed (``memory_allocated``
    before the fleet, with two live replicas and after the respawn, each
    read with cuBLAS's cached workspaces released: every new thread's
    cuBLAS handle caches a 32 MiB workspace on this card, a pool's worth,
    which is not the replica's memory)."""
    import gc
    import weakref

    def settled_memory():
        gc.collect()
        torch.cuda.synchronize()
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        return torch.cuda.memory_allocated()

    ntok = sum(len(w) for w in want)
    single, single_wall, _ = uncounted(serve, net, reqs)
    check(single == want, "fleet: one server's streams differ from phase "
                          "5's/5b's")
    mem0 = settled_memory()
    fleet = fleet_of(net, restart_backoff_s=0.05)
    killed = []
    try:
        mem_two = settled_memory()
        outs, wall = fleet_serve(fleet, reqs)
        check(outs == want, "fleet: a stream differs from phase 5's/5b's")
        check_fleet("fleet", fleet.stats(), len(reqs))

        def kill_when_decoding():
            def decoding():
                blk = fleet.stats()["replicas"][0]
                return blk["inflight"] > 0 and \
                    (blk["server"] or {}).get("tokens_generated", 0) > 0
            wait_for(decoding, 60, "replica 0 to decode")
            killed.append(weakref.ref(fleet._replicas[0].server))
            check(fleet.kill_replica(0), "fleet: replica 0 was not live")

        outs2, wall2 = fleet_serve(fleet, reqs, kill_when_decoding)
        check(outs2 == want, "fleet failover: a stream differs from phase "
                             "5's/5b's")
        st = fleet.stats()
        check(st["deaths"] >= 1, f"fleet failover: deaths {st['deaths']}")
        check_fleet("fleet failover", st, 2 * len(reqs))
        wait_for(lambda: fleet.stats()["replicas"][0]["state"] == "ready"
                 and fleet.stats()["replicas"][0]["restarts"] >= 1, 60,
                 "replica 0's respawn")
        st = fleet.stats()
        mem_respawned = settled_memory()
        check(killed[0]() is None, "fleet: the killed replica's server is "
                                   "still reachable after its respawn")
    finally:
        fleet.close()
    gc.collect()
    torch.cuda.synchronize()
    mem_closed = torch.cuda.memory_allocated()
    two = mem_two - mem0
    check(two > 0 and mem_respawned - mem0 <= 1.25 * two,
          f"fleet: the killed replica's memory was not freed (before "
          f"{mem0}, two live {mem_two}, after the respawn {mem_respawned} "
          f"bytes)")
    r = dict(requests=len(reqs), tokens=ntok, wall_s=wall,
             tokens_per_s=ntok / wall, single_wall_s=single_wall,
             single_tokens_per_s=ntok / single_wall, failover_wall_s=wall2,
             failover_tokens_per_s=ntok / wall2, deaths=st["deaths"],
             restarts=st["restarts"], redispatched=st["redispatched"],
             handoff_resumes=st["handoff_resumes"],
             mem_before=mem0, mem_two_replicas=mem_two,
             mem_after_respawn=mem_respawned, mem_after_close=mem_closed,
             dispatched=[b["dispatched"] for b in st["replicas"]])
    log(f"  fleet: {len(reqs)} requests ({ntok} tokens) on 2 replicas "
        f"{ntok / wall:.1f} tok/s, one server {ntok / single_wall:.1f} tok/s; "
        f"replica 0 killed mid-run: {ntok / wall2:.1f} tok/s, deaths "
        f"{st['deaths']}, {st['redispatched']} re-dispatched, every stream "
        f"equal to phase 5's/5b's, none lost; memory {mem0} -> {mem_two} "
        f"(two replicas) -> {mem_respawned} (respawned) -> {mem_closed} "
        f"(closed) bytes; [{card}]")
    return r


def hist_ms(h):
    return dict(count=h.count, p50=h.quantile(0.5), p99=h.quantile(0.99),
                mean=(h.sum / h.count) if h.count else None)


def phase_tiered(net, reqs, want, card):
    """Phase 9b: a prefill/decode fleet serves the 16 phase-5 requests
    (every one crossing the tiers, streams equal to phase 5's; TTFT and
    inter-token latency from ``fleet_ttft_ms``/``fleet_itl_ms``), then a
    fleet whose decode tier is dark serves co-located on the prefill
    replica, streams still phase 5's."""
    roles = ("prefill", "decode")
    fleet = fleet_of(net, roles=roles)
    try:
        outs, wall = fleet_serve(fleet, reqs)
        st = fleet.stats()
        ttft, itl = hist_ms(fleet.ttft_hist), hist_ms(fleet.itl_hist)
    finally:
        fleet.close()
    check(outs == want, "tiered: a stream differs from phase 5's")
    check_fleet("tiered", st, len(reqs))
    check(st["tier_handoffs"] >= len(reqs) and not st["degraded_mode"],
          f"tiered: {st['tier_handoffs']} handoffs, degraded "
          f"{st['degraded_mode']}")
    check(ttft["count"] == itl["count"] == len(reqs),
          f"tiered: TTFT/ITL observed {ttft['count']}/{itl['count']} times")
    dark = fleet_of(net, roles=roles, restart_backoff_s=600.0)
    try:
        check(dark.kill_replica(1), "tiered: the decode replica was not live")
        outs2, wall2 = fleet_serve(dark, reqs[:4])
        st2 = dark.stats()
    finally:
        dark.close()
    check(outs2 == want[:4], "degraded: a stream differs from phase 5's")
    check(st2["degraded_mode"] and st2["degraded_submits"] >= 4,
          f"degraded: mode {st2['degraded_mode']}, "
          f"{st2['degraded_submits']} co-located submits")
    ntok = sum(len(w) for w in want)
    log(f"  tiered: {len(reqs)} requests prefill -> decode, "
        f"{st['tier_handoffs']} handoffs, {ntok / wall:.1f} tok/s; TTFT p50 "
        f"{ttft['p50']:.2f} ms p99 {ttft['p99']:.2f} ms, ITL p50 "
        f"{itl['p50']:.3f} ms p99 {itl['p99']:.3f} ms; decode tier dark: 4 "
        f"requests co-located ({st2['degraded_submits']} degraded submits); "
        f"streams equal to phase 5's; [{card}]")
    return dict(requests=len(reqs), wall_s=wall, tokens_per_s=ntok / wall,
                tier_handoffs=st["tier_handoffs"], ttft_ms=ttft, itl_ms=itl,
                degraded_submits=st2["degraded_submits"],
                degraded_wall_s=wall2)


def host_rows(out):
    return out.detach().cpu().numpy()


def pi_rows(model, x, **kw):
    """``PI_SUBMITS`` single-row submits through one ``ParallelInference``
    (full ``PI_BATCH``-row batches): (rows, stats, wall seconds)."""
    from deeplearning4j_torch.parallel.inference import ParallelInference

    inf = ParallelInference(model, max_batch=PI_BATCH, max_wait_ms=10_000.0,
                            device="cuda", **kw)
    try:
        t0 = time.perf_counter()
        futs = [inf.submit(x[i:i + 1]) for i in range(len(x))]
        rows = np.concatenate([f.result(timeout=120) for f in futs])
        wall = time.perf_counter() - t0
        st = inf.stats()
    finally:
        inf.close()
    return rows, st, wall


def phase_coalescer(net, card):
    """Phase 9c: 64 single-row submits through ``ParallelInference`` over
    LeNet (trained on 32 synthetic MNIST batches, then the test images)
    and over the slice model: 4
    forwards of 16 rows, each row bit for bit the net's own ``output()``
    of its 16-row batch and within 1e-5 of max|y| of an unpadded
    ``output()`` of the row alone; int8 LeNet under the JAX package's
    quantized-serving rule (confusion delta <= 0.05, rows within 5e-2).
    Returns (LeNet, its images, its rows, measurements)."""
    from deeplearning4j_torch.evaluation.classification import Evaluation
    from deeplearning4j_torch.models.zoo import LeNet
    from deeplearning4j_torch.optimize.quantize import confusion_delta

    lenet = LeNet(num_labels=10, seed=1).init(device="cuda")
    # trained first: an untrained LeNet's near-uniform rows put near-ties
    # under the int8 rule's argmax
    lenet.fit(mnist_nhwc(True, LENET_BATCH * PI_TRAIN_BATCHES, LENET_BATCH))
    test = mnist_nhwc(False, PI_SUBMITS, PI_SUBMITS)[0]
    rs = np.random.RandomState(3)
    V, T = SLICE["num_labels"], SLICE["max_length"]
    x_lm = np.eye(V, dtype=np.float32)[rs.randint(0, V, (PI_SUBMITS, T))]
    results, rows_of = {}, {}
    for tag, model, x in (("lenet", lenet, test.features),
                          ("transformer", net, x_lm)):
        rows, st, wall = pi_rows(model, x)
        batched = uncounted(lambda: np.concatenate(
            [host_rows(model.output(x[k:k + PI_BATCH]))
             for k in range(0, PI_SUBMITS, PI_BATCH)]))
        alone = uncounted(lambda: np.concatenate(
            [host_rows(model.output(x[i:i + 1]))
             for i in range(PI_SUBMITS)]))
        scale = float(np.abs(alone).max())
        err = float(np.abs(rows - alone).max())
        check(st["dispatches"] == PI_SUBMITS // PI_BATCH
              and st["completed"] == PI_SUBMITS,
              f"coalescer {tag}: {st['dispatches']} dispatches for "
              f"{PI_SUBMITS} submits")
        check(np.array_equal(rows, batched),
              f"coalescer {tag}: rows differ from output() of the same "
              f"{PI_BATCH}-row batches")
        check(err <= 1e-5 * scale, f"coalescer {tag}: rows vs unpadded "
                                   f"output() {err:.3g} > 1e-5 x {scale:.3g}")
        rows_of[tag] = rows
        results[tag] = dict(submits=PI_SUBMITS, dispatches=st["dispatches"],
                            dispatches_per_submit=st["dispatches"]
                            / PI_SUBMITS, wall_s=wall,
                            rows_per_s=PI_SUBMITS / wall,
                            max_abs_err_vs_alone=err, max_abs_y=scale)
        log(f"  coalescer {tag}: {PI_SUBMITS} single-row submits in "
            f"{st['dispatches']} forwards ({PI_SUBMITS / wall:.0f} rows/s), "
            f"rows bitwise output() of their batches, {err:.2e} from "
            f"output() alone (max|y| {scale:.3g}); [{card}]")
    q_rows, q_st, _ = pi_rows(lenet, test.features, quantize="int8")
    ev_f, ev_q = Evaluation(), Evaluation()
    ev_f.eval(test.labels, rows_of["lenet"])
    ev_q.eval(test.labels, q_rows)
    delta = confusion_delta(ev_f, ev_q)
    q_err = float(np.abs(q_rows - rows_of["lenet"]).max())
    check(delta <= 0.05 and q_err <= 5e-2,
          f"coalescer int8 lenet: confusion delta {delta}, rows {q_err:.3g}")
    results["int8_lenet"] = dict(confusion_delta=delta, max_abs_err=q_err,
                                 dispatches=q_st["dispatches"])
    log(f"  coalescer int8 lenet: confusion delta {delta:.4f}, rows within "
        f"{q_err:.2e} of f32; [{card}]")
    return lenet, test.features, rows_of["lenet"], results


def fit_batches(tmp):
    """Two ``.npz`` batches of phase 7's shape (16 x 128 tokens): the
    phase-7 batch and one drawn from RandomState(8)."""
    V, T = SLICE["num_labels"], SLICE["max_length"]
    eye = np.eye(V, dtype=np.float32)
    tok = np.random.RandomState(8).randint(0, V, (TRAIN_BATCH, T + 1))
    paths = []
    for i, (x, y) in enumerate((train_batch(),
                                (eye[tok[:, :-1]], eye[tok[:, 1:]]))):
        path = os.path.join(tmp, f"batch{i}.npz")
        np.savez(path, features=x, labels=y)
        paths.append(path)
    return paths


def direct_fit(net, paths):
    from deeplearning4j_torch.datasets.dataset import DataSet

    scores = []
    for p in paths:
        with np.load(p) as z:
            net.fit(DataSet(z["features"], z["labels"]))
        scores.append(float(net.score_value))
    return scores


def phase_http(net, lenet, images, lenet_rows, reqs, want, card):
    """Phase 9d: ``KerasBackendServer`` on port 0 with a two-replica fleet
    behind ``/generate``, a coalescing ``ParallelInference`` over LeNet
    behind ``/predict`` and a copy of the slice model for ``/fit``: eight
    concurrent ``/generate`` requests (4 greedy, 4 sampled) return phase
    5's/5b's tokens, ``/predict`` 9c's rows bit for bit, ``/stats`` the
    JAX server's keys, ``/metrics`` the fleet, inference and server
    families, and ``/fit`` on two batches of phase 7's shape the losses (and parameters)
    of ``fit`` called directly from the same start, bit for bit."""
    import urllib.error
    import urllib.request

    from deeplearning4j_torch.modelimport.server import KerasBackendServer

    srv = KerasBackendServer()
    fit_net, ref_net = net.clone(), net.clone()
    try:
        gen_kw = {k: v for k, v in SERVER.items() if k != "slots"}
        gmid = srv.attach_generation(net, vocab=SLICE["num_labels"],
                                     slots=SERVER["slots"],
                                     replicas=FLEET_REPLICAS, mid="lm",
                                     device="cuda", **gen_kw)
        pmid = srv.attach_inference(lenet, mid="lenet", max_batch=PI_BATCH,
                                    max_wait_ms=10_000.0, device="cuda")
        fmid = srv.attach_inference(fit_net, mid="lm_fit", device="cuda")
        base = f"http://127.0.0.1:{srv.start()}"

        def post(path, body):
            req = urllib.request.Request(
                base + path, json.dumps(body).encode(),
                {"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=300) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        def get(path):
            with urllib.request.urlopen(base + path, timeout=60) as resp:
                return resp.read()

        picks = [0, 1, 2, 3] + list(range(16, 20))
        answers = {}

        def generate(i):
            p, n, o = reqs[i]
            answers[i] = post("/generate", dict(
                model=gmid, prompt_ids=[int(t) for t in p], max_tokens=n,
                **o))

        threads = [threading.Thread(target=generate, args=(i,))
                   for i in picks]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        gen_wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "http: a /generate "
                                                      "request hung")
        for i in picks:
            status, body = answers[i]
            check(status == 200 and body["tokens"] == want[i],
                  f"http /generate request {i}: {status}, tokens differ "
                  f"from phase 5's/5b's")
        status, body = post("/predict", {"model": pmid,
                                         "features": images[:PI_BATCH]
                                         .tolist()})
        check(status == 200 and np.array_equal(
            np.asarray(body["output"], np.float32), lenet_rows[:PI_BATCH]),
            f"http /predict: {status}, rows differ from 9c's")
        stats = json.loads(get("/stats"))
        check(list(stats) == SERVER_STATS_KEYS
              and len(stats["generation"][gmid]["replicas"]) == 2,
              f"http /stats: keys {list(stats)}")
        text = get("/metrics").decode()
        for fam in (f'fleet_completed_total{{model="{gmid}"}}',
                    f'inference_completed_total{{model="{pmid}"}}',
                    "server_completed_total"):
            check(fam in text, f"http /metrics: no {fam}")
        with tempfile.TemporaryDirectory() as tmp:
            paths = fit_batches(tmp)
            t0 = time.perf_counter()
            fits = [post("/fit", {"model": fmid, "batches": [p]})
                    for p in paths]
            fit_wall = time.perf_counter() - t0
            check(all(s == 200 for s, _ in fits), f"http /fit: {fits}")
            ref_scores = uncounted(direct_fit, ref_net, paths)
        scores = [b["score"] for _, b in fits]
        check(scores == ref_scores and all(
            torch.equal(t, ref_net.params[k][n])
            for k, p in fit_net.params.items() for n, t in p.items()),
            f"http /fit: losses {scores} vs fit() directly {ref_scores}")
        srv_stats = srv.stats()
    finally:
        srv.stop()
    log(f"  http: {len(picks)} concurrent /generate through the fleet in "
        f"{gen_wall:.3f} s, tokens equal to phase 5's/5b's; /predict rows "
        f"bitwise 9c's; /stats JAX's keys; /metrics fleet, inference and "
        f"server families; /import a structured 500 naming A12; /fit two "
        f"16 x 128 batches, losses {scores} bitwise fit() called directly "
        f"({fit_wall:.3f} s); [{card}]")
    return dict(generate_requests=len(picks), generate_wall_s=gen_wall,
                fit_losses=scores, fit_wall_s=fit_wall,
                completed=srv_stats["completed"],
                failed=srv_stats["failed"])


def phase_load(net, reqs, want, card):
    """Phase 9e: ``LoadGenerator.run_open`` Poisson arrivals at
    ``LOAD_RATE`` req/s for ``LOAD_SECONDS`` s against a two-replica fleet
    (the phase-9 requests in turn) with an ``Autoscaler`` ticking every
    0.1 s on a ``FleetTierTarget``: nothing lost, every stream phase 5's or
    5b's; achieved req/s, p50/p99 latency and the decisions."""
    from deeplearning4j_torch.metrics.autoscale import (Autoscaler,
                                                        FleetTierTarget)
    from deeplearning4j_torch.metrics.loadgen import LoadGenerator

    fleet = fleet_of(net)
    futs = {}

    def submit(i):
        p, n, o = reqs[i % len(reqs)]
        futs[i] = fleet.submit(p, n, **o)
        return futs[i]

    scaler = Autoscaler([FleetTierTarget(fleet, "unified")], high_depth=4,
                        low_depth=1, up_ticks=2, down_ticks=3,
                        cooldown_s=0.5)
    try:
        scaler.start(interval_s=0.1)
        res = LoadGenerator(submit, seed=0).run_open(
            lambda t: LOAD_RATE, LOAD_SECONDS, LOAD_RATE, timeout_s=300)
        scaler.stop()
        outs = {i: f.result(timeout=60).tolist() for i, f in futs.items()}
        st = fleet.stats()
    finally:
        scaler.stop()
        fleet.close()
    check(res.submitted > 0 and res.lost == 0 and res.failed == 0
          and res.completed == res.submitted == len(outs),
          f"load: {res.as_dict()}")
    check(all(outs[i] == want[i % len(want)] for i in outs),
          "load: a stream differs from phase 5's/5b's")
    check_fleet("load", st, res.submitted)
    d = res.as_dict()
    decisions = [x.as_dict() for x in scaler.decisions]
    log(f"  load: {d['submitted']} Poisson arrivals at {LOAD_RATE} req/s "
        f"over {LOAD_SECONDS} s: {d['achieved_req_s']:.2f} req/s achieved, "
        f"p50 {d['p50_ms']:.1f} ms, p99 {d['p99_ms']:.1f} ms, lost "
        f"{d['lost']}; autoscaler decisions "
        f"{[(x['action'], x['level_from'], x['level_to']) for x in decisions]}"
        f"; streams equal to phase 5's/5b's; [{card}]")
    return dict(d, rate=LOAD_RATE, duration_planned_s=LOAD_SECONDS,
                decisions=decisions)


def phase_fabric(card, greedy=None, sampled=None):
    """Phase 9: the serving fabric at the slice's width (9a-9e)."""
    net = fabric_net()
    reqs, want = fabric_requests(net, greedy, sampled)
    t0 = time.perf_counter()
    log("phase 9a: a two-replica fleet, a replica killed mid-run")
    fleet = phase_fleet_failover(net, reqs, want, card)
    log("phase 9b: a prefill/decode fleet, then its decode tier dark")
    tiered = phase_tiered(net, reqs[:16], want[:16], card)
    log("phase 9c: ParallelInference over LeNet and the slice model")
    lenet, images, lenet_rows, coalescer = phase_coalescer(net, card)
    log("phase 9d: KerasBackendServer over HTTP")
    http = phase_http(net, lenet, images, lenet_rows, reqs, want, card)
    log("phase 9e: open-loop load with an autoscaler")
    load = phase_load(net, reqs, want, card)
    wall = time.perf_counter() - t0
    log(f"  phase 9: {wall:.1f} s; [{card}]")
    return dict(fleet=fleet, tiered=tiered, coalescer=coalescer, http=http,
                load=load, wall_s=wall)


# --------------------------------------------------------------------------
# phase 10: retrieval and RAG
# --------------------------------------------------------------------------
#: ``bench.py::bench_knn_serve``'s store: 1M clustered vectors of 32 dims
#: (1,024 centers), 256 one-row queries (64 served serially), IVF with
#: 1,024 partitions probed 8 deep
KNN = dict(n=1_000_000, d=32, partitions=1024, nprobe=8, queries=256,
           serial=64, deadline_s=10.0, max_wait_ms=20.0)
#: the cosine store and the int8 capacity twins (the bench's 65,536 rows)
COS_ROWS = 65_536
#: ``bench.py::bench_serve_rag``: 10M vectors of 16 dims in an int8 IVF
#: store, 96 Zipf (s = 1.1) requests over 64 hot documents after a hot and
#: a cold burst of 12, 8 new tokens, 24-token passages, k = 2, page size 8
RAG = dict(n=10_000_000, d=16, partitions=1024, nprobe=8, requests=96,
           hot=64, burst=12, tokens=8, deadline_s=60.0, passage_len=24,
           k=2, page_size=8, slots=8)
#: squared euclidean distances from the expansion ||q||^2 - 2 q.p + ||p||^2
#: round relative to the norms: two f32 computations of one distance
#: agree within SQ_REL * (max||q||^2 + max||p||^2); cosine within COS_ATOL
SQ_REL = 2.0 ** -20
COS_ATOL = 1e-4
#: t-SNE at 2,000 x 50 (four clusters), ten iterations
TSNE = dict(n=2000, d=50, iters=10, perplexity=30.0)
#: t-SNE is chaotic: a rounding difference grows about 2x a step once the
#: embedding spreads, so ten steps card against CPU are held within this
#: share of max|y| (the CPU parity tests hold five steps to 1e-4); the
#: sparse P within P_REL of its largest entry (kNN near-ties at the k-th
#: neighbour may swap one small edge)
TSNE_REL = 1e-2
P_REL = 1e-3


class VirtualPassages:
    """``bench.py::_VirtualPassages``: doc id -> token ids, computed on
    demand (the 10M-document corpus never materializes)."""

    def __init__(self, vocab, length=24):
        self.vocab = int(vocab)
        self.length = int(length)

    def __getitem__(self, i):
        rs = np.random.RandomState((int(i) * 2654435761) & 0x7FFFFFFF)
        return rs.randint(1, self.vocab, size=self.length).astype(np.int64)


def knn_store():
    """``bench_knn_serve``'s draw: RandomState(0), centers x 2.0 plus
    noise x 0.6, queries perturbed corpus rows."""
    n, d, c, nq = KNN["n"], KNN["d"], KNN["partitions"], KNN["queries"]
    rs = np.random.RandomState(0)
    centers = rs.randn(c, d).astype(np.float32) * 2.0
    pts = (centers[rs.randint(0, c, n)]
           + rs.randn(n, d).astype(np.float32) * 0.6)
    qs = (pts[rs.choice(n, nq, replace=False)]
          + rs.randn(nq, d).astype(np.float32) * 0.2)
    return pts, qs


def exact_top(pts, qs, k, metric="euclidean"):
    """The k + 1 nearest exact distances of each query (float64 on the
    host; squared for euclidean, 1 - cos for cosine), ascending."""
    p = torch.from_numpy(pts).double()
    q = torch.from_numpy(np.ascontiguousarray(qs)).double()
    if metric == "cosine":
        p = p / p.norm(dim=1, keepdim=True).clamp_min(1e-12)
        q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
        d = 1.0 - q @ p.T
    else:
        d = (q * q).sum(1, keepdim=True) - 2.0 * (q @ p.T) + (p * p).sum(1)
    return torch.topk(d, k + 1, dim=1, largest=False).values.numpy()


def tie_rule(tag, got, want, pts, qs, metric="euclidean"):
    """Two searches of one store agree: (squared, for euclidean) distances
    within the rounding tolerance, ids equal at every rank whose exact
    distance is apart from both neighbouring ranks' by more than it."""
    (dg, ig), (dw, iw) = got, want
    check(dg.shape == dw.shape, f"{tag}: shapes {dg.shape} vs {dw.shape}")
    if metric == "cosine":
        tol, a, b = COS_ATOL, dg.astype(np.float64), dw.astype(np.float64)
    else:
        tol = SQ_REL * float(np.max(np.sum(qs * qs, 1))
                             + np.max(np.sum(pts * pts, 1)))
        a, b = dg.astype(np.float64) ** 2, dw.astype(np.float64) ** 2
    err = float(np.abs(a - b).max())
    check(err <= tol, f"{tag}: distances differ by {err:.3g} > {tol:.3g}")
    k = dg.shape[1]
    ref = exact_top(pts, qs, k, metric)
    full = np.concatenate([np.full((len(ref), 1), -np.inf), ref], axis=1)
    gap = np.minimum(full[:, 1:k + 1] - full[:, :k],
                     full[:, 2:k + 2] - full[:, 1:k + 1])
    clear = gap > tol
    bad = int((ig[clear] != iw[clear]).sum())
    check(bad == 0, f"{tag}: {bad} ids differ at ranks clear of ties")
    return dict(max_err=err, tol=tol, ranks=int(clear.size),
                near_ties=int((~clear).sum()),
                bitwise=bool(np.array_equal(dg, dw)
                             and np.array_equal(ig, iw)))


def peak_transient(fn):
    """(bytes the card allocated above what was resident while ``fn()``
    ran, fn's result)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base, out


def open_loop(index, qs, k=10, deadline_s=KNN["deadline_s"]):
    """``bench_knn_serve.open_loop``: one-row submits with a deadline,
    latency from done-callbacks; returns (rows in submit order, q/s, p99
    ms, failed). Every admitted future resolves."""
    from deeplearning4j_torch.parallel.resilience import (CircuitOpen,
                                                          DeadlineExceeded,
                                                          ServerOverloaded)

    lat, t_sub, futs = [], {}, []
    shed = failed = 0
    t0 = time.perf_counter()
    for i in range(len(qs)):
        try:
            f = index.submit(qs[i:i + 1], k, deadline_s=deadline_s)
        except (ServerOverloaded, CircuitOpen):
            shed += 1
            continue
        t_sub[id(f)] = time.monotonic()
        f.add_done_callback(
            lambda f: lat.append(time.monotonic() - t_sub[id(f)]))
        futs.append(f)
    rows = []
    for f in futs:
        try:
            rows.append(f.result(timeout=120))
        except (DeadlineExceeded, ServerOverloaded, CircuitOpen):
            failed += 1
    wall = time.perf_counter() - t0
    check(len(rows) + failed + shed == len(qs) and rows,
          f"open loop: {len(qs) - len(rows) - failed - shed} queries lost")
    d = np.concatenate([r[0] for r in rows])
    i = np.concatenate([r[1] for r in rows])
    p99 = float(np.percentile(np.asarray(lat) * 1e3, 99))
    check(p99 < deadline_s * 1e3, f"open loop: p99 {p99:.0f} ms")
    return (d, i), len(rows) / wall, p99, failed + shed


def phase_exact_store(pts, qs, card):
    """10a: the exact f32 store at 1M x 32 (and cosine at 65,536 rows)."""
    from deeplearning4j_torch.nearestneighbors.brute import (
        DeviceBruteForceIndex)
    from deeplearning4j_torch.nearestneighbors.index import EmbeddingIndex

    out = {}
    for metric, rows in (("euclidean", len(pts)), ("cosine", COS_ROWS)):
        p = pts[:rows]
        t0 = time.perf_counter()
        index = EmbeddingIndex(p, metric, device="cuda",
                               max_batch=KNN["queries"],
                               max_wait_ms=KNN["max_wait_ms"],
                               max_pending=4 * KNN["queries"])
        build = time.perf_counter() - t0
        brute = DeviceBruteForceIndex(p, metric, device="cuda")
        try:
            for q in (qs[:64], qs):
                a = index.search_batch_arrays(q, 10)
                b = brute.search_batch_arrays(q, 10)
                c = index.search_batch_arrays(q, 10)
                check(all(np.array_equal(x, y) for x, y in zip(a, b))
                      and all(np.array_equal(x, y) for x, y in zip(a, c)),
                      f"10a {metric}: EmbeddingIndex not bitwise the brute "
                      f"index (or itself) at Q={len(q)}")
            cpu = DeviceBruteForceIndex(p, metric, device="cpu")
            vs_cpu = tie_rule(f"10a {metric} vs CPU",
                              index.search_batch_arrays(qs[:64], 10),
                              cpu.search_batch_arrays(qs[:64], 10),
                              p, qs[:64], metric)
            del cpu
            res = dict(build_s=build, vs_cpu=vs_cpu,
                       resident_bytes=index.resident_bytes)
            if metric == "euclidean":
                res.update(serve_store(index, p, qs))
        finally:
            index.close()
            del brute
        out[metric] = res
        log(f"  10a {metric} {rows} x {KNN['d']}: bitwise the brute index, "
            f"vs CPU max |d^2 err| {vs_cpu['max_err']:.3g} "
            f"(tol {vs_cpu['tol']:.3g}, near-ties {vs_cpu['near_ties']}); "
            f"[{card}]")
    return out


def serve_store(index, pts, qs):
    """The serial loop and the coalesced open loop on one store, then one
    Q = 256 dispatch's device time and peak transient beside its bound."""
    n, d = pts.shape
    nq = len(qs)
    sync = index.search_batch_arrays(qs, 10)
    t0 = time.perf_counter()
    for i in range(KNN["serial"]):
        index.submit(qs[i:i + 1], 10).result(timeout=120)
    serial = KNN["serial"] / (time.perf_counter() - t0)
    d0 = index.stats()["dispatches"]
    rows, qps, p99, failed = open_loop(index, qs)
    dispatches = index.stats()["dispatches"] - d0
    check(failed == 0, f"10a: {failed} coalesced queries failed")
    coalesced = tie_rule("10a coalesced vs sync", rows, sync, pts, qs)
    kb = 16
    ms, launches = device_ms(lambda: index._dispatch_knn(qs, kb), iters=5)
    peak, _ = peak_transient(lambda: index._dispatch_knn(qs, kb))
    nbytes = index.resident_bytes + nq * d * 4 + nq * kb * 8
    bound, by = bound_ms(nbytes, 2 * nq * n * d, "f32")
    store_ms = index.resident_bytes / PEAK_BYTES_S * 1e3
    log(f"  10a serial {serial:.1f} q/s; coalesced {qps:.1f} q/s "
        f"({qps / serial:.1f}x), p99 {p99:.1f} ms, {dispatches} dispatches "
        f"for {nq} submits (bitwise sync: {coalesced['bitwise']}); one "
        f"Q={nq} dispatch {ms:.4f} device ms, {launches:.0f} launches, "
        f"bound {bound:.4f} ms ({by}; the store's bytes alone "
        f"{store_ms:.4f} ms), peak transient {peak} B")
    return dict(serial_q_s=serial, coalesced_q_s=qps, p99_ms=p99,
                dispatches=dispatches, coalesced=coalesced,
                dispatch_device_ms=ms, dispatch_launches=launches,
                bound_ms=bound, bound_by=by, store_bytes_ms=store_ms,
                peak_transient_bytes=peak)


def phase_int8_store(pts, qs, card):
    """10b: the int8 flat store at 1M x 32: recall, capacity, the widening
    transient of one dispatch, a bitwise rebuild after drain/close."""
    from deeplearning4j_torch.nearestneighbors.index import EmbeddingIndex

    twins = [EmbeddingIndex(pts[:COS_ROWS], store=s, device="cuda")
             for s in ("f32", "int8")]
    capacity = twins[0].resident_bytes / twins[1].resident_bytes
    for t in twins:
        t.close()
    check(capacity >= 1.8, f"10b: int8 capacity {capacity:.2f}x < 1.8")
    t0 = time.perf_counter()
    index = EmbeddingIndex(pts, store="int8", device="cuda",
                           max_batch=KNN["queries"])
    build = time.perf_counter() - t0
    try:
        recall = index.measure_recall(qs[:64], k=10)
        check(recall >= 0.9, f"10b: int8 recall@10 {recall:.3f} < 0.9")
        peak, _ = peak_transient(lambda: index._dispatch_knn(qs, 16))
        ms, _ = device_ms(lambda: index._dispatch_knn(qs, 16), iters=5)
        first = index.search_batch_arrays(qs[:64], 10)
        index.submit(qs[:4], 5).result(timeout=120)
        check(index.drain(timeout=60), "10b: drain timed out")
        mid = index.search_batch_arrays(qs[:64], 10)
        held = index.resident_bytes
    finally:
        index.close()
    again = EmbeddingIndex(pts, store="int8", device="cuda")
    try:
        second = again.search_batch_arrays(qs[:64], 10)
    finally:
        again.close()
    rebuilt = all(np.array_equal(a, b) for a, b in zip(first, second)) \
        and all(np.array_equal(a, b) for a, b in zip(first, mid))
    check(rebuilt, "10b: the int8 rebuild after drain/close is not bitwise")
    widen = pts.shape[0] * pts.shape[1] * 4
    log(f"  10b int8 {pts.shape[0]} x {pts.shape[1]}: recall@10 "
        f"{recall:.4f}, capacity {capacity:.3f}x, resident {held} B, one "
        f"Q={len(qs)} dispatch {ms:.4f} device ms, peak transient {peak} B "
        f"(of it the f32 widening of the store {widen} B), rebuild bitwise; "
        f"[{card}]")
    return dict(recall=recall, capacity_x=capacity, build_s=build,
                resident_bytes=held, dispatch_device_ms=ms,
                peak_transient_bytes=peak, widening_bytes=widen,
                rebuild_bitwise=rebuilt)


def phase_ivf_store(pts, qs, card):
    """10c: IVF int8 at 1M x 32, 1,024 partitions probed 8 deep: recall,
    a full probe answering as the int8 flat store, build seconds, spills,
    and the coalesced open loop."""
    from deeplearning4j_torch.nearestneighbors.index import (
        EmbeddingIndex, _knn_ivf, _quantize_rows)

    t0 = time.perf_counter()
    ivf = EmbeddingIndex(pts, store="int8", partitions=KNN["partitions"],
                         nprobe=KNN["nprobe"], train_sample=32768,
                         kmeans_iters=10, seed=0, max_batch=64,
                         max_wait_ms=2.0, max_pending=4 * KNN["queries"],
                         device="cuda")
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    flat = EmbeddingIndex(pts, store="int8", device="cuda")
    try:
        recall = ivf.measure_recall(qs[:64], k=10)
        check(recall >= 0.95, f"10c: IVF recall@10 {recall:.3f} < 0.95")
        st = ivf.stats()
        # the full probe gathers every list: [4, 1024, list_len, 32]
        q4 = qs[:4]
        with torch.inference_mode():
            d, i = _knn_ivf(*ivf._store.arrays,
                            torch.as_tensor(q4, device="cuda"), k=16,
                            nprobe=st["partitions"], metric="euclidean")
        full = (d.cpu().numpy()[:, :10], i.cpu().numpy()[:, :10])
        q, s = _quantize_rows(pts)
        held = q.astype(np.float32) * s[:, None]
        full_probe = tie_rule("10c full probe vs the int8 flat store", full,
                              flat.search_batch_arrays(q4, 10), held, q4)
        peak, _ = peak_transient(lambda: ivf._dispatch_knn(qs[:64], 16))
        ms, _ = device_ms(lambda: ivf._dispatch_knn(qs[:64], 16), iters=5)
        _rows, qps, p99, failed = open_loop(ivf, qs)
        check(failed == 0, f"10c: {failed} IVF queries failed")
    finally:
        ivf.close()
        flat.close()
    log(f"  10c IVF int8: recall@10 {recall:.4f}, build {build:.2f} s, "
        f"list_len {st['list_len']}, spilled {st['spilled']}, full probe "
        f"as the flat store (near-ties {full_probe['near_ties']}); Q=64 "
        f"dispatch {ms:.4f} device ms, peak transient {peak} B; open loop "
        f"{qps:.1f} q/s, p99 {p99:.1f} ms; [{card}]")
    return dict(recall=recall, build_s=build, list_len=st["list_len"],
                spilled=st["spilled"], resident_bytes=st["resident_bytes"],
                full_probe=full_probe, dispatch_device_ms=ms,
                peak_transient_bytes=peak, q_s=qps, p99_ms=p99)


def phase_knn_http(pts, qs, card):
    """10d: ``NearestNeighborsServer(backend="index")`` on the card over
    HTTP: /knn (a point, points) as ``search_batch_arrays``, /encode with
    ``"add": true`` through a ``ParallelInference`` over a Dense
    MultiLayerNetwork on the card (/status grows), and the typed 400, 404,
    413 and 504."""
    import urllib.error
    import urllib.request

    from deeplearning4j_torch.nearestneighbors.index import EmbeddingIndex
    from deeplearning4j_torch.nearestneighbors.server import (
        NearestNeighborsServer)
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers.core import (DenseLayer,
                                                          OutputLayer)
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.parallel.inference import ParallelInference

    d = pts.shape[1]
    conf = (NeuralNetConfiguration.builder().seed(5)
            .list(DenseLayer(n_out=64, activation="relu"),
                  OutputLayer(n_out=d, activation="identity", loss="mse"))
            .set_input_type(InputType.feed_forward(16)).build())
    encoder = ParallelInference(MultiLayerNetwork(conf).init(device="cuda"),
                                device="cuda")
    index = EmbeddingIndex(pts, encoder=encoder, device="cuda")
    server = NearestNeighborsServer(index=index, port=0,
                                    max_body_bytes=1 << 20)
    try:
        base = f"http://127.0.0.1:{server.start()}"

        def post(path, body):
            req = urllib.request.Request(
                base + path, json.dumps(body).encode(),
                {"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=120) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        def status():
            with urllib.request.urlopen(base + "/status", timeout=60) as r:
                return json.loads(r.read())

        def answer(res):
            rows = res["results"]
            if rows and isinstance(rows[0], dict):
                rows = [rows]
            return ([[r["distance"] for r in row] for row in rows],
                    [[r["index"] for r in row] for row in rows])

        t0 = time.perf_counter()
        s1, one = post("/knn", {"k": 5, "point": qs[0].tolist()})
        s2, many = post("/knn", {"k": 5, "points": qs[:4].tolist()})
        http_s = time.perf_counter() - t0
        check(s1 == s2 == 200, f"10d: /knn answered {s1}, {s2}")
        for got, q in ((answer(one), qs[:1]), (answer(many), qs[:4])):
            dd, ii = index.search_batch_arrays(q, 5)
            check(got == (dd.astype(float).tolist(), ii.tolist()),
                  "10d: /knn does not answer as search_batch_arrays")
        before = status()["points"]
        docs = np.random.RandomState(9).randn(8, 16).astype(np.float32)
        se, enc = post("/encode", {"docs": docs.tolist(), "add": True})
        after = status()["points"]
        check(se == 200 and enc["added"] == 8 and after == before + 8,
              f"10d: /encode add answered {se}, points {before} -> "
              f"{after}")
        vecs = np.asarray(enc["vectors"], np.float32)
        check(np.array_equal(vecs, encoder.output(docs)),
              "10d: /encode vectors are not the encoder's output")
        _s, own = post("/knn", {"k": 1, "points": vecs[:3].tolist()})
        check([r[0]["index"] for r in own["results"]]
              == [before, before + 1, before + 2],
              f"10d: encoded docs do not find their own rows: {own}")
        codes = {
            "bad_k": post("/knn", {"k": 0, "point": qs[0].tolist()}),
            "dims": post("/knn", {"k": 1, "point": [1.0, 2.0]}),
            "not_found": post("/nope", {"k": 1}),
            "too_large": post("/knn", {"k": 1, "points":
                                       [[0.5] * d] * 8000}),
            "deadline": post("/knn", {"k": 1, "point": qs[0].tolist(),
                                      "deadline_s": 1e-6})}
        want = {"bad_k": (400, "BadRequest"), "dims": (400, "BadRequest"),
                "not_found": (404, "NotFound"),
                "too_large": (413, "BodyTooLarge"),
                "deadline": (504, "DeadlineExceeded")}
        got = {k: (s, b.get("error")) for k, (s, b) in codes.items()}
        check(got == want, f"10d: typed answers {got}")
    finally:
        server.stop()
        index.close()
        encoder.close()
    log(f"  10d HTTP: /knn point+points as search_batch_arrays "
        f"({http_s * 1e3:.1f} ms for both), /encode added 8 "
        f"({before} -> {after}), typed answers {sorted(got.values())}; "
        f"[{card}]")
    return dict(points_before=before, points_after=after,
                knn_http_ms=http_s * 1e3, typed=got)


def rag_store():
    """``bench_serve_rag``'s draw, chunked as there."""
    n, d, c = RAG["n"], RAG["d"], RAG["partitions"]
    rs = np.random.RandomState(0)
    centers = rs.randn(c, d).astype(np.float32) * 2.0
    pts = np.empty((n, d), np.float32)
    ch = 1 << 20
    for s in range(0, n, ch):
        m = min(ch, n - s)
        pts[s:s + m] = (centers[rs.randint(0, c, m)]
                        + rs.randn(m, d).astype(np.float32) * 0.6)
    return pts, rs


def phase_rag(card):
    """10e: RAG at ``bench_serve_rag``'s configuration, the generate tier
    the full-width slice model through K2."""
    from deeplearning4j_torch.nearestneighbors.index import EmbeddingIndex
    from deeplearning4j_torch.parallel.generation import (
        GenerationServer, assemble_passage_prefix)
    from deeplearning4j_torch.parallel.rag import RagPipeline
    from deeplearning4j_torch.parallel.resilience import (CircuitOpen,
                                                          DeadlineExceeded,
                                                          ServerOverloaded)

    pts, rs = rag_store()
    n, d, V = RAG["n"], RAG["d"], SLICE["num_labels"]
    t0 = time.perf_counter()
    index = EmbeddingIndex(pts, store="int8", partitions=RAG["partitions"],
                           nprobe=RAG["nprobe"], train_sample=32768,
                           kmeans_iters=10, seed=0, max_batch=64,
                           max_wait_ms=2.0, max_pending=4 * RAG["requests"],
                           device="cuda")
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    probe = (pts[rs.choice(n, 32, replace=False)]
             + rs.randn(32, d).astype(np.float32) * 0.2)
    recall = index.measure_recall(probe, k=10)
    check(recall >= 0.95, f"10e: 10M IVF recall@10 {recall:.3f} < 0.95")
    st_index = index.stats()
    hot_ids = rs.choice(n, RAG["hot"], replace=False)
    pz = 1.0 / np.arange(1, RAG["hot"] + 1, dtype=np.float64) ** 1.1
    pz /= pz.sum()
    targets = hot_ids[rs.choice(RAG["hot"], RAG["requests"], p=pz)]
    passages = VirtualPassages(V, RAG["passage_len"])
    net = fabric_net()
    rag = RagPipeline(
        lambda rid: index,
        lambda rid: GenerationServer(net, V, slots=RAG["slots"],
                                     page_size=RAG["page_size"],
                                     device="cuda"),
        passages, page_size=RAG["page_size"], k=RAG["k"],
        max_pending=4 * RAG["requests"], device="cuda")
    prompt = np.arange(1, 9, dtype=np.int64)
    tokens = RAG["tokens"]

    def q_for(doc, jitter):
        return pts[doc] + jitter * rs.randn(d).astype(np.float32)

    served = []                   # (future, tokens) of every request

    def one(q, **kw):
        f = rag.submit(prompt, tokens, query_vec=q, **kw)
        served.append((f, f.result(timeout=300).tolist()))

    try:
        hot = int(targets[0])
        for _ in range(2):
            one(q_for(hot, 0.0))
        t0 = time.perf_counter()
        for _ in range(RAG["burst"]):
            one(q_for(hot, 0.0))
        hot_ms = (time.perf_counter() - t0) * 1e3 / RAG["burst"]
        t0 = time.perf_counter()
        for cd in rs.choice(n, RAG["burst"], replace=False):
            one(q_for(int(cd), 0.0))
        cold_ms = (time.perf_counter() - t0) * 1e3 / RAG["burst"]
        lat, t_sub, futs = [], {}, []
        shed = failed = 0
        t0 = time.perf_counter()
        for i in range(RAG["requests"]):
            try:
                f = rag.submit(prompt, tokens,
                               query_vec=q_for(int(targets[i]), 0.05),
                               deadline_s=RAG["deadline_s"])
            except (ServerOverloaded, CircuitOpen):
                shed += 1
                continue
            t_sub[id(f)] = time.monotonic()
            f.add_done_callback(
                lambda f: lat.append(time.monotonic() - t_sub[id(f)]))
            futs.append(f)
        failures = []
        for f in futs:
            try:
                served.append((f, f.result(timeout=300).tolist()))
            except (DeadlineExceeded, ServerOverloaded, CircuitOpen) as e:
                failed += 1
                failures.append(f"{type(e).__name__}: {e}")
        wall = time.perf_counter() - t0
        ok = len(futs) - failed
        # JAX's bench_serve_rag claim: nothing lost, every failure typed
        # and counted. Shedding is typed at submit (the fleet's
        # per-replica admission of 64, as in the bench) and, as in JAX's
        # pipeline, after it: the generate tier's replica admission sheds
        # a request whose retrieval finished while the generate replica
        # held 64 (ROADMAP C10)
        lost = RAG["requests"] - ok - shed - failed
        check(lost == 0 and ok > 0,
              f"10e: {lost} lost, {failed} failed typed of "
              f"{RAG['requests']} ({shed} shed at submit): {failures}")
        p99 = float(np.percentile(np.asarray(lat) * 1e3, 99))
        st = rag.stats()
        check(st["expired"] == 0 and st["inflight"] == 0
              and st["submitted"] == st["completed"] + st["failed"]
              + st["expired"] + st["rejected"]
              and st["completed"] == len(served),
              f"10e: the rag ledger does not balance: {st}")
        check(st["prefix_hits"] > 0 and st["prefix_tokens_reused"] > 0,
              f"10e: no prefix hit ({st['prefix_hits']}, "
              f"{st['prefix_tokens_reused']})")
    finally:
        rag.close()
    # every stream is the plain-read server's on the assembled prompt
    prompts = []
    for f, _toks in served:
        want, _o, plen = assemble_passage_prefix(
            f._rag_docs, passages, page_size=RAG["page_size"],
            query_ids=prompt)
        check(np.array_equal(f._rag_prompt, want)
              and plen == f._rag_prefix_len,
              "10e: a RAG prompt is not the canonical assembly of its docs")
        prompts.append((want, tokens))
    ref = uncounted(plain_read_streams, net, prompts)
    differ = sum(toks != r for (_f, toks), r in zip(served, ref))
    check(differ == 0, f"10e: {differ} of {len(served)} RAG streams differ "
                       f"from the plain-read server's")
    route = rag_route(net, pts, passages, prompt, card)
    log(f"  10e RAG {n} x {d} int8 IVF: build {build:.2f} s, recall@10 "
        f"{recall:.4f}; {ok} Zipf requests ({shed} shed at submit, "
        f"{failed} after it: {failures}) "
        f"{ok / wall:.2f} req/s, p99 "
        f"{p99:.1f} ms; hot {hot_ms:.1f} ms/turn, cold {cold_ms:.1f} "
        f"ms/turn; prefix hits {st['prefix_hits']}, tokens reused "
        f"{st['prefix_tokens_reused']}; {len(served)} streams equal the "
        f"plain read; [{card}]")
    del pts
    return dict(build_s=build, recall=recall, req_s=ok / wall, p99_ms=p99,
                completed=ok, shed=shed, failed_after_admission=failed,
                failures=failures,
                hot_ms=hot_ms, cold_ms=cold_ms,
                prefix_hits=st["prefix_hits"],
                prefix_tokens_reused=st["prefix_tokens_reused"],
                streams=len(served), list_len=st_index["list_len"],
                spilled=st_index["spilled"],
                resident_bytes=st_index["resident_bytes"], route=route)


def plain_read_streams(net, reqs):
    """``reqs`` served by a generate-tier server with the plain paged read
    (``paged_attention="stock"``): the RAG streams' reference."""
    from deeplearning4j_torch.parallel.generation import GenerationServer

    srv = GenerationServer(net, SLICE["num_labels"], slots=RAG["slots"],
                           page_size=RAG["page_size"], device="cuda",
                           paged_attention="stock", max_pending=len(reqs))
    try:
        futs = [srv.submit(p, n) for p, n in reqs]
        return [f.result(timeout=600).tolist() for f in futs]
    finally:
        srv.close()


def rag_route(net, pts, passages, prompt, card):
    """One ``/rag`` call through ``KerasBackendServer.attach_rag`` (an int8
    flat store over the first 65,536 documents) answers as the pipeline's
    own ``submit``."""
    import urllib.request

    from deeplearning4j_torch.modelimport.server import KerasBackendServer

    srv = KerasBackendServer()
    docs = pts[:COS_ROWS]
    try:
        mid = srv.attach_rag(net, vocab=SLICE["num_labels"],
                             passages=passages, doc_vectors=docs,
                             k=RAG["k"], slots=RAG["slots"],
                             page_size=RAG["page_size"], mid="rag",
                             index_kw={"store": "int8"}, device="cuda")
        base = f"http://127.0.0.1:{srv.start()}"
        q = docs[123] + 0.01
        body = json.dumps({"model": mid, "prompt_ids": prompt.tolist(),
                           "max_tokens": RAG["tokens"],
                           "query_vec": q.tolist()}).encode()
        req = urllib.request.Request(base + "/rag", body,
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            got = json.loads(resp.read())
        fut = srv._rags[mid].submit(prompt, RAG["tokens"], query_vec=q)
        want = dict(tokens=fut.result(timeout=300).tolist(),
                    docs=list(fut._rag_docs),
                    prefix_len=fut._rag_prefix_len)
    finally:
        srv.stop()
    check(got == want and 123 in got["docs"],
          f"10e: /rag answered {got}, submit {want}")
    log(f"  10e /rag through attach_rag answers as submit: docs "
        f"{got['docs']}, prefix {got['prefix_len']}; [{card}]")
    return got


def tsne_data():
    rs = np.random.RandomState(7)
    mu = rs.randn(4, TSNE["d"]).astype(np.float32) * 4.0
    lab = rs.randint(0, 4, TSNE["n"])
    return (mu[lab] + rs.randn(TSNE["n"], TSNE["d"]).astype(np.float32)
            ).astype(np.float32)


def phase_tsne(card):
    """10f: ``BarnesHutTsne`` and ``Tsne`` on 2,000 x 50 clustered points,
    card against CPU: the sparse P, then ten iterations from the same P."""
    from deeplearning4j_torch.plot import BarnesHutTsne, Tsne
    from deeplearning4j_torch.plot import barnes_hut

    x = tsne_data()
    n = len(x)
    t0 = time.perf_counter()
    p_card = barnes_hut.build_sparse_p(x, TSNE["perplexity"], device="cuda")
    p_card_s = time.perf_counter() - t0
    p_cpu = barnes_hut.build_sparse_p(x, TSNE["perplexity"], device="cpu")
    dense = []
    for ei, ej, ep in (p_card, p_cpu):
        m = np.zeros((n, n))
        np.add.at(m, (ei, ej), ep)
        dense.append(m)
    p_err = float(np.abs(dense[0] - dense[1]).max())
    p_max = float(dense[1].max())
    edges = float(np.mean((p_card[0] == p_cpu[0]) & (p_card[1] == p_cpu[1])))
    check(p_err <= P_REL * p_max, f"10f: sparse P card vs CPU {p_err:.3g} "
                                  f"> {P_REL} x {p_max:.3g}")
    out = dict(p_max_abs_err=p_err, p_max=p_max, edges_equal=edges,
               p_card_s=p_card_s)
    kw = dict(perplexity=TSNE["perplexity"], max_iter=TSNE["iters"],
              seed=0)
    real = barnes_hut.build_sparse_p
    barnes_hut.build_sparse_p = lambda *a, **k: p_cpu
    try:
        for tag, cls in (("bh", BarnesHutTsne), ("exact", Tsne)):
            times, ys = {}, {}
            for dev in ("cuda", "cpu"):
                model = cls(device=dev, **kw)
                t0 = time.perf_counter()
                ys[dev] = model.fit(x)
                times[dev] = time.perf_counter() - t0
            err = float(np.abs(ys["cuda"] - ys["cpu"]).max())
            scale = float(np.abs(ys["cpu"]).max())
            check(np.isfinite(ys["cuda"]).all() and err <= TSNE_REL * scale,
                  f"10f {tag}: y card vs CPU {err:.3g} > {TSNE_REL} x "
                  f"{scale:.3g}")
            out[tag] = dict(max_abs_err=err, max_abs_y=scale,
                            card_s=times["cuda"], cpu_s=times["cpu"])
    finally:
        barnes_hut.build_sparse_p = real
    log(f"  10f t-SNE {n} x {TSNE['d']}: P card vs CPU {p_err:.3g} of "
        f"{p_max:.3g} ({edges:.4f} of edges equal); {TSNE['iters']} "
        f"iterations BH {out['bh']['max_abs_err']:.3g} of "
        f"{out['bh']['max_abs_y']:.3g} ({out['bh']['card_s']:.2f} s card, "
        f"{out['bh']['cpu_s']:.2f} s CPU), exact "
        f"{out['exact']['max_abs_err']:.3g} of {out['exact']['max_abs_y']:.3g}"
        f" ({out['exact']['card_s']:.2f} s card, {out['exact']['cpu_s']:.2f}"
        f" s CPU); [{card}]")
    return out


def phase_retrieval(card):
    """Phase 10: retrieval and RAG (10a-10f)."""
    t0 = time.perf_counter()
    pts, qs = knn_store()
    log("phase 10a: the exact f32 store")
    exact = phase_exact_store(pts, qs, card)
    log("phase 10b: the int8 flat store")
    int8 = phase_int8_store(pts, qs, card)
    log("phase 10c: IVF int8")
    ivf = phase_ivf_store(pts, qs, card)
    log("phase 10d: NearestNeighborsServer over HTTP")
    http = phase_knn_http(pts, qs, card)
    del pts
    log("phase 10e: RAG at the bench's serve_rag configuration")
    rag = phase_rag(card)
    log("phase 10f: t-SNE")
    tsne = phase_tsne(card)
    wall = time.perf_counter() - t0
    log(f"  phase 10: {wall:.1f} s; [{card}]")
    return dict(exact=exact, int8=int8, ivf=ivf, http=http, rag=rag,
                tsne=tsne, wall_s=wall)


# ---------------------------------------------------------------- phase 11
#: phase 11a: ``zoo.TextGenerationLSTM`` at the zoo's width (GravesLSTM 256
#: x2, RmsProp 0.01, L2 1e-3, TBPTT 50/50) on the JAX bench leg
#: (``bench.py::bench_lstm``: vocab 77, batch 64, seq 50, the bench's
#: RandomState(2) data) and on DL4J's GravesLSTMCharModellingExample shape
#: (miniBatch 32, exampleLength 1000, TBPTT 50: twenty segments; its text
#: drawn from a seeded Markov chain over the 77 characters)
LSTM_VOCAB = 77
LSTM_BENCH = dict(batch=64, seq=50)
LSTM_CHAR = dict(batch=32, seq=1000)
#: the char stream's segment that carries a NaN in the guard's run
LSTM_NAN_SEGMENT = 7
#: steady tokens/s: the median of LSTM_WINDOWS marginal windows, each the
#: time of 2n steps less that of n (bench.py's MarginalTimer), n steps
#: (bench.py takes five windows; two keep the script within its limit
#: once phase 18 runs, three before)
LSTM_WINDOWS = 2
LSTM_WINDOW_STEPS = 10
#: phase 11b: streaming and generation at batch 8 from the char-trained net
LSTM_STREAM = dict(batch=8, prompt=50, tokens=200, chunk=7)
LSTM_SAMPLED = dict(temperature=0.8, top_k=40, seed=7)
#: phase 11c: the UCI synthetic-control shape of DL4J's
#: UCISequenceClassificationExample (6 classes of 60-step series, 450 to
#: train and 150 to test), each series cut at random to 30..60 steps under
#: a mask; a bidirectional LSTM of 10 units each way, batches of 30
UCI = dict(classes=6, steps=60, train=450, test=150, batch=30, hidden=10,
           min_len=30)
#: 11c's early stopping ends after this many epochs at most (5 before
#: phase 18 needed the time, 3 before phase 21 did)
UCI_MAX_EPOCHS = 2
#: 11c fails when the card's and the CPU's best models' class
#: probabilities differ by more than this anywhere
UCI_SPREAD_CAP = 1e-3


def lstm_params(net, seed, gain=1.0):
    """Seeded numpy weights for a recurrent net: every ``W``/``RW``
    ``randn·gain/sqrt(fan_in)``, biases and peepholes ``0.1·randn``, an
    LSTM bias's forget block ``[H:2H]`` one higher."""
    from deeplearning4j_torch.nn.conf.layers.recurrent import LSTM

    rs = np.random.RandomState(seed)
    owners = net._param_owners()
    out = {}
    for v, p in net.params.items():
        out[v] = {}
        for k, t in p.items():
            shp = tuple(t.shape)
            leaf = k.split("_")[-1]
            if leaf in ("W", "RW"):
                a = rs.randn(*shp) * gain / np.sqrt(shp[0])
            else:
                a = 0.1 * rs.randn(*shp)
                if leaf == "b" and isinstance(owners[v], LSTM):
                    H = shp[0] // 4
                    a[H:2 * H] += 1.0
            out[v][k] = a.astype(np.float32)
    return out


def textgen(params, device, dtype="float32"):
    """``TextGenerationLSTM(77, 50)`` on ``device``, on ``params`` (cast to
    ``dtype``)."""
    from deeplearning4j_torch.models.zoo import TextGenerationLSTM
    from deeplearning4j_torch.utils.convert import params_from_jax

    net = TextGenerationLSTM(num_labels=LSTM_VOCAB,
                             max_length=LSTM_BENCH["seq"],
                             dtype=dtype).init(device=device)
    if params is not None:
        params_from_jax(params, net)
    return net


def char_stream(rows, T, seed=11):
    """``rows`` one-hot character rows of ``T`` steps and their next
    characters, from a Markov chain whose transition rows are
    Dirichlet(0.05) draws (a learnable, text-like stream)."""
    V = LSTM_VOCAB
    rs = np.random.RandomState(seed)
    cdf = np.cumsum(rs.dirichlet(np.full(V, 0.05), V), axis=1)
    idx = np.empty((rows, T + 1), np.int64)
    idx[:, 0] = rs.randint(0, V, rows)
    u = rs.rand(rows, T)
    for t in range(T):
        idx[:, t + 1] = np.minimum((u[:, t, None] > cdf[idx[:, t]]).sum(1),
                                   V - 1)
    eye = np.eye(V, dtype=np.float32)
    return eye[idx[:, :-1]], eye[idx[:, 1:]], idx


def fit_losses(net, ds, **kw):
    """``net.fit(ds, **kw)`` and each of its steps' losses as host floats
    (``CollectScoresIterationListener`` keeps the device scalars; they are
    read after the fit)."""
    from deeplearning4j_torch.optimize.listeners import (
        CollectScoresIterationListener)

    rec = CollectScoresIterationListener()
    net.set_listeners(rec)
    net.fit(ds, **kw)
    net.set_listeners()
    return [float(v) for _, v in rec.scores]


def tbptt_segments(x, y, L):
    for s in range(0, x.shape[1], L):
        yield x[:, s:s + L], y[:, s:s + L]


def to_host(tree):
    """A nested dict of tensors, copied to the CPU."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().clone()


def segment_parity(params, x, y, L):
    """Each TBPTT segment's step card against CPU from the same state: the
    card runs the segment loop with the carry; before each step the CPU
    net takes the card's parameters, RmsProp state, iteration and carry.
    Per segment: the loss's relative error, the parameters after the step
    as a share of 1e-4 of each leaf's max|p|, and the carry's largest
    error."""
    card, cpu = textgen(params, "cuda"), textgen(params, "cpu")
    carry = {}
    out = dict(loss_rel=[], param_rule=[], carry_err=[])
    for fx, fy in tbptt_segments(x, y, L):
        cpu.params = to_host(card.params)
        cpu.updater_state = to_host(card.updater_state)
        cpu.iteration = card.iteration
        ld, carry_d = card.do_step(fx, fy, carry=carry)
        lc, carry_c = cpu.do_step(fx, fy, carry=to_host(carry))
        carry = carry_d
        out["loss_rel"].append(abs(float(ld) - float(lc)) / abs(float(lc)))
        out["param_rule"].append(max(
            (card.params[v][k].cpu() - t).abs().max().item()
            / (1e-4 * t.abs().max().item())
            for v, p in cpu.params.items() for k, t in p.items()))
        out["carry_err"].append(max(
            (carry_d[v][k].cpu() - t).abs().max().item()
            for v, c in carry_c.items() for k, t in c.items()))
    return out


def marginal_tokens_s(step, tokens_per_step, n_windows=None, n=None):
    """Steady tokens/s of ``step()``: ``n_windows`` windows (LSTM_WINDOWS),
    each the time of 2n steps less that of n (n = LSTM_WINDOW_STEPS, each
    run ending in a sync); the median and every window."""
    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    n = n or LSTM_WINDOW_STEPS
    windows = []
    for _ in range(n_windows or LSTM_WINDOWS):
        t1 = run(n)
        t2 = run(2 * n)
        windows.append(tokens_per_step * n / (t2 - t1))
    return float(np.median(windows)), windows


def phase_lstm_train(card):
    """Phase 11a: TextGenerationLSTM trained by TBPTT at the zoo's width.
    The bench leg (64 x 50, one segment a batch): the first step's
    gradients card against CPU within 1e-4 of max|g|, steady tokens/s, and
    launches a step and the idle share under the profiler. The
    char-modelling shape (32 x 1,000, twenty segments): each segment's step
    card against CPU from the same state (``segment_parity``: twenty losses
    within rtol 1e-4, the parameters after each within 1e-4 of the leaf's
    max|p|), the free-running ``fit`` of both reported beside, with the
    CPU's f32 run against its f64 run (RmsProp amplifies f32 rounding, so
    two right f32 runs drift apart over these segments), ``fit`` at its
    defaults
    bit for bit a hand-written ``do_step`` loop over the segments with the
    carry, and a NaN segment skipped by the guard. Returns the report and
    the char-trained card net."""
    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.optimize.health import HealthPolicy

    V, L = LSTM_VOCAB, LSTM_BENCH["seq"]
    params = lstm_params(textgen(None, "cpu"), seed=3, gain=0.5)
    cpu, net = textgen(params, "cpu"), textgen(params, "cuda")
    rs = np.random.RandomState(2)
    eye = np.eye(V, dtype=np.float32)
    x = eye[rs.randint(0, V, (LSTM_BENCH["batch"], L))]
    y = eye[rs.randint(0, V, (LSTM_BENCH["batch"], L))]
    ld, gd = step_grads(net, x, y)
    lc, gc = step_grads(cpu, x, y)
    top = max(g.abs().max().item() for p in gc.values() for g in p.values())
    grad_rule, grad_leaf = worst_leaf(gd, gc, lambda v, k: 1e-4 * top)
    leaf_rule, leaf_at = worst_leaf(gd, gc, rule_1e4(cpu, gc))
    loss_rel = abs(ld - lc) / abs(lc)
    check(grad_rule <= 1.0 and loss_rel <= 1e-4,
          f"lstm bench: first-step gradients card vs CPU at "
          f"{grad_rule:.3g} of 1e-4 max|g| ({grad_leaf}), loss rel "
          f"{loss_rel:.3g}")
    xd, yd = (torch.from_numpy(a).to(net.device) for a in (x, y))
    tok_s, windows = marginal_tokens_s(lambda: net.do_step(xd, yd),
                                       x.shape[0] * L)
    check(np.isfinite(float(net.score())), "lstm bench: non-finite loss")
    prof = busy_share(lambda: [net.do_step(xd, yd) for _ in range(3)], 3)
    log(f"  bench leg [64, 50, 77]: first step vs CPU {grad_rule:.3f} of "
        f"1e-4 max|g| ({grad_leaf}; per leaf {leaf_rule:.3f} of 1e-4 of "
        f"the leaf's max at {leaf_at}), loss rel {loss_rel:.2e}; "
        f"{tok_s:.0f} tokens/s (median of {LSTM_WINDOWS} windows "
        f"{[round(w) for w in windows]}), "
        f"{prof['kernel_launches_per_step']:.0f} launches a step, idle "
        f"share {prof['idle_share']:.3f} under the profiler; [{card}]")
    bench = dict(first_step_rule=grad_rule, first_step_worst_leaf=grad_leaf,
                 first_step_leaf_rule=leaf_rule, first_step_loss_rel=loss_rel,
                 tokens_per_s=tok_s, windows=windows, profile=prof)

    cx, cy, _ = char_stream(LSTM_CHAR["batch"], LSTM_CHAR["seq"])
    n_seg = LSTM_CHAR["seq"] // L
    seg = segment_parity(params, cx, cy, L)
    check(len(seg["loss_rel"]) == n_seg and max(seg["loss_rel"]) <= 1e-4
          and max(seg["param_rule"]) <= 1.0,
          f"lstm char: segment steps card vs CPU from the same state: "
          f"loss rel {max(seg['loss_rel']):.3g}, params "
          f"{max(seg['param_rule']):.3g} of 1e-4 of the leaf's max|p|")
    runs = {}
    for dev in ("cpu", "cuda"):
        n = textgen(params, dev)
        t0 = time.perf_counter()
        losses = fit_losses(n, DataSet(cx, cy))
        runs[dev] = (n, losses, time.perf_counter() - t0)
    char_net, card_losses, card_s = runs["cuda"]
    cpu_losses = runs["cpu"][1]
    # free-running drift, reported: RmsProp's lr/sqrt(h) amplifies f32
    # rounding, so two right f32 runs part within twenty segments; the
    # CPU's f32 run against its f64 run gives the size of that drift
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    f64_losses = fit_losses(textgen(params, "cpu", "float64"),
                            DataSet(cx, cy))
    f32_drift = max(abs(a - b) / abs(b)
                    for a, b in zip(cpu_losses, f64_losses))
    check(card_losses[-1] < card_losses[0],
          f"lstm char: loss {card_losses[0]:.4f} -> {card_losses[-1]:.4f}")
    loop = textgen(params, "cuda")
    carry = {}
    for fx, fy in tbptt_segments(cx, cy, L):
        _, carry = loop.do_step(fx, fy, carry=carry)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(loop.params[v][k], char_net.params[v][k])
                  for v in loop.params for k in loop.params[v])
    check(bitwise and loop.iteration == char_net.iteration == n_seg,
          "lstm char: fit at the defaults differs from the do_step loop")
    xn = cx.copy()
    xn[3, LSTM_NAN_SEGMENT * L + 10, 5] = np.nan
    guarded, policy = textgen(params, "cuda"), HealthPolicy()
    nan_losses = fit_losses(guarded, DataSet(xn, cy), health_guard=policy)
    bad = [i for i, v in enumerate(nan_losses) if not np.isfinite(v)]
    check(bad == [LSTM_NAN_SEGMENT] and policy.total_skips == 1
          and np.isfinite(guarded.params_flat()).all()
          and nan_losses[:LSTM_NAN_SEGMENT]
          == card_losses[:LSTM_NAN_SEGMENT],
          f"lstm char NaN: non-finite segments {bad}, skips "
          f"{policy.total_skips}")
    char_tok_s = cx.shape[0] * cx.shape[1] / card_s
    log(f"  char shape [32, 1000, 77], {n_seg} TBPTT segments: each "
        f"segment's step card vs CPU from the same state: loss rel "
        f"{max(seg['loss_rel']):.2e}, params {max(seg['param_rule']):.3f} of "
        f"1e-4 of the leaf's max|p|, carry {max(seg['carry_err']):.2e}; fit "
        f"losses {card_losses[0]:.4f} -> {card_losses[-1]:.4f}, free-running "
        f"card vs CPU rel {rel:.2e} (reported; the CPU's f32 run vs its f64 "
        f"run {f32_drift:.2e}); fit bitwise the do_step loop "
        f"{bitwise}; NaN segment "
        f"{LSTM_NAN_SEGMENT} skipped ({policy.total_skips} skip); fit "
        f"{card_s:.3f} s = {char_tok_s:.0f} tokens/s on the card (the "
        f"guard fetches each segment's loss), {runs['cpu'][2]:.3f} s on "
        f"the CPU; [{card}]")
    char = dict(losses=card_losses, cpu_losses=cpu_losses,
                free_running_rel=rel, cpu_f32_vs_f64_rel=f32_drift,
                segments=seg,
                bitwise=bitwise, skips=policy.total_skips, fit_s=card_s,
                tokens_per_s=char_tok_s, cpu_fit_s=runs["cpu"][2])
    return dict(bench=bench, char=char), char_net


def lstm_logprobs(net, ids):
    """``[n, T, V]`` f64 log-probabilities of one full-sequence
    ``output()`` over the token rows ``ids`` ``[n, T]``: position t scores
    the token after ``ids[:, t]``."""
    eye = np.eye(LSTM_VOCAB, dtype=np.float32)
    out = net.output(eye[ids]).float().cpu().numpy().astype(np.float64)
    return np.log(np.maximum(out, 1e-30))


def top2_spread(lp_a, lp_b):
    """The largest change of the gap between ``lp_b``'s two best entries
    from ``lp_b`` to ``lp_a`` over every position."""
    idx = np.argsort(lp_b, axis=-1)[..., -2:]
    ga = np.take_along_axis(lp_a, idx, -1)
    gb = np.take_along_axis(lp_b, idx, -1)
    return float(np.abs((ga[..., 1] - ga[..., 0])
                        - (gb[..., 1] - gb[..., 0])).max())


def sampled_gap(lp, k, row, batch):
    """The gap between the two best perturbed scores of the device loop's
    draw of token ``k`` for ``row``: ``log p / T`` within the top-k cut
    plus the Gumbel noise of ``fold_in(PRNGKey(seed), k)`` over the
    ``[batch, V]`` batch."""
    from deeplearning4j_torch.ops import random

    opts = LSTM_SAMPLED
    z = torch.from_numpy(lp).float() / opts["temperature"]
    kth = torch.topk(z, opts["top_k"]).values[-1]
    key = random.fold_in(random.PRNGKey(opts["seed"], device="cpu"), k)
    g = random.gumbel(key, (batch, LSTM_VOCAB))[row]
    score = torch.where(z >= kth, z + g, torch.full_like(z, -1e30))
    top = torch.topk(score, 2).values
    return (top[0] - top[1]).item()


def stream_rule(tag, got, want, lp_cpu, spread, prompt_len, gap_of):
    """Card streams ``got`` against CPU streams ``want``: each row equal,
    or leaving the CPU's at a token whose decision gap (``gap_of(lp, k,
    row)`` on the CPU's read) is within ``spread``. Returns the
    divergences."""
    divergences = []
    for b, (g, w) in enumerate(zip(got, want)):
        k = first_divergence(list(g), list(w))
        if k is None:
            continue
        gap = gap_of(lp_cpu[b, prompt_len - 1 + k], k, b)
        divergences.append(dict(row=b, position=k, gap=gap,
                                tokens=[int(g[k]), int(w[k])]))
        check(gap <= spread, f"lstm stream {tag}: row {b} leaves the CPU's "
                             f"at token {k} at a gap of {gap:.4g} over the "
                             f"spread {spread:.4g}")
    return divergences


def phase_lstm_stream(net, card):
    """Phase 11b: streaming and generation on the char-trained card net and
    a CPU twin on its weights. ``rnn_time_step`` in chunks of 7 equal to
    ``output()`` within 1e-5 of max|y|; ``greedy_generate`` of 200 tokens
    after a 50-token prompt at batch 8 on both loops, token for token, and
    card against CPU under phase 5c's near-tie rule (a row may leave the
    CPU's stream only at a token whose own top-2 log-probability gap is
    within the largest change of that gap between the card's and the
    CPU's reads of the CPU's streams); a sampled stream (temperature 0.8,
    top_k 40) card against CPU under the same rule on the perturbed
    scores; ms a generated token."""
    from deeplearning4j_torch.models.zoo import (greedy_generate,
                                                 sample_generate)
    from deeplearning4j_torch.utils.convert import params_to_numpy

    V, P = LSTM_VOCAB, LSTM_STREAM["prompt"]
    cpu = textgen(params_to_numpy(net), "cpu")
    _, _, ids = char_stream(LSTM_STREAM["batch"], 56, seed=12)
    eye = np.eye(V, dtype=np.float32)
    x = eye[ids[:, :56]]
    full = net.output(x)
    net.rnn_clear_previous_state()
    c = LSTM_STREAM["chunk"]
    parts = [net.rnn_time_step(x[:, s:s + c]) for s in range(0, 56, c)]
    net.rnn_clear_previous_state()
    chunk_err = ((torch.cat(parts, 1) - full).abs().max()
                 / full.abs().max()).item()
    check(chunk_err <= 1e-5, f"lstm stream: chunks of {c} vs output() "
                             f"{chunk_err:.3g} of max|y|")
    prompt = ids[:, :P]
    n = LSTM_STREAM["tokens"]
    greedy_generate(net, prompt, 4, V)                  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_loop = greedy_generate(net, prompt, n, V)
    ms_token = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    host_loop = greedy_generate(net, prompt, n, V, device_loop=False)
    host_ms_token = (time.perf_counter() - t0) / n * 1e3
    check(np.array_equal(dev_loop, host_loop),
          "lstm stream: the device and host loops' greedy tokens differ")
    ref = greedy_generate(cpu, prompt, n, V)
    seqs = np.concatenate([prompt, ref], 1)[:, :-1]
    lp_cpu = lstm_logprobs(cpu, seqs)
    spread = top2_spread(lstm_logprobs(net, seqs), lp_cpu)
    check(spread <= NEAR_TIE_CAP, f"lstm stream: card and CPU reads move "
                                  f"the top-2 gap by {spread:.4g}")

    def greedy_gap(lp, k, b):
        top = np.sort(lp)[-2:]
        return float(top[1] - top[0])

    greedy_div = stream_rule("greedy", dev_loop, ref, lp_cpu, spread, P,
                             greedy_gap)
    s_card = sample_generate(net, prompt, n, V, **LSTM_SAMPLED)
    s_cpu = sample_generate(cpu, prompt, n, V, **LSTM_SAMPLED)
    s_seqs = np.concatenate([prompt, s_cpu], 1)[:, :-1]
    s_lp = lstm_logprobs(cpu, s_seqs)
    s_spread = top2_spread(lstm_logprobs(net, s_seqs), s_lp) \
        / LSTM_SAMPLED["temperature"]
    sampled_div = stream_rule(
        "sampled", s_card, s_cpu, s_lp, s_spread, P,
        lambda lp, k, b: sampled_gap(lp, k, b, LSTM_STREAM["batch"]))
    check(not np.array_equal(s_card, dev_loop),
          "lstm stream: the sampled stream is the greedy one")
    log(f"  streaming: chunks of {c} vs output() {chunk_err:.2e} of max|y|; "
        f"greedy {n} tokens after {P} at batch {LSTM_STREAM['batch']}: "
        f"device loop = host loop, card vs CPU {len(greedy_div)} rows "
        f"diverge (gap spread {spread:.2e}): "
        f"{[(d['row'], d['position'], round(d['gap'], 6)) for d in greedy_div]}; "
        f"sampled: {len(sampled_div)} rows diverge (spread {s_spread:.2e}): "
        f"{[(d['row'], d['position'], round(d['gap'], 6)) for d in sampled_div]}; "
        f"{ms_token:.3f} ms a generated token (device loop, batch "
        f"{LSTM_STREAM['batch']}), {host_ms_token:.3f} ms on the host loop; "
        f"[{card}]")
    return dict(chunk_err=chunk_err, ms_per_token=ms_token,
                host_ms_per_token=host_ms_token, gap_spread=spread,
                greedy_divergences=greedy_div, sampled_spread=s_spread,
                sampled_divergences=sampled_div)


def uci_data(seed=0):
    """The synthetic-control series (Alcock and Manolopoulos' six
    generators: normal, cyclic, increasing and decreasing trend, upward
    and downward shift; m = 30, s = 2), 100 of each class shuffled,
    standardized with the training rows' statistics, each cut to a random
    length in ``[min_len, steps]`` under a mask (zeros past it). Returns
    (train, test) lists of ``(x [B, T, 1], y [B, 6], mask [B, T])``."""
    rs = np.random.RandomState(seed)
    T, C = UCI["steps"], UCI["classes"]
    n = UCI["train"] + UCI["test"]
    t = np.arange(1, T + 1, dtype=np.float64)
    cls = rs.permutation(np.repeat(np.arange(C), n // C))
    x = 30.0 + 2.0 * rs.uniform(-3, 3, (n, T))
    for i, c in enumerate(cls):
        if c == 1:
            x[i] += rs.uniform(10, 15) * np.sin(2 * np.pi * t
                                                / rs.uniform(10, 15))
        elif c in (2, 3):
            x[i] += (1 if c == 2 else -1) * rs.uniform(0.2, 0.5) * t
        elif c in (4, 5):
            x[i] += ((1 if c == 4 else -1) * rs.uniform(7.5, 20)
                     * (t >= rs.uniform(T / 3, 2 * T / 3)))
    tr = UCI["train"]
    x = (x - x[:tr].mean()) / x[:tr].std()
    lengths = rs.randint(UCI["min_len"], T + 1, n)
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    x = (x * mask)[..., None].astype(np.float32)
    y = np.eye(C, dtype=np.float32)[cls]
    B = UCI["batch"]

    def batches(lo, hi):
        return [(x[s:s + B], y[s:s + B], mask[s:s + B])
                for s in range(lo, hi, B)]

    return batches(0, tr), batches(tr, n)


def uci_conf(form):
    """The masked sequence classifier: ``"mln"`` GravesBidirectionalLSTM ->
    LastTimeStep -> OutputLayer; ``"graph"`` LSTM -> LastTimeStepVertex ->
    DuplicateToTimeSeriesVertex -> RnnOutputLayer (a class at every
    step, the steps past each row's length masked out of the loss)."""
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.graph_conf import (
        DuplicateToTimeSeriesVertex, LastTimeStepVertex)
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers.core import OutputLayer
    from deeplearning4j_torch.nn.conf.layers.recurrent import (
        LSTM, GravesBidirectionalLSTM, LastTimeStep, RnnOutputLayer)
    from deeplearning4j_torch.nn.updater import Adam

    g = (NeuralNetConfiguration.builder().seed(5).weight_init("xavier")
         .updater(Adam(learning_rate=5e-3))
         .gradient_normalization("clip_element_wise_absolute_value")
         .gradient_normalization_threshold(0.5))
    H, C = UCI["hidden"], UCI["classes"]
    if form == "mln":
        return (g.list(GravesBidirectionalLSTM(n_out=H, activation="tanh"),
                       LastTimeStep(),
                       OutputLayer(n_out=C, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.recurrent(1)).build())
    return (g.graph_builder().add_inputs("in")
            .add_layer("lstm", LSTM(n_out=H, activation="tanh"), "in")
            .add_vertex("last", LastTimeStepVertex(mask_input="in"), "lstm")
            .add_vertex("dup", DuplicateToTimeSeriesVertex(input_name="in"),
                        "last")
            .add_layer("out", RnnOutputLayer(n_out=C, activation="softmax",
                                             loss="mcxent"), "dup")
            .set_outputs("out").set_input_types(InputType.recurrent(1))
            .build())


def uci_sets(form, batches):
    """DataSets of ``batches``: features masked; the graph's labels
    repeated at every step under the same mask."""
    from deeplearning4j_torch.datasets.dataset import DataSet

    T = UCI["steps"]
    if form == "mln":
        return [DataSet(x, y, m, None) for x, y, m in batches]
    return [DataSet(x, np.repeat(y[:, None], T, 1), m, m)
            for x, y, m in batches]


def uci_probs(net, form, batches):
    """The best model's class probabilities over ``batches`` on the host,
    and the labels and labels mask the evaluations read."""
    ps = []
    for x, _, m in batches:
        out = (net.output(x, mask=m) if form == "mln"
               else net.output(x, masks=[m]))
        ps.append(out.float().cpu().numpy().astype(np.float64))
    p = np.concatenate(ps)
    y = np.concatenate([b[1] for b in batches]).astype(np.float64)
    m = np.concatenate([b[2] for b in batches])
    if form == "mln":
        return p, y, None
    return p, np.repeat(y[:, None], UCI["steps"], 1), m


def uci_evaluations(p, y, m):
    from deeplearning4j_torch.evaluation import (Evaluation,
                                                 EvaluationBinary,
                                                 RegressionEvaluation,
                                                 ROCMultiClass)

    return dict(ev=Evaluation().eval(y, p, mask=m),
                binary=EvaluationBinary().eval(y, p, mask=m),
                roc=ROCMultiClass().eval(y, p, mask=m),
                reg=RegressionEvaluation().eval(y, p, mask=m))


def uci_compare(tag, card_p, cpu_p, y, m):
    """The four evaluations of the card's probabilities against the CPU's,
    equal but where a decision sits within the spread of the two reads:
    a class choice whose CPU top-2 gap is within 2·spread, a 0.5
    threshold within spread, a pair of ROC scores within 2·spread (each
    such pair may move one class's AUC by 1/(P·N)); MSE within
    2·spread + spread² and MAE within spread per column."""
    keep = (np.ones(y.shape[:-1], bool) if m is None
            else m.astype(bool)).reshape(-1)
    C = y.shape[-1]
    pc = card_p.reshape(-1, C)[keep]
    pp = cpu_p.reshape(-1, C)[keep]
    yy = y.reshape(-1, C)[keep]
    spread = float(np.abs(pc - pp).max())
    check(spread <= UCI_SPREAD_CAP, f"uci {tag}: card and CPU best models' "
                                    f"probabilities differ by {spread:.3g}")
    a, b = uci_evaluations(card_p, y, m), uci_evaluations(cpu_p, y, m)
    srt = np.sort(pp, axis=1)
    flips = pc.argmax(1) != pp.argmax(1)
    check(np.all(srt[flips, -1] - srt[flips, -2] <= 2 * spread),
          f"uci {tag}: a class choice flips away from a near-tie")
    check(np.abs(a["ev"].confusion - b["ev"].confusion).sum()
          <= 2 * flips.sum(), f"uci {tag}: confusion differs")
    th = (pc >= 0.5) != (pp >= 0.5)
    check(np.all(np.abs(pp[th] - 0.5) <= spread),
          f"uci {tag}: a 0.5 decision flips away from a near-tie")
    for k in ("tp", "fp", "tn", "fn"):
        check(np.abs(getattr(a["binary"], k) - getattr(b["binary"], k)).sum()
              <= th.sum(), f"uci {tag}: binary {k} differs")
    auc_gap = []
    for c in range(C):
        pos, neg = pp[yy[:, c] > 0.5, c], pp[yy[:, c] <= 0.5, c]
        near = (np.abs(pos[:, None] - neg[None]) <= 2 * spread).sum()
        d = abs(a["roc"].calculate_auc(c) - b["roc"].calculate_auc(c))
        auc_gap.append(d)
        check(d <= near / max(len(pos) * len(neg), 1) + 1e-12,
              f"uci {tag}: class {c} AUC moved {d:.3g} with {near} "
              f"near-tie pairs")
    for c in range(C):
        check(abs(a["reg"].mean_squared_error(c)
                  - b["reg"].mean_squared_error(c))
              <= 2 * spread + spread ** 2
              and abs(a["reg"].mean_absolute_error(c)
                      - b["reg"].mean_absolute_error(c)) <= spread,
              f"uci {tag}: regression column {c} differs")
    return dict(spread=spread, class_flips=int(flips.sum()),
                threshold_flips=int(th.sum()), max_auc_gap=max(auc_gap),
                accuracy=a["ev"].accuracy(), cpu_accuracy=b["ev"].accuracy(),
                average_auc=a["roc"].calculate_average_auc(),
                mse=a["reg"].average_mean_squared_error())


def phase_uci(card):
    """Phase 11c: the masked sequence classifier in both forms, trained by
    ``EarlyStoppingTrainer`` (MaxEpochs 3, ScoreImprovement 2, the test
    loss by ``DataSetLossCalculator``, ``InMemoryModelSaver``) on the card
    and on the CPU from the same numpy-seeded weights: the termination
    reason and details and the best epoch equal, every epoch's score
    within rtol 1e-4; then ``Evaluation``, ``EvaluationBinary``,
    ``ROCMultiClass`` and ``RegressionEvaluation`` of the best models on
    the test set card against CPU (``uci_compare``), and the card's fused
    ``evaluate`` count for count the host ``Evaluation``."""
    from deeplearning4j_torch.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingTrainer, InMemoryModelSaver,
        MaxEpochsTerminationCondition,
        ScoreImprovementEpochTerminationCondition)
    from deeplearning4j_torch.nn.graph import ComputationGraph
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.utils.convert import params_from_jax

    train, test = uci_data()
    out = {}
    for form in ("mln", "graph"):
        cls = MultiLayerNetwork if form == "mln" else ComputationGraph
        params = lstm_params(cls(uci_conf(form)).init(device="cpu"), seed=8)
        res = {}
        for dev in ("cpu", "cuda"):
            net = cls(uci_conf(form)).init(device=dev)
            params_from_jax(params, net)
            cfg = EarlyStoppingConfiguration(
                epoch_termination_conditions=[
                    MaxEpochsTerminationCondition(UCI_MAX_EPOCHS),
                    ScoreImprovementEpochTerminationCondition(2)],
                score_calculator=DataSetLossCalculator(
                    uci_sets(form, test)),
                model_saver=InMemoryModelSaver())
            t0 = time.perf_counter()
            r = EarlyStoppingTrainer(cfg, net, uci_sets(form, train)).fit()
            res[dev] = (r, time.perf_counter() - t0)
        (rd, card_s), (rc, cpu_s) = res["cuda"], res["cpu"]
        check(rd.termination_reason == rc.termination_reason
              != "Error" and rd.termination_details == rc.termination_details
              and rd.best_model_epoch == rc.best_model_epoch
              and rd.total_epochs == rc.total_epochs,
              f"uci {form}: early stopping card {rd.termination_reason} "
              f"({rd.termination_details}, best {rd.best_model_epoch}) vs "
              f"CPU {rc.termination_reason} ({rc.termination_details}, "
              f"best {rc.best_model_epoch})")
        score_rel = max(abs(rd.score_vs_epoch[e] - s) / abs(s)
                        for e, s in rc.score_vs_epoch.items())
        check(score_rel <= 1e-4, f"uci {form}: epoch scores card vs CPU "
                                 f"rel {score_rel:.3g}")
        best = rd.best_model
        check(best.device.type == "cuda", f"uci {form}: best model on "
                                          f"{best.device}")
        card_p, y, m = uci_probs(best, form, test)
        cpu_p, _, _ = uci_probs(rc.best_model, form, test)
        cmp = uci_compare(form, card_p, cpu_p, y, m)
        fused = best.evaluate(uci_sets(form, test))
        host = uci_evaluations(card_p, y, m)["ev"]
        check(np.array_equal(fused.confusion, host.confusion),
              f"uci {form}: fused evaluate differs from the host count")
        out[form] = dict(termination=rd.termination_reason,
                         details=rd.termination_details,
                         best_epoch=rd.best_model_epoch,
                         epochs=rd.total_epochs,
                         scores=[rd.score_vs_epoch[e]
                                 for e in sorted(rd.score_vs_epoch)],
                         score_rel=score_rel, card_s=card_s, cpu_s=cpu_s,
                         **cmp)
        log(f"  uci {form}: {rd.termination_reason} ({rd.termination_details}"
            f") after {rd.total_epochs} epochs, best epoch "
            f"{rd.best_model_epoch}, scores card vs CPU rel {score_rel:.2e}; "
            f"accuracy {cmp['accuracy']:.4f} (CPU {cmp['cpu_accuracy']:.4f}), "
            f"average AUC {cmp['average_auc']:.4f}, probability spread "
            f"{cmp['spread']:.2e}, {cmp['class_flips']} class and "
            f"{cmp['threshold_flips']} threshold flips; early stopping "
            f"{card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU; [{card}]")
    return out


def phase_recurrent(card):
    """Phase 11: recurrent nets (11a-11c)."""
    t0 = time.perf_counter()
    log("phase 11a: TextGenerationLSTM trained by TBPTT")
    train, char_net = phase_lstm_train(card)
    log("phase 11b: streaming and generation")
    stream = phase_lstm_stream(char_net, card)
    log("phase 11c: masked sequence classifiers and early stopping")
    uci = phase_uci(card)
    wall = time.perf_counter() - t0
    log(f"  phase 11: {wall:.1f} s; [{card}]")
    return dict(train=train, stream=stream, uci=uci, wall_s=wall)


# ---------------------------------------------------------------- phase 12
#: 12a: the JAX bench leg (``bench.py::bench_resnet50``,
#: ``_imagenet_model_timer``): zoo ResNet50, 224×224×3, 1,000 labels,
#: batch 128, bf16 compute; gates at batch 2 against the CPU
RESNET = dict(batch=128, shape=(224, 224, 3), labels=1000)
#: bench.py's training FLOP per image of the zoo ResNet50 (its stride-2
#: stage 2a makes it about half the canonical ResNet-50's)
RESNET_TRAIN_FLOP_PER_IMG = 6.6e9
RESNET_FIT_BATCHES = 8            # two fused blocks at K = 4
RESNET_FALL_STEPS = 20
#: marginal windows of ``do_step`` (bench.py's ``MarginalTimer``): each the
#: time of 2n steps less that of n (bench.py takes five; two keep the
#: script within its limit once phase 18 runs), n = 2 steps (4 before)
GRAPH_WINDOWS = 2
GRAPH_WINDOW_STEPS = 2
#: 12b: the other graph models at their zoo input shapes; timed batch
GRAPH_ZOO = [("GoogLeNet", (224, 224, 3)), ("FaceNetNN4Small2", (96, 96, 3)),
             ("InceptionResNetV1", (160, 160, 3))]
GRAPH_ZOO_BATCH = 32
#: 12c: a fine-tune of 12a's net: frozen through the last stage-4 identity
#: block, a 10-way head; the head's first step is held to the CPU's on a
#: few rows
FINETUNE = dict(batch=64, steps=5, labels=10, freeze="res4f", cpu_rows=2)
#: 12d: a mixture-of-experts FFN at a transformer FFN's width
MOE = dict(batch=64, seq=128, width=512, experts=8, top_k=2, hidden=2048,
           labels=16, cpu_rows=4, timed_steps=5)
#: 12e: the line-search solvers on LeNet
SOLVER = dict(batch=64, iterations=5,
              algorithms=("lbfgs", "conjugate_gradient",
                          "line_gradient_descent"))


def graph_zero_grad_leaves(net):
    """A graph's biases whose every reader is a training-mode batch norm
    vertex: their exact gradient is 0 (``zero_grad_leaves``'s rule)."""
    from deeplearning4j_torch.nn.conf.graph_conf import LayerVertex
    from deeplearning4j_torch.nn.conf.layers.normalization import (
        BatchNormalization)

    conf = net.conf
    readers: dict = {}
    for name, ins in conf.vertex_inputs.items():
        for i in ins:
            readers.setdefault(i, []).append(conf.vertices[name])
    return {(name, "b") for name, rs in readers.items()
            if "b" in net.params.get(name, {}) and all(
                isinstance(v, LayerVertex)
                and isinstance(v.layer, BatchNormalization) for v in rs)}


def graph_grads(net, x, y, seed=0):
    """Loss and gradients (f64, on the host) of a graph's first training
    step on numpy ``x``, ``y``, its dropout keyed by ``PRNGKey(seed)``."""
    from deeplearning4j_torch.ops import random
    from deeplearning4j_torch.optimize.fused_fit import value_and_grad

    dev, dt = net.device, getattr(torch, net.conf.dtype)
    loss, g = value_and_grad(
        net, net.params, net.state, [torch.from_numpy(x).to(dev, dt)],
        [torch.from_numpy(y).to(dev, dt)], train=True,
        rng=random.PRNGKey(seed, device=dev))
    return float(loss), {k: {n: t.detach().cpu().double()
                             for n, t in p.items()} for k, p in g.items()}


def vertex_rule(net, cpu, x):
    """f32 activations of a graph's training forward, card against CPU.
    Each vertex runs on the card from the CPU's activations of its inputs
    (the largest max|a_card - a_cpu| / max|a_cpu| over the vertices is
    gated: it measures each vertex's own error), and end to end (reported:
    through an untrained deep net, batch statistics amplify rounding).
    Returns (per-vertex worst, its vertex, end-to-end worst)."""
    conf = net.conf
    acts = cpu.feed_forward(x, train=True)
    card = net.feed_forward(x, train=True)
    ctx = {"input_arrays": {k: torch.from_numpy(x).cuda()
                            for k in conf.network_inputs},
           "input_masks": {}}
    worst, where, e2e = 0.0, None, 0.0
    with torch.no_grad():
        for name in conf.topo_order:
            v = conf.vertices[name]
            ins = [acts[k].cuda() for k in conf.vertex_inputs[name]]
            out, _ = v.forward(net.params.get(name, {}),
                               net.state.get(name, {}), ins, masks=None,
                               ctx=ctx, train=True)
            ref = acts[name].double()
            scale = ref.abs().max().clamp_min(1e-30)
            r = ((out.cpu().double() - ref).abs().max() / scale).item()
            if r > worst:
                worst, where = r, name
            e2e = max(e2e, ((card[name].cpu().double() - ref).abs().max()
                            / scale).item())
    return worst, where, e2e


def graph_gates(name, cpu, x, y, card, seed=4, **kw):
    """Phase 8d's rules on a graph model at batch 2 against the CPU plain
    path: the first step's gradients in f64 on both devices under phase
    7's rule (``rule_1e4`` with ``graph_zero_grad_leaves``; loss rtol
    1e-4), and in f32 each vertex's activation within 1e-4 of its max|a|
    (``vertex_rule``) and the loss within rtol 1e-4, or within four times
    the CPU's own f32 loss from its f64 one where that is larger (an
    untrained InceptionResNetV1's batch statistics amplify f32 rounding
    to 1e-2 of its loss end to end, on one implementation as between
    two). Returns the card's f32 net and the numbers."""
    c64 = twin(name, "cpu", cpu.params, dtype="float64", **kw)
    lc, gc = graph_grads(c64, x.astype(np.float64), y.astype(np.float64),
                         seed)
    del c64
    d64 = twin(name, "cuda", cpu.params, dtype="float64", **kw)
    ld, gd = graph_grads(d64, x.astype(np.float64), y.astype(np.float64),
                         seed)
    del d64
    torch.cuda.empty_cache()
    f64_rule, f64_leaf = worst_leaf(gd, gc, rule_1e4(cpu, gc))
    f64_loss_rel = abs(ld - lc) / abs(lc)
    net = twin(name, "cuda", cpu.params, **kw)
    c32_loss, _ = graph_grads(cpu, x, y, seed)
    d32_loss, _ = graph_grads(net, x, y, seed)
    loss_rel = abs(d32_loss - c32_loss) / abs(c32_loss)
    # what f32 rounding alone moves the loss by on one implementation:
    # the CPU's f32 loss against its f64 one
    own_rel = abs(c32_loss - lc) / abs(lc)
    per_vertex, vertex, e2e = vertex_rule(net, cpu, x)
    check(f64_rule <= 1.0 and f64_loss_rel <= 1e-4,
          f"{name}: f64 first step card vs CPU: {f64_rule:.3g} of the "
          f"bound at {f64_leaf}, loss rel {f64_loss_rel:.3g}")
    check(per_vertex <= 1e-4 and loss_rel <= max(1e-4, 4 * own_rel),
          f"{name}: f32 card vs CPU: vertex {vertex} {per_vertex:.3g} of "
          f"max|a|, loss rel {loss_rel:.3g} (the CPU's f32 from its f64 "
          f"{own_rel:.3g})")
    log(f"  {name} {list(x.shape[1:])} batch 2 card vs CPU: f64 first step "
        f"{f64_rule:.3f} of phase 7's bound ({f64_leaf}), loss rel "
        f"{f64_loss_rel:.2e}; f32 per vertex {per_vertex:.2e} of max|a| "
        f"({vertex}), end to end {e2e:.2e}, loss rel {loss_rel:.2e} (the "
        f"CPU's f32 from its f64 {own_rel:.2e}); [{card}]")
    return net, dict(f64_rule=f64_rule, f64_worst_leaf=f64_leaf,
                     f64_loss_rel=f64_loss_rel, f32_vertex_rel=per_vertex,
                     f32_worst_vertex=vertex, f32_end_to_end_rel=e2e,
                     f32_loss_rel=loss_rel, cpu_f32_vs_f64_loss_rel=own_rel)


def device_batch(shape, labels, seed):
    """A synthetic batch drawn on the card from ``seed`` (inputs on the
    device, as ``bench.py``'s timer holds them)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda")
    idx = torch.randint(0, labels, (shape[0],), generator=g, device="cuda")
    return x, torch.eye(labels, device="cuda")[idx]


def timed_steps(net, x, y, units_per_step, profile=True):
    """Marginal-window rate of ``do_step`` on one device batch (the median
    and every window), ms a step, and the device busy share and launches a
    step of three steps under the profiler."""
    def step():
        net.do_step(x, y)

    step()
    torch.cuda.synchronize()
    rate, windows = marginal_tokens_s(step, units_per_step,
                                      GRAPH_WINDOWS, GRAPH_WINDOW_STEPS)
    out = dict(per_s=rate, windows=windows,
               step_ms=units_per_step / rate * 1e3)
    if profile:
        def three():
            for _ in range(3):
                step()

        out["profile"] = busy_share(three, 3)
    return out


def same_params(a, b):
    """Bitwise equality of two nets' parameters, and max|a - b|."""
    fa, fb = a.params_flat(), b.params_flat()
    return bool(np.array_equal(fa, fb)), float(np.abs(fa - fb).max())


def phase_resnet(card):
    """12a: the zoo ResNet50 at the JAX bench leg (224×224×3, 1,000
    labels, batch 128, ``compute_dtype="bfloat16"``, synthetic data from a
    seed; not cut). Gates at batch 2 against the CPU (``graph_gates``);
    ``fit`` at the defaults (K = 4, the guard on) against two
    ``fit(fused_steps=1)`` runs over one stream of 8 device batches (bit
    for bit where the two K = 1 runs agree bit for bit; overlapping max
    pooling backpropagates by atomics, so else within their own spread);
    the loss finite and falling over 20 steps on a fixed batch; images/s
    (median of marginal windows), ms a step, launches a step, the busy
    share and the share of the card's dense bf16 peak."""
    from deeplearning4j_torch.datasets.dataset import DataSet

    kw = dict(num_labels=RESNET["labels"])
    rs = np.random.RandomState(3)
    x2 = rs.randn(2, *RESNET["shape"]).astype(np.float32)
    y2 = np.eye(RESNET["labels"], dtype=np.float32)[
        rs.randint(0, RESNET["labels"], 2)]
    cpu = twin("ResNet50", "cpu", **kw)
    _, gates = graph_gates("ResNet50", cpu, x2, y2, card, **kw)
    B = RESNET["batch"]
    stream = [DataSet(*device_batch((B,) + RESNET["shape"], RESNET["labels"],
                                    100 + i))
              for i in range(RESNET_FIT_BATCHES)]
    nets = [twin("ResNet50", "cuda", cpu.params, compute_dtype="bfloat16",
                 **kw) for _ in range(3)]
    del cpu
    fused, one, again = nets
    t0 = time.perf_counter()
    fused.fit(stream)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    one.fit(stream, fused_steps=1)
    again.fit(stream, fused_steps=1)
    bitwise, diff = same_params(fused, one)
    k1_bitwise, k1_diff = same_params(one, again)
    check(bitwise or (not k1_bitwise and diff <= 4 * k1_diff),
          f"12a: fit at the defaults vs fused_steps=1: max|dp| {diff:.3g} "
          f"(two fused_steps=1 runs: {k1_diff:.3g})")
    check(all(np.isfinite(n.params_flat()).all() for n in nets),
          "12a: a parameter is not finite after fit")
    del again, one
    torch.cuda.empty_cache()
    net = fused
    x, y = stream[0].features, stream[0].labels
    losses = [float(net.do_step(x, y)[0])
              for _ in range(RESNET_FALL_STEPS)]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"12a: loss over {RESNET_FALL_STEPS} steps on a fixed batch: "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    t = timed_steps(net, x, y, B)
    peak = t["per_s"] * RESNET_TRAIN_FLOP_PER_IMG / PEAK_FLOPS_S["bf16"]
    log(f"  12a ResNet50 bench leg (batch {B}, bf16 compute): fit K=4 vs "
        f"K=1 bitwise {bitwise} (max|dp| {diff:.3g}; K=1 twice bitwise "
        f"{k1_bitwise}, {k1_diff:.3g}); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} over {RESNET_FALL_STEPS} steps; "
        f"{t['per_s']:.1f} images/s (windows "
        f"{[round(w, 1) for w in t['windows']]}), {t['step_ms']:.2f} ms a "
        f"step, {t['profile']['kernel_launches_per_step']:.0f} launches a "
        f"step, busy {t['profile']['busy_share']:.3f}, {peak:.4f} of the "
        f"dense bf16 peak; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; [{card}]")
    return net, dict(gates=gates, batch=B, fit_bitwise=bitwise,
                     fit_max_diff=diff, k1_runs_bitwise=k1_bitwise,
                     k1_runs_max_diff=k1_diff, fit_s=fit_s,
                     fall_losses=losses, images_per_s=t["per_s"],
                     windows=t["windows"], step_ms=t["step_ms"],
                     peak_share=peak, profile=t["profile"],
                     max_memory_gib=torch.cuda.max_memory_allocated()
                     / 2**30)


def phase_graph_zoo(card):
    """12b: GoogLeNet, FaceNetNN4Small2 and InceptionResNetV1 at their zoo
    input shapes under ``graph_gates`` at batch 2, then timed ``do_step``s
    at batch 32 (f32): images/s, ms a step, busy share, launches a
    step."""
    out = {}
    for name, shape in GRAPH_ZOO:
        kw = dict(num_labels=1000)
        rs = np.random.RandomState(5)
        x2 = rs.randn(2, *shape).astype(np.float32)
        y2 = np.eye(1000, dtype=np.float32)[rs.randint(0, 1000, 2)]
        cpu = twin(name, "cpu", **kw)
        net, gates = graph_gates(name, cpu, x2, y2, card, **kw)
        del cpu
        x, y = device_batch((GRAPH_ZOO_BATCH,) + shape, 1000, 7)
        t = timed_steps(net, x, y, GRAPH_ZOO_BATCH)
        check(np.isfinite(float(net.score())), f"12b {name}: loss not "
                                               "finite")
        log(f"  12b {name} batch {GRAPH_ZOO_BATCH}: {t['per_s']:.1f} "
            f"images/s, {t['step_ms']:.2f} ms a step, "
            f"{t['profile']['kernel_launches_per_step']:.0f} launches a "
            f"step, busy {t['profile']['busy_share']:.3f}; [{card}]")
        out[name] = dict(gates=gates, images_per_s=t["per_s"],
                         windows=t["windows"], step_ms=t["step_ms"],
                         profile=t["profile"])
        del net, x, y
        torch.cuda.empty_cache()
    return out


def frozen_snapshot(net):
    """Clones of every frozen vertex's parameters and state."""
    from deeplearning4j_torch.nn.conf.layers.misc import FrozenLayer

    names = [n for n, v in net.conf.vertices.items()
             if isinstance(getattr(v, "layer", None), FrozenLayer)]
    return {n: ({k: t.clone() for k, t in net.params.get(n, {}).items()},
                {k: t.clone() for k, t in net.state.get(n, {}).items()})
            for n in names}


def retyped(net, device, dtype):
    """A copy of a graph on ``device`` in ``dtype``: its configuration,
    parameters and state (batch-norm statistics) cast."""
    import copy

    from deeplearning4j_torch.nn.graph import ComputationGraph

    conf = copy.deepcopy(net.conf)
    conf.dtype, conf.compute_dtype = dtype, None
    dt = getattr(torch, dtype)
    out = ComputationGraph(conf).init(
        {k: {n: t.detach().to("cpu", dt) for n, t in p.items()}
         for k, p in net.params.items()}, device=device)
    out.state = {k: {n: t.to(out.device, dt) for n, t in p.items()}
                 for k, p in net.state.items()}
    return out


def phase_finetune(base, resnet, card):
    """12c: 12a's trained ResNet50 rebuilt by ``TransferLearning.
    GraphBuilder``: frozen through ``res4f`` (every ancestor), the output
    ``nout_replace``d to 10 classes (the rebuilt configuration computes in
    f32: it takes the seed, updater and dtype, not ``compute_dtype``, as
    JAX's does). ``fit`` on 5 batches of 64 (a fused block and a tail):
    every frozen leaf and batch-norm statistic bitwise unchanged and their
    RmsProp state zero; the first step's head gradients card against CPU
    on 2 rows in f64 (phase 7's rule; the f32 ratio reported, as 8d
    reports it); ms a step beside 12a's; and
    ``TransferLearningHelper`` (``featurize``, ``fit_featurized``) on a
    second rebuild giving the frozen graph's head parameters within 1e-4
    of each leaf's max|p|."""
    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.nn.transferlearning import (
        TransferLearning, TransferLearningHelper)

    F_ = FINETUNE

    def rebuild():
        return (TransferLearning.GraphBuilder(base)
                .set_feature_extractor(F_["freeze"])
                .nout_replace("output", F_["labels"]).build())

    ft = rebuild()
    frozen = frozen_snapshot(ft)
    check(len(frozen) > 100 and "res5a_2a" not in frozen,
          f"12c: {len(frozen)} frozen vertices")
    shape = (F_["batch"],) + RESNET["shape"]
    stream = [DataSet(*device_batch(shape, F_["labels"], 200 + i))
              for i in range(F_["steps"])]
    # the head's first step, card against CPU, from the same params: in
    # f64 (the head is ten ReLU convolutions deep: phase 8d's rule), the
    # f32 ratio reported
    rows = F_["cpu_rows"]
    xr = stream[0].features[:rows].cpu().numpy()
    yr = stream[0].labels[:rows].cpu().numpy()
    grads = {}
    for dev, dt in (("cpu", "float64"), ("cuda", "float64"),
                    ("cpu", "float32")):
        twin_net = retyped(ft, dev, dt)
        grads[(dev, dt)] = graph_grads(twin_net, xr.astype(dt),
                                       yr.astype(dt))
        del twin_net
    lc, gc = grads[("cpu", "float64")]
    ld, gd = grads[("cuda", "float64")]
    l32, g32 = grads[("cpu", "float32")]
    ld32, gd32 = graph_grads(ft, xr, yr)
    head = {v: g for v, g in gc.items() if v not in frozen}
    rule, leaf = worst_leaf({v: gd[v] for v in head}, head,
                            rule_1e4(ft, head))
    loss_rel = abs(ld - lc) / abs(lc)
    head32 = {v: g32[v] for v in head}
    rule32, leaf32 = worst_leaf({v: gd32[v] for v in head}, head32,
                                rule_1e4(ft, head32))
    frozen_zero = all(g.abs().max().item() == 0 for v in frozen
                      for g in gd[v].values())
    check(rule <= 1.0 and loss_rel <= 1e-4 and frozen_zero,
          f"12c: the head's f64 first step card vs CPU: {rule:.3g} of the "
          f"bound at {leaf}, loss rel {loss_rel:.3g}, frozen gradients "
          f"zero {frozen_zero}")
    t0 = time.perf_counter()
    ft.fit(stream)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    unchanged = all(
        torch.equal(ft.params[n][k], t) for n, (p, _) in frozen.items()
        for k, t in p.items()) and all(
        torch.equal(ft.state[n][k], t) for n, (_, s) in frozen.items()
        for k, t in s.items())
    untouched_state = all(not slot[n][k].any()
                          for slot in ft.updater_state.values()
                          for n in frozen for k in slot[n])
    last = ft.score()
    check(unchanged and untouched_state and np.isfinite(last),
          f"12c: frozen leaves bitwise unchanged {unchanged}, their "
          f"RmsProp state zero {untouched_state}, loss {last}")
    head_names = [n for n in ft.conf.topo_order if n not in frozen
                  and ft.params.get(n)]
    ref = {n: {k: t.double().cpu() for k, t in ft.params[n].items()}
           for n in head_names}
    t = timed_steps(ft, stream[0].features, stream[0].labels, F_["batch"],
                    profile=False)
    # the helper: featurize once, train the tail, on a second rebuild
    ft2 = rebuild()
    helper = TransferLearningHelper(ft2)
    feats = [helper.featurize(ds) for ds in stream]
    helper.fit_featurized(feats)
    got = {n: {k: t.double().cpu() for k, t in ft2.params[n].items()}
           for n in head_names}
    h_rule, h_leaf = worst_leaf(got, ref, lambda v, k: 1e-4 * max(
        ref[v][k].abs().max().item(), 1e-30))
    check(h_rule <= 1.0, f"12c: the helper's head vs the frozen graph's "
                         f"fit: {h_rule:.3g} of 1e-4 of max|p| at {h_leaf}")
    log(f"  12c fine-tune (frozen through {F_['freeze']}: {len(frozen)} "
        f"vertices; 10-way head, f32): head f64 first step card vs CPU "
        f"{rule:.3f} of phase 7's bound ({leaf}), loss rel {loss_rel:.2e} "
        f"(f32: {rule32:.3g}, {leaf32}; loss rel "
        f"{abs(ld32 - l32) / abs(l32):.2e}); "
        f"{F_['steps']} fit steps at batch {F_['batch']} in {fit_s:.2f} s, "
        f"frozen leaves and batch-norm statistics bitwise unchanged; "
        f"{t['step_ms']:.2f} ms a step ({t['per_s']:.1f} images/s; 12a's "
        f"bf16 step at 128 {resnet['step_ms']:.2f} ms); helper head "
        f"{h_rule:.3g} of 1e-4 of max|p| ({h_leaf}); [{card}]")
    return dict(frozen_vertices=len(frozen), head_rule=rule,
                head_worst_leaf=leaf, head_loss_rel=loss_rel,
                head_f32_rule=rule32, head_f32_worst_leaf=leaf32,
                frozen_unchanged=unchanged, fit_s=fit_s,
                step_ms=t["step_ms"], images_per_s=t["per_s"],
                windows=t["windows"], helper_rule=h_rule,
                helper_worst_leaf=h_leaf)


def moe_net(device, params=None, dtype="float32"):
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers import (MixtureOfExpertsLayer,
                                                     RnnOutputLayer)
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.nn.updater import Adam

    conf = (NeuralNetConfiguration.builder().seed(12).updater(
        Adam(learning_rate=1e-3)).dtype(dtype)
        .list(MixtureOfExpertsLayer(n_out=MOE["width"],
                                    n_experts=MOE["experts"],
                                    top_k=MOE["top_k"],
                                    expert_hidden=MOE["hidden"]),
              RnnOutputLayer(n_out=MOE["labels"], activation="softmax",
                             loss="mcxent"))
        .set_input_type(InputType.recurrent(MOE["width"])).build())
    return MultiLayerNetwork(conf).init(
        None if params is None else
        {k: {n: t.detach().to(getattr(torch, dtype), copy=True)
             for n, t in p.items()} for k, p in params.items()},
        device=device)


def phase_moe(card):
    """12d: ``MixtureOfExpertsLayer(n_out=512, n_experts=8, top_k=2,
    expert_hidden=2048)`` on [64, 128, 512] inputs under an Adam softmax
    head (a per-step RnnOutputLayer): the first step card against CPU on 4
    sequences (phase 7's rule, loss rtol 1e-4) with the selected experts
    equal token for token, then ms a step at full size."""
    cpu = moe_net("cpu")
    net = moe_net("cuda", cpu.params)
    rs = np.random.RandomState(9)
    R, T, W = MOE["cpu_rows"], MOE["seq"], MOE["width"]
    x = rs.randn(R, T, W).astype(np.float32)
    y = np.eye(MOE["labels"], dtype=np.float32)[
        rs.randint(0, MOE["labels"], (R, T))]
    layer = net.layers[0]
    with torch.no_grad():
        pick_c = layer.top_k_indices(torch.softmax(torch.einsum(
            "...d,de->...e", torch.from_numpy(x), cpu.params["0"]["Wg"]),
            -1)).sort(-1)[0]
        pick_d = layer.top_k_indices(torch.softmax(torch.einsum(
            "...d,de->...e", torch.from_numpy(x).cuda(),
            net.params["0"]["Wg"]), -1)).sort(-1)[0].cpu()
    same_experts = float((pick_c == pick_d).all(-1).float().mean())
    rule, leaf, loss_rel, _ = first_step_rule(net, cpu, x, y)
    del cpu
    check(same_experts == 1.0 and rule <= 1.0 and loss_rel <= 1e-4,
          f"12d: MoE first step card vs CPU: selected experts equal on "
          f"{same_experts:.4f} of tokens, {rule:.3g} of the bound at "
          f"{leaf}, loss rel {loss_rel:.3g}")
    xb, yb = device_batch((MOE["batch"], T, W), MOE["labels"], 13)
    yb = yb[:, None, :].expand(MOE["batch"], T, MOE["labels"]).contiguous()
    net.do_step(xb, yb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MOE["timed_steps"]):
        loss, _ = net.do_step(xb, yb)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / MOE["timed_steps"] * 1e3
    check(np.isfinite(float(loss)), "12d: MoE loss not finite")
    log(f"  12d MoE {MOE['experts']} experts top-{MOE['top_k']} at "
        f"[{MOE['batch']}, {T}, {W}] (hidden {MOE['hidden']}): first step "
        f"card vs CPU {rule:.3f} of phase 7's bound ({leaf}), loss rel "
        f"{loss_rel:.2e}, experts equal on every token; {step_ms:.2f} ms a "
        f"step ({MOE['batch'] * T / step_ms * 1e3:.0f} tokens/s); "
        f"[{card}]")
    return dict(rule=rule, worst_leaf=leaf, loss_rel=loss_rel,
                step_ms=step_ms, tokens_per_s=MOE["batch"] * T / step_ms
                * 1e3)


def phase_solvers(card):
    """12e: ``Solver`` with each line-search algorithm on LeNet at batch
    64 (the port's synthetic MNIST): card and CPU in f64 from the same
    weights take the same number of iterations, stop for the same reason
    and their losses agree within rtol 1e-9; the f32 card losses are
    reported."""
    from deeplearning4j_torch.optimize.solvers import Solver

    ds = mnist_nhwc(True, SOLVER["batch"], SOLVER["batch"])[0]
    x, y = ds.features, ds.labels
    out = {}
    for algo in SOLVER["algorithms"]:
        runs = {}
        src = twin("LeNet", "cpu")
        for dev, dt in (("cpu", "float64"), ("cuda", "float64"),
                        ("cuda", "float32")):
            net = twin("LeNet", dev, src.params, dtype=dt)
            s = Solver(net, algorithm=algo,
                       max_iterations=SOLVER["iterations"])
            t0 = time.perf_counter()
            final = s.optimize(x.astype(dt), y.astype(dt))
            runs[(dev, dt)] = dict(final=final, reason=s.optimizer.reason,
                                   losses=[h[0] for h in s.optimizer.history],
                                   steps=[h[1] for h in s.optimizer.history],
                                   s=time.perf_counter() - t0)
        c, d = runs[("cpu", "float64")], runs[("cuda", "float64")]
        rel = max((abs(a - b) / abs(b) for a, b in zip(d["losses"],
                                                       c["losses"])),
                  default=0.0)
        check(len(c["losses"]) == len(d["losses"])
              and c["reason"] == d["reason"] and rel <= 1e-9,
              f"12e {algo}: f64 card {len(d['losses'])} iterations "
              f"({d['reason']}) vs CPU {len(c['losses'])} ({c['reason']}), "
              f"losses rel {rel:.3g}")
        f32 = runs[("cuda", "float32")]
        log(f"  12e {algo}: f64 card = CPU: {len(c['losses'])} iterations, "
            f"{c['reason']}, losses within {rel:.2e} ({c['losses'][0]:.6f} "
            f"-> {c['final']:.6f}); f32 card losses "
            f"{[round(v, 6) for v in f32['losses']]} ({f32['reason']}, "
            f"{f32['s']:.2f} s); [{card}]")
        out[algo] = dict(iterations=len(c["losses"]), reason=c["reason"],
                         f64_loss_rel=rel, f64_losses=c["losses"],
                         f32_losses=f32["losses"], f32_reason=f32["reason"],
                         f32_s=f32["s"])
    return out


def every_vertex_graph(device):
    """A graph holding every vertex the port has (four inputs, two
    outputs), drawn from its seed."""
    from deeplearning4j_torch.nn.conf import graph_conf as gc
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType as I
    from deeplearning4j_torch.nn.conf.layers import (ConvolutionLayer,
                                                     DenseLayer, LSTM,
                                                     OutputLayer,
                                                     RnnOutputLayer)
    from deeplearning4j_torch.nn.conf.preprocessors import (
        CnnToFeedForwardPreProcessor)
    from deeplearning4j_torch.nn.graph import ComputationGraph
    from deeplearning4j_torch.nn.updater import Adam

    g = (NeuralNetConfiguration.builder().seed(21)
         .updater(Adam(learning_rate=1e-2))
         .graph_builder().add_inputs("a", "b", "img", "seq")
         .set_input_types(I.feed_forward(6), I.feed_forward(6),
                          I.convolutional(5, 5, 2), I.recurrent(3)))
    g.add_layer("da", DenseLayer(n_out=4, activation="tanh"), "a")
    g.add_layer("db", DenseLayer(n_out=4, activation="tanh"), "b")
    g.add_vertex("merge", gc.MergeVertex(), "da", "db")
    g.add_vertex("sub", gc.SubsetVertex(from_index=1, to_index=5), "merge")
    g.add_vertex("ew", gc.ElementWiseVertex(op="max"), "da", "db")
    g.add_vertex("stack", gc.StackVertex(), "da", "db")
    g.add_vertex("unstack", gc.UnstackVertex(from_index=1, stack_size=2),
                 "stack")
    g.add_vertex("scale", gc.ScaleVertex(scale=0.5), "unstack")
    g.add_vertex("shift", gc.ShiftVertex(shift=0.25), "scale")
    g.add_vertex("l2", gc.L2Vertex(), "da", "db")
    g.add_vertex("l2n", gc.L2NormalizeVertex(), "merge")
    g.add_vertex("rs1", gc.ReshapeVertex(shape=(2, 4)), "l2n")
    g.add_vertex("rs2", gc.ReshapeVertex(shape=(8,)), "rs1")
    g.add_layer("conv", ConvolutionLayer(n_out=3, kernel_size=(2, 2),
                                         activation="relu"), "img")
    g.add_vertex("crop", gc.PoolHelperVertex(), "conv")
    g.add_vertex("flat", gc.PreprocessorVertex(
        preprocessor=CnnToFeedForwardPreProcessor(3, 3, 3)), "crop")
    g.add_layer("lstm", LSTM(n_out=4, activation="tanh"), "seq")
    g.add_vertex("last", gc.LastTimeStepVertex(mask_input="seq"), "lstm")
    g.add_vertex("dup", gc.DuplicateToTimeSeriesVertex(input_name="seq"),
                 "last")
    g.add_vertex("all", gc.MergeVertex(), "sub", "ew", "shift", "l2", "rs2",
                 "flat", "last")
    g.add_layer("hidden", DenseLayer(n_out=5, activation="tanh"), "all")
    g.add_layer("out1", OutputLayer(n_out=3, activation="softmax",
                                    loss="mcxent"), "hidden")
    g.add_layer("out2", RnnOutputLayer(n_out=2, activation="softmax",
                                       loss="mcxent"), "dup")
    return ComputationGraph(g.set_outputs("out1", "out2").build()).init(
        device=device)


def phase_vertex_zip(card):
    """12f: a graph of every vertex built and trained two Adam steps on the
    CPU, saved as a zip, loaded with ``load_model(..., device="cuda")``:
    both outputs within 1e-5 of max|y| of the CPU's, the parameters bit
    for bit."""
    from deeplearning4j_torch.utils.model_serializer import (load_model,
                                                             save_model)

    cpu = every_vertex_graph("cpu")
    rs = np.random.RandomState(14)
    n = 8
    x = [rs.randn(n, 6), rs.randn(n, 6), rs.randn(n, 5, 5, 2),
         rs.randn(n, 7, 3)]
    x = [a.astype(np.float32) for a in x]
    y = [np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)],
         np.eye(2, dtype=np.float32)[rs.randint(0, 2, (n, 7))]]
    for _ in range(2):
        cpu.do_step(x, y)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "every_vertex.zip")
        save_model(cpu, path)
        net = load_model(path, device="cuda")
    check(net.device.type == "cuda" and np.array_equal(
        net.params_flat(), cpu.params_flat()),
        "12f: the loaded graph's parameters are not the CPU's")
    worst = 0.0
    for a, b in zip(net.output(*x), cpu.output(*x)):
        worst = max(worst, ((a.cpu() - b).abs().max()
                            / b.abs().max()).item())
    check(worst <= 1e-5, f"12f: outputs {worst:.3g} of max|y| from the "
                         "CPU's")
    log(f"  12f every-vertex graph ({len(net.conf.vertices)} vertices) "
        f"zip loaded on the card: outputs within {worst:.2e} of max|y|; "
        f"[{card}]")
    return dict(vertices=len(net.conf.vertices), max_rel=worst)


def phase_graphs(card):
    """Phase 12: graphs and fine-tuning (12a-12f)."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    log("phase 12a: ResNet50 at the JAX bench leg (batch 128, bf16 "
        "compute)")
    base, resnet = phase_resnet(card)
    log("phase 12b: GoogLeNet, FaceNetNN4Small2, InceptionResNetV1")
    zoo = phase_graph_zoo(card)
    log("phase 12c: fine-tuning 12a's ResNet50 with frozen stages")
    finetune = phase_finetune(base, resnet, card)
    del base
    torch.cuda.empty_cache()
    log("phase 12d: a mixture-of-experts FFN")
    moe = phase_moe(card)
    log("phase 12e: the line-search solvers on LeNet")
    solvers = phase_solvers(card)
    log("phase 12f: a graph of every vertex, zip to the card")
    vertex_zip = phase_vertex_zip(card)
    wall = time.perf_counter() - t0
    log(f"  phase 12: {wall:.1f} s; [{card}]")
    return dict(resnet=resnet, zoo=zoo, finetune=finetune, moe=moe,
                solvers=solvers, vertex_zip=vertex_zip, wall_s=wall)


# ------------------------------------------------------------- phase 13
#: 13a: dl4j-examples' DeepAutoEncoderExample: RBM encoder widths and the
#: mirrored decoder, CD-1, batch 128; 10 curve batches twice = 20 steps a
#: layer
DBN = dict(encoder=(1000, 500, 250, 100, 30), batch=128, batches=10,
           epochs=2, lr=1e-2, seed=123)
#: 13b: dl4j-examples' VaeMNISTAnomaly
VAE = dict(encoder=(256, 256), decoder=(256, 256), latent=32, batch=128,
           steps=50, lr=1e-3, l2=1e-4, seed=123)
#: 13c: a stacked denoising autoencoder on the curves
SDA = dict(sizes=(500, 250), corruption=0.3, lr=1e-3, seed=12)
#: 13d: LeNet batches for the iterator checks, Iris epochs, the profiler
#: window (iterations), the accumulation vector's length
PIPE = dict(lenet_batches=16, lenet_batch=64, iris_epochs=60,
            iris_batch=50, profile_start=4, profile_n=8, accum=2_800_000)
#: the first pretrain step card against CPU: 1e-4 of each leaf's max|g|
PRETRAIN_RULE = 1e-4


def curves_batches():
    """The curves set (generated from its seed, labels = features) as
    ``DBN["batches"]`` numpy DataSets of ``DBN["batch"]``."""
    from deeplearning4j_torch.datasets.curves import CurvesDataSetIterator

    return list(CurvesDataSetIterator(
        batch_size=DBN["batch"], num_examples=DBN["batch"] * DBN["batches"]))


def pretrain_conf(layers, updater, dtype="float32", seed=123, l2=None):
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType

    b = (NeuralNetConfiguration.builder().seed(seed).updater(updater)
         .weight_init("xavier").dtype(dtype))
    if l2:
        b = b.l2(l2)
    return b.list(*layers).set_input_type(InputType.feed_forward(784)).build()


def probe_net(net, device, dtype):
    """A copy of ``net`` on ``device`` in ``dtype`` under Sgd(1.0), so one
    ``_pretrain_layer`` step moves each leaf by minus its gradient."""
    import copy

    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.nn.updater import Sgd

    conf = copy.deepcopy(net.conf)
    conf.updater = Sgd(learning_rate=1.0)
    conf.dtype = dtype
    dt = getattr(torch, dtype)
    return MultiLayerNetwork(conf).init(
        {k: {n: t.detach().to("cpu", dt, copy=True) for n, t in p.items()}
         for k, p in net.params.items()}, device=device)


def first_pretrain_step(net, idx, ds, dtype="float32"):
    """Layer ``idx``'s first pretrain step (key ``fold_in(PRNGKey(seed +
    idx), 0)``) on the card and on the CPU from ``net``'s state, as
    gradients: the worst leaf's max|g_card - g_cpu| over ``PRETRAIN_RULE``
    of its max|g_cpu|. An RBM's binary hidden samples of the card are
    handed to the CPU (so the comparison is of the arithmetic) and the
    units where the CPU's own sample differs are counted as flips."""
    card, cpu = probe_net(net, "cuda", dtype), probe_net(net, "cpu", dtype)
    lc, lh = card.layers[idx], cpu.layers[idx]
    seen = {"flips": 0, "units": 0}
    if hasattr(lc, "_hidden_sample"):
        def record(rng, pre, mean):
            s = type(lc)._hidden_sample(lc, rng, pre, mean)
            seen.setdefault("card", []).append(s.cpu())
            return s

        def inject(rng, pre, mean):
            own = type(lh)._hidden_sample(lh, rng, pre, mean)
            theirs = seen["card"][len(seen.get("used", []))]
            seen.setdefault("used", []).append(1)
            seen["flips"] += int((own != theirs).sum())
            seen["units"] += own.numel()
            return theirs

        lc._hidden_sample = record
        lh._hidden_sample = inject
    before = {n: t.detach().cpu().double() for n, t in
              card.params[str(idx)].items()}
    card._pretrain_layer(idx, ds, 1)
    cpu._pretrain_layer(idx, ds, 1)
    worst, leaf = 0.0, None
    for n, b in before.items():
        gd = b - card.params[str(idx)][n].cpu().double()
        gc = b - cpu.params[str(idx)][n].double()
        r = ((gd - gc).abs().max() / (PRETRAIN_RULE * max(
            gc.abs().max().item(), 1e-300))).item()
        if r > worst:
            worst, leaf = r, n
    return dict(rule=worst, leaf=leaf, flips=seen["flips"],
                units=seen["units"])


def timed_pretrain(net, data, epochs, checks):
    """``net.pretrain(data, epochs)`` with each layer's ``_pretrain_layer``
    timed (synchronized) and its per-step losses kept; ``checks(idx)``
    runs before each layer, from the state that layer starts at, outside
    the timing. Returns ``{idx: dict(s, steps, losses, check)}``."""
    out = {}
    orig = net._pretrain_layer

    def wrapped(idx, it, n_epochs):
        res = checks(idx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = orig(idx, it, n_epochs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[idx] = dict(s=wall, steps=len(losses), steps_per_s=len(losses)
                        / wall, losses=[float(v) for v in losses],
                        check=res)
        return losses

    net._pretrain_layer = wrapped
    try:
        net.pretrain(data, epochs=epochs)
    finally:
        del net._pretrain_layer
    return out


def pretrain_profile(net, idx, data, steps):
    """Launches a step and the idle share of ``steps`` pretrain steps of
    layer ``idx`` on a copy of ``net``."""
    probe = net.clone()
    probe._pretrain_layer(idx, data[:1], 1)
    return busy_share(lambda: probe._pretrain_layer(idx, data[:steps], 1),
                      steps)


def rbm_recon_mse(net, idx, x):
    lyr, p = net.layers[idx], net.params[str(idx)]
    with torch.no_grad():
        return float(((lyr.prop_down(p, lyr.prop_up(p, x)) - x) ** 2).mean())


def phase_dbn(curves, card):
    """13a: a deep belief stack at DeepAutoEncoderExample's widths."""
    from deeplearning4j_torch.nn.conf.layers import OutputLayer, RBM
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.nn.updater import Adam

    widths = DBN["encoder"] + DBN["encoder"][-2::-1]
    layers = [RBM(n_out=w) for w in widths] + [
        OutputLayer(n_out=784, activation="sigmoid", loss="mse")]
    net = MultiLayerNetwork(pretrain_conf(
        layers, Adam(learning_rate=DBN["lr"]), seed=DBN["seed"])).init(
            device="cuda")
    x0 = torch.from_numpy(curves[0].features).cuda()
    mse0 = rbm_recon_mse(net, 0, x0)
    score0 = net.score(curves[0])
    first = curves[:1]
    per = timed_pretrain(net, curves, DBN["epochs"],
                         lambda idx: first_pretrain_step(net, idx, first[0]))
    mse1 = rbm_recon_mse(net, 0, x0)
    flips = sum(r["check"]["flips"] for r in per.values())
    units = sum(r["check"]["units"] for r in per.values())
    worst = max(per.items(), key=lambda kv: kv[1]["check"]["rule"])
    check(len(per) == len(widths) and all(
        r["steps"] == DBN["batches"] * DBN["epochs"] for r in per.values()),
        f"13a: pretrain ran layers {sorted(per)} with steps "
        f"{[r['steps'] for r in per.values()]}")
    check(worst[1]["check"]["rule"] <= 1.0,
          f"13a: layer {worst[0]}'s first CD step card vs CPU "
          f"{worst[1]['check']['rule']:.3g} of the bound at "
          f"{worst[1]['check']['leaf']}")
    check(all(np.isfinite(r["losses"]).all() for r in per.values()),
          "13a: a pretrain loss is not finite")
    check(mse1 < mse0, f"13a: layer 0's reconstruction MSE {mse0:.5f} -> "
                       f"{mse1:.5f} did not fall")
    prof = {i: pretrain_profile(net, i, curves, 5) for i in (0, 4)}
    fit_t0 = time.perf_counter()
    net.fit(curves)
    score1 = float(net.score(curves[0]))
    fit_s = time.perf_counter() - fit_t0
    check(np.isfinite(score1) and score1 < score0,
          f"13a: fit of the stack: MSE {score0:.5f} -> {score1:.5f}")
    for i, r in sorted(per.items()):
        log(f"  13a layer {i} ({net.layers[i].n_in} -> "
            f"{net.layers[i].n_out}): {r['steps_per_s']:.1f} steps/s, "
            f"first step {r['check']['rule']:.3g} of the bound, flips "
            f"{r['check']['flips']}/{r['check']['units']}, recon error "
            f"{r['losses'][0]:.3f} -> {r['losses'][-1]:.3f}")
    log(f"  13a: layer 0 reconstruction MSE {mse0:.5f} -> {mse1:.5f}; "
        f"flips {flips} of {units} units; launches a step "
        f"{prof[0]['kernel_launches_per_step']:.0f} (layer 0) / "
        f"{prof[4]['kernel_launches_per_step']:.0f} (layer 4), idle "
        f"{prof[0]['idle_share']:.3f} / {prof[4]['idle_share']:.3f}; fit "
        f"{len(curves)} steps {fit_s / len(curves) * 1e3:.2f} ms/step, MSE "
        f"{score0:.5f} -> {score1:.5f}; [{card}]")
    return dict(layers={str(i): dict(n_in=net.layers[i].n_in,
                                     n_out=net.layers[i].n_out,
                                     steps_per_s=r["steps_per_s"],
                                     first_step_rule=r["check"]["rule"],
                                     flips=r["check"]["flips"],
                                     units=r["check"]["units"],
                                     loss_first=r["losses"][0],
                                     loss_last=r["losses"][-1])
                        for i, r in per.items()},
                flips=flips, units=units, recon_mse=[mse0, mse1],
                profile={str(i): p for i, p in prof.items()},
                fit_ms_per_step=fit_s / len(curves) * 1e3,
                fit_mse=[float(score0), score1])


def phase_vae(card):
    """13b: the VAE of VaeMNISTAnomaly on the synthetic MNIST."""
    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.datasets.mnist import synthetic_mnist
    from deeplearning4j_torch.nn.conf.layers import (
        BernoulliReconstructionDistribution, VariationalAutoencoder)
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.nn.updater import Adam

    data = synthetic_mnist(VAE["batch"] * VAE["steps"], seed=VAE["seed"])
    batches = list(data.batch_by(VAE["batch"]))
    vae = VariationalAutoencoder(
        n_out=VAE["latent"], encoder_layer_sizes=VAE["encoder"],
        decoder_layer_sizes=VAE["decoder"], activation="leakyrelu",
        pzx_activation="identity",
        reconstruction_distribution=BernoulliReconstructionDistribution(
            activation="sigmoid"))
    net = MultiLayerNetwork(pretrain_conf(
        [vae], Adam(learning_rate=VAE["lr"]), seed=VAE["seed"],
        l2=VAE["l2"])).init(device="cuda")
    f64 = first_pretrain_step(net, 0, batches[0], "float64")
    f32 = first_pretrain_step(net, 0, batches[0], "float32")
    check(f64["rule"] <= 1e-6,
          f"13b: first VAE step card vs CPU in f64 {f64['rule']:.3g} of the "
          f"bound at {f64['leaf']}")
    per = timed_pretrain(net, batches, 1, lambda idx: None)[0]
    elbo = per["losses"]
    first, last = float(np.mean(elbo[:5])), float(np.mean(elbo[-5:]))
    check(np.isfinite(elbo).all() and last < first,
          f"13b: -ELBO {first:.2f} -> {last:.2f}")
    prof = pretrain_profile(net, 0, batches, 5)
    x = torch.from_numpy(batches[0].features).cuda()
    with torch.no_grad():
        rec = net.layers[0].reconstruct(net.params["0"], x)
    check(rec.shape == x.shape and torch.isfinite(rec).all().item(),
          "13b: reconstruct")
    log(f"  13b VAE 784 -> {VAE['encoder']} -> {VAE['latent']} -> "
        f"{VAE['decoder']}: first step card vs CPU {f64['rule']:.3g} of the "
        f"bound in f64 ({f64['leaf']}), {f32['rule']:.3g} in f32 "
        f"({f32['leaf']}); -ELBO {elbo[0]:.2f} -> {elbo[-1]:.2f} over "
        f"{len(elbo)} steps (mean of 5: {first:.2f} -> {last:.2f}); "
        f"{per['steps_per_s']:.1f} steps/s, "
        f"{prof['kernel_launches_per_step']:.0f} launches a step, idle "
        f"{prof['idle_share']:.3f}; [{card}]")
    return dict(first_step_rule_f64=f64["rule"],
                first_step_leaf_f64=f64["leaf"],
                first_step_rule_f32=f32["rule"],
                first_step_leaf_f32=f32["leaf"],
                elbo=elbo, steps_per_s=per["steps_per_s"], profile=prof)


def phase_sda(curves, card):
    """13c: a stacked denoising autoencoder on the curves, then fit."""
    from deeplearning4j_torch.nn.conf.layers import AutoEncoder, OutputLayer
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.nn.updater import Adam

    layers = [AutoEncoder(n_out=w, corruption_level=SDA["corruption"])
              for w in SDA["sizes"]] + [
        OutputLayer(n_out=784, activation="sigmoid", loss="mse")]
    net = MultiLayerNetwork(pretrain_conf(
        layers, Adam(learning_rate=SDA["lr"]), seed=SDA["seed"])).init(
            device="cuda")
    x0 = torch.from_numpy(curves[0].features).cuda()

    def clean_recon():
        with torch.no_grad():
            return float(net.layers[0].reconstruction_loss_per_example(
                net.params["0"], x0).mean())

    r0, score0 = clean_recon(), net.score(curves[0])

    def both(idx):
        return dict(f64=first_pretrain_step(net, idx, curves[0], "float64"),
                    f32=first_pretrain_step(net, idx, curves[0]))

    per = timed_pretrain(net, curves, DBN["epochs"], both)
    r1 = clean_recon()
    firsts = {i: {p: (r["check"][p]["rule"], r["check"][p]["leaf"])
                  for p in ("f64", "f32")} for i, r in per.items()}
    worst64 = max(f["f64"][0] for f in firsts.values())
    worst32 = max(f["f32"][0] for f in firsts.values())
    check(worst64 <= 1e-6 and worst32 <= 1.0,
          f"13c: a first AutoEncoder step card vs CPU: {firsts}")
    check(r1 < r0, f"13c: layer 0's reconstruction {r0:.5f} -> {r1:.5f}")
    prof = pretrain_profile(net, 0, curves, 5)
    t0 = time.perf_counter()
    net.fit(curves)
    score1 = float(net.score(curves[0]))
    fit_s = time.perf_counter() - t0
    check(np.isfinite(score1) and score1 < score0,
          f"13c: fit MSE {score0:.5f} -> {score1:.5f}")
    log(f"  13c stacked denoising AutoEncoder 784 -> {SDA['sizes']}: first "
        f"steps card vs CPU (of the bound, worst leaf) {firsts}; "
        f"{[round(r['steps_per_s'], 1) for r in per.values()]}"
        f" steps/s; layer 0 reconstruction {r0:.5f} -> {r1:.5f}; "
        f"{prof['kernel_launches_per_step']:.0f} launches a step, idle "
        f"{prof['idle_share']:.3f}; fit MSE {score0:.5f} -> {score1:.5f} "
        f"({fit_s / len(curves) * 1e3:.2f} ms/step); [{card}]")
    return dict(first_steps={str(i): f for i, f in firsts.items()},
                steps_per_s=[r["steps_per_s"] for r in per.values()],
                recon=[r0, r1], fit_mse=[float(score0), score1],
                fit_ms_per_step=fit_s / len(curves) * 1e3, profile=prof)


def iris_conf():
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_torch.nn.updater import Adam

    return (NeuralNetConfiguration.builder().seed(6)
            .updater(Adam(learning_rate=0.03))
            .list(DenseLayer(n_out=10, activation="tanh"),
                  OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())


def phase_pipeline(card, out_dir):
    """13d: the data pipeline and listeners on the card."""
    import json as _json

    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.datasets.iterators import (
        AsyncDataSetIterator, DevicePrefetchIterator, ListDataSetIterator,
        MultipleEpochsIterator)
    from deeplearning4j_torch.datasets.mnist import IrisDataSetIterator
    from deeplearning4j_torch.ml import DL4JClassifier
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.optimize.accumulation import threshold_encode
    from deeplearning4j_torch.optimize.listeners import ProfilerListener

    n, b = PIPE["lenet_batches"], PIPE["lenet_batch"]
    merged = DataSet.merge(mnist_nhwc(True, n * b, b))

    def base():
        return ListDataSetIterator(merged, batch_size=b)

    twin("LeNet", "cuda").fit(base())        # warm: cuDNN's first calls
    plain, piped = twin("LeNet", "cuda"), twin("LeNet", "cuda")
    t0 = time.perf_counter()
    plain.fit(base())
    float(plain.score())
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    piped.fit(AsyncDataSetIterator(DevicePrefetchIterator(base(), depth=2)))
    float(piped.score())
    piped_s = time.perf_counter() - t0
    pipe_bitwise = same_params(plain, piped)
    check(piped.iteration == plain.iteration == n and pipe_bitwise[0],
          f"13d: LeNet fit through Async(DevicePrefetch) vs plain: "
          f"iterations {piped.iteration}/{plain.iteration}, {pipe_bitwise}")

    twice, replay = twin("LeNet", "cuda"), twin("LeNet", "cuda")
    twice.fit(base(), epochs=2)
    replay.fit(MultipleEpochsIterator(base(), 2))
    multi_bitwise = same_params(twice, replay)
    check(replay.iteration == 2 * n and multi_bitwise[0],
          f"13d: MultipleEpochsIterator vs epochs=2: {multi_bitwise}")

    iris = IrisDataSetIterator(batch_size=PIPE["iris_batch"])
    mlp = MultiLayerNetwork(iris_conf()).init(device="cuda")
    mlp.fit(iris, epochs=PIPE["iris_epochs"])
    acc = mlp.evaluate(IrisDataSetIterator(batch_size=150)).accuracy()
    check(acc >= 0.9, f"13d: Iris MLP accuracy {acc:.4f}")

    with tempfile.TemporaryDirectory() as tmp:
        log_dir = os.path.join(out_dir, "profiler_listener") if out_dir \
            else tmp
        lst = ProfilerListener(log_dir, start_iteration=PIPE["profile_start"],
                               num_iterations=PIPE["profile_n"])
        prof_net = twin("LeNet", "cuda")
        prof_net.set_listeners(lst)
        prof_net.fit(base())
        check(lst.trace_path is not None, "13d: ProfilerListener wrote no "
                                          "trace")
        with open(lst.trace_path) as f:
            events = _json.load(f)["traceEvents"]
        trace_bytes = os.path.getsize(lst.trace_path)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    check(len(kernels) > 0, f"13d: the profiler trace holds no kernel "
                            f"events ({len(events)} events)")

    g = torch.Generator().manual_seed(5)
    grad = torch.randn(PIPE["accum"], generator=g) * 1e-3
    res = torch.randn(PIPE["accum"], generator=g) * 5e-4
    msg_c, res_c = threshold_encode(grad, res, 1e-3)
    gd, rd = grad.cuda(), res.cuda()
    msg_d, res_d = threshold_encode(gd, rd, 1e-3)
    enc_bitwise = (torch.equal(msg_d.cpu(), msg_c)
                   and torch.equal(res_d.cpu(), res_c))
    check(enc_bitwise, "13d: threshold_encode card != CPU")
    enc_ms = time_ms(lambda: threshold_encode(gd, rd, 1e-3), iters=20)

    rows = IrisDataSetIterator(batch_size=150).data
    x, labels = rows.features, np.argmax(rows.labels, axis=-1)
    clf = DL4JClassifier(iris_conf, epochs=PIPE["iris_epochs"],
                         batch_size=PIPE["iris_batch"]).fit(x, labels)
    own = MultiLayerNetwork(iris_conf()).init(device="cuda")
    own.fit(ListDataSetIterator(DataSet(x, np.eye(3, dtype=np.float32)
                                        [labels]),
                                batch_size=PIPE["iris_batch"]),
            epochs=PIPE["iris_epochs"])
    clf_bitwise = (same_params(clf.net_, own)[0] and np.array_equal(
        clf.predict_proba(x), own.output(x).cpu().numpy()))
    check(clf.net_.device.type == "cuda",
          f"13d: DL4JClassifier built its net on {clf.net_.device}")
    check(clf_bitwise, "13d: DL4JClassifier differs from the net's own "
                       "fit/output")
    clf_acc = clf.score(x, labels)
    log(f"  13d: LeNet fit through Async(DevicePrefetch) bitwise the plain "
        f"iterator over {n} batches ({piped_s * 1e3 / n:.2f} vs "
        f"{plain_s * 1e3 / n:.2f} ms/step, after a warm fit); "
        f"MultipleEpochsIterator bitwise epochs=2; Iris MLP accuracy "
        f"{acc:.4f}; ProfilerListener trace {trace_bytes} bytes, "
        f"{len(kernels)} kernel events of {len(events)}; threshold_encode "
        f"of {PIPE['accum']} card = CPU bitwise, {enc_ms:.4f} ms; "
        f"DL4JClassifier bitwise the net's own fit/output, accuracy "
        f"{clf_acc:.4f}; [{card}]")
    return dict(prefetch_bitwise=pipe_bitwise[0],
                prefetch_ms_per_step=piped_s * 1e3 / n,
                plain_ms_per_step=plain_s * 1e3 / n,
                multiple_epochs_bitwise=multi_bitwise[0], iris_accuracy=acc,
                trace_bytes=trace_bytes, trace_kernel_events=len(kernels),
                threshold_encode_bitwise=enc_bitwise,
                threshold_encode_ms=enc_ms, classifier_bitwise=clf_bitwise,
                classifier_accuracy=clf_acc)


def phase_pretrain(card, out_dir=None):
    """Phase 13: layer-wise pretraining, the data pipeline and listeners
    (13a-13d)."""
    t0 = time.perf_counter()
    curves = curves_batches()
    log(f"  13: {len(curves)} curve batches made in "
        f"{time.perf_counter() - t0:.1f} s")
    log("phase 13a: a deep belief stack (RBMs 784 -> 1000 -> 500 -> 250 -> "
        "100 -> 30 and back, CD-1) on the curves, then fit")
    dbn = phase_dbn(curves, card)
    log("phase 13b: the VaeMNISTAnomaly VAE on synthetic MNIST")
    vae = phase_vae(card)
    log("phase 13c: a stacked denoising AutoEncoder on the curves, then "
        "fit")
    sda = phase_sda(curves, card)
    log("phase 13d: the data pipeline and listeners")
    pipe = phase_pipeline(card, out_dir)
    wall = time.perf_counter() - t0
    log(f"  phase 13: {wall:.1f} s; [{card}]")
    return dict(dbn=dbn, vae=vae, sda=sda, pipeline=pipe, wall_s=wall)


# ---------------------------------------------------------------- phase 14
#: 14a: ``bench.py::bench_word2vec``'s corpus and model (not cut); repeats
#: of the timed fits (the bench takes three; fewer keep the phase short:
#: one of the native loop's since phase 18 runs, two before)
W2V = dict(sentences=50_000, words=20, vocab=30_000, zipf=1.3, seed=3,
           layer=128, window=5, negative=5, batch=8192, min_freq=2,
           repeats=2, native_repeats=1, block_batches=80,
           defaults_sentences=2_500)
#: 14b: ``bench.py::bench_doc2vec``'s documents and DBOW model
D2V = dict(docs=4_000, words=40, vocab=5_000, seed=5, layer=100, window=5,
           negative=5, min_freq=2, model_seed=11, dm_docs=500)
GLOVE = dict(sentences=5_000, epochs=3)
#: 14d: DeepWalk at the paper's vector size and window and the class's
#: walk length, 1 walk a vertex (the class takes 10, the paper 80: cut to
#: keep the script within its limit, to 5 before phase 18, then to 2, and
#: to 1 for phase 21)
DEEPWALK = dict(vertices=2_000, vector=128, window=10, walk_length=40,
                walks=1, within=5, bridges=100, seed=3)
#: 14e: a Keras-1 MNIST CNN at LeNet's widths
KERAS_LENET = dict(conv=(20, 50), kernel=5, dense=500, labels=10, batch=256)
#: tables after a block or an epoch from the same state, card against CPU
NLP_TABLE_ATOL = 1e-5
#: the same after a whole fit of many batches, over max|table| (on an H100
#: 80GB HBM3, 2,560 HS batches drift up to 2e-4 of it apart)
NLP_FIT_REL = 1e-3
#: 14c: a GloVe epoch's tables card against CPU, over each table's max (on
#: an H100 80GB HBM3 they read up to 6.5e-6 of it: the atomics reorder
#: AdaGrad's adds to hot rows)
GLOVE_EPOCH_REL = 1e-4
#: 14a profiles a fit of this many sentences of the corpus (a full fit's
#: ~500k profiler events take longer to read than to run)
W2V_PROFILED = 2_500


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def zipf_text(n, words, vocab, seed):
    """``bench.py``'s corpus: ``n`` lines of ``words`` Zipf(1.3) words
    over ``vocab`` words, from RandomState(seed)."""
    rs = np.random.RandomState(seed)
    names = [f"w{i}" for i in range(vocab)]
    z = np.minimum(rs.zipf(W2V["zipf"], size=n * words) - 1, vocab - 1)
    return [" ".join(names[k] for k in z[i * words:(i + 1) * words])
            for i in range(n)]


def table_err(a, b):
    from deeplearning4j_torch.nlp.sequence_vectors import host

    return float(np.max(np.abs(host(a) - host(b))))


def nearest_agree(a, b, tol):
    """Two ``words_nearest`` lists agree: the same words in the same order,
    or swapped only where their similarities are within ``tol``."""
    sims_b = dict(b)
    for (wa, sa), (wb, sb) in zip(a, b):
        if abs(sa - sb) > tol:
            return False
        if wa != wb and abs(sims_b.get(wa, -9.0) - sa) > tol:
            return False
    return len(a) == len(b)


def w2v_block(w, init, stream, dev):
    """One corpus block of the bench leg (its first ``block_batches``
    batches) trained from the same tables and key on ``dev``; returns the
    tables, the window validity and the negative draws."""
    from deeplearning4j_torch.nlp import learning
    from deeplearning4j_torch.ops import random as prandom

    B, W, K = W2V["batch"], W2V["window"], W2V["negative"]
    n = W2V["block_batches"] * B // (2 * W)
    tabs = [torch.from_numpy(a.copy()).to(dev) for a in init]
    lut = w._lookup_tables(torch.device(dev))
    toks = torch.from_numpy(stream[:n]).long().to(dev)
    key = prandom.fold_in(prandom.PRNGKey(w.seed + 1, device=dev), 0)
    _, val, kn = learning._shifted_pairs(toks, key, W)
    draws = torch.stack(list(learning._negative_draws(
        kn, W2V["block_batches"], B, K, lut[3].shape[0])))
    learning.skipgram_corpus_epoch(
        *tabs, toks, key, w.learning_rate, w.min_learning_rate,
        learning.DUP_CAP, *lut, window=W, batch=B, neg_k=K, use_hs=False,
        use_ns=True)
    sync(dev)
    return tabs, val.cpu(), draws.cpu()


def phase_word2vec(card, dev):
    """14a: Word2Vec at the JAX bench leg, device and native, a block card
    against CPU, then the class defaults on 2,500 sentences."""
    from deeplearning4j_torch import native
    from deeplearning4j_torch.nlp import CollectionSentenceIterator, Word2Vec

    t0 = time.perf_counter()
    sents = zipf_text(W2V["sentences"], W2V["words"], W2V["vocab"],
                      W2V["seed"])
    total = len(sents) * W2V["words"]
    kw = dict(layer_size=W2V["layer"], window=W2V["window"],
              min_word_frequency=W2V["min_freq"], negative=W2V["negative"],
              use_hierarchic_softmax=False, epochs=1,
              batch_size=W2V["batch"])
    w = Word2Vec(backend="device", device=dev, **kw)
    w.build_vocab(sents)
    w.reset_weights()
    check(torch.is_tensor(w.syn0) and w.syn0.device.type ==
          torch.device(dev).type, "14a: the device path's tables are not "
          "on the card")
    init = [t.cpu().numpy() for t in (w.syn0, w.syn1, w.syn1neg)]
    b = w._builder
    stream = w._token_stream([b.lookup_indices(s.split()) for s in sents],
                             W2V["batch"], W2V["window"])
    batches = stream.size * 2 * W2V["window"] // W2V["batch"]
    log(f"  14a: corpus {len(sents)} x {W2V['words']} words, vocab "
        f"{w.vocab_size()}, {batches} batches of {W2V['batch']} "
        f"({time.perf_counter() - t0:.1f} s to make and count)")

    def fresh_fit(model):
        model.syn0 = None
        model.reset_weights()
        t = time.perf_counter()
        model.fit(CollectionSentenceIterator(sents))
        sync(dev)
        return time.perf_counter() - t

    tick = time.perf_counter()

    def lap(what):
        nonlocal tick
        now = time.perf_counter()
        log(f"    {what}: {now - tick:.1f} s")
        tick = now

    fresh_fit(w)                                   # warm
    device_s = [fresh_fit(w) for _ in range(W2V["repeats"])]
    check(torch.isfinite(w.syn0).all().item()
          and table_err(w.syn0, init[0]) > 0, "14a: device tables")
    lap(f"{W2V['repeats'] + 1} device fits")
    part = sents[:W2V_PROFILED]
    w.syn0 = None
    w.reset_weights()
    part_batches = w._token_stream(
        [b.lookup_indices(s.split()) for s in part], W2V["batch"],
        W2V["window"]).size * 2 * W2V["window"] // W2V["batch"]
    prof = busy_share(lambda: w.fit(CollectionSentenceIterator(part)),
                      part_batches)
    lap(f"a profiled fit of {len(part)} sentences ({part_batches} "
        f"batches): {prof['kernel_launches_per_step']:.1f} launches a "
        f"batch, idle {prof['idle_share']:.3f}")
    card_tabs, card_val, card_draws = w2v_block(w, init, stream, dev)
    again, _, _ = w2v_block(w, init, stream, dev)
    cpu_tabs, cpu_val, cpu_draws = w2v_block(w, init, stream, "cpu")
    lap("the block twice on the card and once on the CPU")
    check(torch.equal(card_val, cpu_val) and torch.equal(card_draws,
                                                         cpu_draws),
          "14a: the window or negative draws differ card against CPU")
    block_err = max(table_err(a, c) for a, c in zip(card_tabs, cpu_tabs))
    check(block_err <= NLP_TABLE_ATOL,
          f"14a: a block's tables card against CPU {block_err:.3g}")
    deterministic = all(torch.equal(a, c) for a, c in zip(card_tabs, again))

    wn = Word2Vec(backend="native", device=dev, **kw)
    wn.build_vocab(sents)
    check(native.skipgram_native_available() and wn._use_native_backend(),
          "14a: the native library did not build, or 'native' did not "
          "take it")
    native_s = [fresh_fit(wn) for _ in range(W2V["native_repeats"])]
    check(isinstance(wn.syn0, np.ndarray) and np.isfinite(wn.syn0).all(),
          "14a: 'native' did not train in the native loop")
    lap(f"{W2V['native_repeats']} native fit(s)")
    sub = sents[:W2V["defaults_sentences"]]
    auto = Word2Vec(device=dev, **kw).fit(sub)
    check(auto.backend == "auto" and not auto._use_native_backend()
          and torch.is_tensor(auto.syn0) and auto.syn0.device.type == "cuda"
          and torch.isfinite(auto.syn0).all().item(),
          "14a: a negative-sampling fit under the default 'auto' did not "
          "keep its tables on the card")
    lap(f"an 'auto' fit of {len(sub)} sentences on the card")

    t = time.perf_counter()
    dflt = Word2Vec(device=dev).fit(sub)
    sync(dev)
    dflt_s = time.perf_counter() - t
    lap("the class defaults on the card")
    dflt_cpu = Word2Vec(device="cpu").fit(sub)
    lap("... and on the CPU")
    scale = float(dflt_cpu.syn0.abs().max())
    dflt_err = max(table_err(getattr(dflt, n), getattr(dflt_cpu, n))
                   for n in ("syn0", "syn1"))
    check(dflt.use_hs and dflt.negative == 0
          and dflt_err <= NLP_FIT_REL * scale,
          f"14a: class defaults card against CPU {dflt_err:.3g} "
          f"(max|syn0| {scale:.3g})")
    queries = ["w0", "w1", "w7", "w42", "w300"]
    for q in queries:
        got, want = dflt.words_nearest(q, 10), dflt_cpu.words_nearest(q, 10)
        check(nearest_agree(got, want, 1e-5),
              f"14a: words_nearest({q!r}) card {got[:3]} CPU {want[:3]}")
    sums = dflt.words_nearest_sum(["w1", "w2"], ["w3"], 5)
    check(nearest_agree(sums, dflt_cpu.words_nearest_sum(
        ["w1", "w2"], ["w3"], 5), 1e-5), "14a: words_nearest_sum card vs "
        "CPU")
    dev_wps = [total / s for s in device_s]
    nat_wps = [total / s for s in native_s]
    log(f"  14a Word2Vec (layer {W2V['layer']}, window {W2V['window']}, "
        f"negative {W2V['negative']}, batch {W2V['batch']}): device "
        f"{np.median(dev_wps):,.0f} words/s {[round(v) for v in dev_wps]}, "
        f"{prof['kernel_launches_per_step']:.1f} launches a batch, idle "
        f"{prof['idle_share']:.3f}; native "
        f"{np.median(nat_wps):,.0f} words/s {[round(v) for v in nat_wps]}; "
        f"a {W2V['block_batches']}-batch block card vs CPU {block_err:.3g} "
        f"(draws bitwise), two card runs bitwise: {deterministic}; class "
        f"defaults on {len(sub)} sentences {dflt_s:.2f} s, card vs CPU "
        f"{dflt_err:.3g} (max|syn0| {scale:.3g}), words_nearest equal for "
        f"{queries}; [{card}]")
    return w, dict(device_words_s=dev_wps, native_words_s=nat_wps,
                   batches=batches, profile=prof, block_max_abs_err=block_err,
                   block_bitwise_repeat=deterministic,
                   defaults_s=dflt_s, defaults_max_abs_err=dflt_err,
                   defaults_max_abs=scale, vocab=w.vocab_size())


def phase_doc2vec(card, dev):
    """14b: ParagraphVectors DBOW at ``bench_doc2vec``'s shape on the card,
    ``infer_vector`` card against CPU from the same state, a short DM
    run."""
    from deeplearning4j_torch.nlp import ParagraphVectors
    from deeplearning4j_torch.nlp.tokenization import LabelledDocument
    from deeplearning4j_torch.utils.convert import (sequence_vectors_from_jax,
                                                    sequence_vectors_state)

    texts = zipf_text(D2V["docs"], D2V["words"], D2V["vocab"], D2V["seed"])
    docs = [LabelledDocument(t, f"doc_{i}") for i, t in enumerate(texts)]
    total = D2V["docs"] * D2V["words"]
    kw = dict(layer_size=D2V["layer"], window=D2V["window"],
              min_word_frequency=D2V["min_freq"], negative=D2V["negative"],
              use_hierarchic_softmax=False, epochs=1, seed=D2V["model_seed"],
              backend="device")
    pv = ParagraphVectors(sequence_algorithm="dbow", device=dev, **kw)
    pv.build_vocab_from_documents(docs)
    pv.reset_weights()
    pv.fit(docs)                                   # warm
    pv.syn0 = None
    pv.reset_weights()
    t = time.perf_counter()
    pv.fit(docs)
    sync(dev)
    dbow_s = time.perf_counter() - t
    check(torch.isfinite(pv.syn0).all().item(), "14b: DBOW tables")
    cpu = sequence_vectors_from_jax(
        sequence_vectors_state(pv),
        ParagraphVectors(sequence_algorithm="dbow", device="cpu", **kw))
    infer_err = 0.0
    for d in docs[:8]:
        a = pv.infer_vector(d.content)
        c = cpu.infer_vector(d.content)
        infer_err = max(infer_err, float(np.max(np.abs(a - c))))
    label_gap = abs(pv.similarity_to_label(docs[0].content, "doc_0")
                    - cpu.similarity_to_label(docs[0].content, "doc_0"))
    check(infer_err <= 1e-6 and label_gap <= 1e-5,
          f"14b: infer_vector card vs CPU {infer_err:.3g}, "
          f"similarity_to_label {label_gap:.3g}")
    dm_docs = docs[:D2V["dm_docs"]]
    t = time.perf_counter()
    dm = ParagraphVectors(sequence_algorithm="dm", device=dev, **kw)
    dm.fit(dm_docs)
    sync(dev)
    dm_s = time.perf_counter() - t
    dm_cpu = ParagraphVectors(sequence_algorithm="dm", device="cpu", **kw)
    dm_cpu.fit(dm_docs)
    dm_err = max(table_err(getattr(dm, n), getattr(dm_cpu, n))
                 for n in ("syn0", "syn1neg"))
    check(dm_err <= NLP_TABLE_ATOL, f"14b: DM card vs CPU {dm_err:.3g}")
    log(f"  14b ParagraphVectors DBOW ({D2V['docs']} x {D2V['words']} over "
        f"{D2V['vocab']}, layer {D2V['layer']}, batch {pv.batch_size}): "
        f"{total / dbow_s:,.0f} words/s ({dbow_s:.2f} s); infer_vector card "
        f"vs CPU {infer_err:.3g}; DM on {len(dm_docs)} docs {dm_s:.2f} s, "
        f"card vs CPU {dm_err:.3g}; [{card}]")
    return dict(dbow_words_s=total / dbow_s, dbow_s=dbow_s,
                infer_max_abs_err=infer_err, dm_s=dm_s, dm_max_abs_err=dm_err)


def phase_glove(sents, card, dev):
    """14c: GloVe on 14a's first 5,000 sentences: ``fit`` on the card, then
    one epoch card against CPU from the same tables and key."""
    from deeplearning4j_torch.nlp import Glove
    from deeplearning4j_torch.nlp.glove import _glove_epoch
    from deeplearning4j_torch.ops import random as prandom

    sub = sents[:GLOVE["sentences"]]
    t = time.perf_counter()
    g = Glove(epochs=GLOVE["epochs"], device=dev).fit(sub)
    sync(dev)
    fit_s = time.perf_counter() - t
    check(torch.isfinite(g.syn0).all().item(), "14c: GloVe tables")
    t = time.perf_counter()
    cooc = g._cooccurrences(sub)
    count_s = time.perf_counter() - t

    def epoch(device):
        gg = Glove(device=device)
        gg.vocab = g.vocab
        tabs = gg.init_tables(g.vocab.num_words())
        wi, wj, logx, fx, B = gg.triples(cooc, device)
        key = prandom.fold_in(prandom.PRNGKey(gg.seed, device=device), 0)
        perm = prandom.permutation(key, wi.shape[0]).cpu()
        sync(device)
        t0 = time.perf_counter()
        _glove_epoch(*tabs, wi, wj, logx, fx, key, gg.learning_rate, 1e-8,
                     batch=B)
        sync(device)
        return tabs, perm, time.perf_counter() - t0, wi.shape[0] // B

    card_t, card_perm, epoch_s, nb = epoch(dev)
    cpu_t, cpu_perm, _, _ = epoch("cpu")
    check(torch.equal(card_perm, cpu_perm), "14c: the permutation differs")
    # W, Wc, b, bc and their AdaGrad sums: each over its own max (the
    # atomics order a hot row's many adds differently on the card)
    rel = [table_err(a, c) / max(float(c.abs().max()), 1e-30)
           for a, c in zip(card_t, cpu_t)]
    err = max(table_err(a, c) for a, c in zip(card_t, cpu_t))
    check(max(rel) <= GLOVE_EPOCH_REL,
          f"14c: an epoch card vs CPU {[f'{r:.3g}' for r in rel]} of each "
          f"table's max")
    log(f"  14c GloVe (layer {g.layer_size}, window {g.window}) on "
        f"{len(sub)} sentences: {len(cooc):,} co-occurrences counted in "
        f"{count_s:.2f} s; fit of {GLOVE['epochs']} epochs {fit_s:.2f} s; "
        f"one epoch ({nb} batches of {g.batch_size}) {epoch_s * 1e3:.1f} ms "
        f"on the card, permutation bitwise, tables card vs CPU {err:.3g} "
        f"({max(rel):.3g} of a table's max: W {rel[0]:.3g}, Wc "
        f"{rel[1]:.3g}, b {rel[2]:.3g}, bc {rel[3]:.3g}, sums "
        f"{max(rel[4:]):.3g}); [{card}]")
    return dict(fit_s=fit_s, count_s=count_s, epoch_ms=epoch_s * 1e3,
                batches=nb, triples=len(cooc), max_abs_err=err,
                max_rel_err=rel)


def two_communities(graph_cls):
    """2,000 vertices in two communities of 1,000: each vertex joins
    ``within`` random vertices of its own community, and ``bridges``
    random edges join the two (RandomState(seed))."""
    n, rs = DEEPWALK["vertices"], np.random.RandomState(DEEPWALK["seed"])
    half = n // 2
    edges = set()
    for v in range(n):
        base = 0 if v < half else half
        for u in rs.randint(base, base + half, DEEPWALK["within"]):
            if u != v:
                edges.add((min(u, v), max(u, v)))
    for _ in range(DEEPWALK["bridges"]):
        edges.add((int(rs.randint(0, half)), int(rs.randint(half, n))))
    return graph_cls.from_edges(n, sorted((int(a), int(b))
                                          for a, b in edges))


def phase_deepwalk(card, dev):
    """14d: DeepWalk at the paper's widths on a two-community graph."""
    from deeplearning4j_torch.graph import DeepWalk, Graph

    g = two_communities(Graph)
    dw = DeepWalk(vector_size=DEEPWALK["vector"], window=DEEPWALK["window"],
                  walk_length=DEEPWALK["walk_length"],
                  walks_per_vertex=DEEPWALK["walks"], device=dev,
                  seed=DEEPWALK["seed"])
    t = time.perf_counter()
    dw.fit(g)
    sync(dev)
    fit_s = time.perf_counter() - t
    check(torch.is_tensor(dw._sv.syn0) and torch.isfinite(
        dw._sv.syn0).all().item(), "14d: DeepWalk tables")
    rs = np.random.RandomState(1)
    half = DEEPWALK["vertices"] // 2
    a = rs.randint(0, half, 300)
    same = np.mean([dw.similarity(int(x), int(y))
                    for x, y in zip(a, rs.randint(0, half, 300))])
    cross = np.mean([dw.similarity(int(x), int(y))
                     for x, y in zip(a, rs.randint(half, 2 * half, 300))])
    check(same > cross, f"14d: same-community {same:.3f} <= cross "
          f"{cross:.3f}")
    tokens = DEEPWALK["vertices"] * DEEPWALK["walks"] * \
        DEEPWALK["walk_length"]
    edges = sum(g.degree(v) for v in range(g.num_vertices())) // 2
    log(f"  14d DeepWalk ({DEEPWALK['vertices']} vertices, {edges} edges; "
        f"vector {DEEPWALK['vector']}, window {DEEPWALK['window']}, "
        f"{DEEPWALK['walks']} walks of {DEEPWALK['walk_length']}): fit "
        f"{fit_s:.2f} s, the host's walks included ({tokens / fit_s:,.0f} "
        f"walk tokens/s); same-community similarity "
        f"{same:.3f} against cross {cross:.3f}; [{card}]")
    return dict(fit_s=fit_s, tokens=tokens,
                same_similarity=float(same), cross_similarity=float(cross))


class _Group:
    """A group of ``InMemoryH5``: ``attrs``, named members, ``in`` and
    item access (datasets are numpy arrays)."""

    def __init__(self, members: dict, attrs: dict):
        self.members = members
        self.attrs = attrs

    def __contains__(self, name):
        return name in self.members

    def __getitem__(self, name):
        return self.members[name]


class InMemoryH5(_Group):
    """What the Keras importers read of an HDF5 file, held in memory: the
    ``model_config`` attribute and, under ``model_weights``, one group per
    layer with its ``weight_names`` and arrays. Phase 14e's source for the
    importers where h5py is absent (they take any h5py-like object) (``weights``: ``{layer name: [(weight
    name, array), ...]}``); ``read`` copies an open h5py file."""

    def __init__(self, model_config, weights: dict):
        groups = {}
        for layer, arrays in weights.items():
            groups[layer] = _Group(
                {n: np.asarray(a) for n, a in arrays},
                {"weight_names": [n.encode() for n, _ in arrays]})
        cfg = model_config if isinstance(model_config, str) \
            else json.dumps(model_config)
        super().__init__({"model_weights": _Group(groups, {})},
                         {"model_config": cfg})

    @classmethod
    def read(cls, f) -> "InMemoryH5":
        root = f["model_weights"] if "model_weights" in f else f
        weights = {}
        for layer in root:
            names = root[layer].attrs.get("weight_names")
            if names is None:
                continue
            names = [n.decode() if isinstance(n, bytes) else str(n)
                     for n in names]
            weights[layer] = [(n, np.asarray(root[layer][n]))
                              for n in names]
        raw = f.attrs.get("model_config")
        return cls(raw.decode() if isinstance(raw, bytes) else raw, weights)


def keras_lenet_source():
    """A Keras-1 Sequential MNIST CNN at LeNet's widths (th ordering, true
    convolution) with numpy-seeded weights: its config, weights and an
    ``InMemoryH5`` holding both."""

    (c1, c2), k = KERAS_LENET["conv"], KERAS_LENET["kernel"]
    rs = np.random.RandomState(14)

    def w(*shape, scale):
        return (rs.randn(*shape) * scale).astype(np.float32)

    weights = {
        "conv1": [("conv1_W", w(c1, 1, k, k, scale=0.2)),
                  ("conv1_b", w(c1, scale=0.05))],
        "conv2": [("conv2_W", w(c2, c1, k, k, scale=0.05)),
                  ("conv2_b", w(c2, scale=0.05))],
        "dense1": [("dense1_W", w(c2 * 16, KERAS_LENET["dense"],
                                  scale=0.03)),
                   ("dense1_b", w(KERAS_LENET["dense"], scale=0.05))],
        "dense2": [("dense2_W", w(KERAS_LENET["dense"],
                                  KERAS_LENET["labels"], scale=0.5)),
                   ("dense2_b", w(KERAS_LENET["labels"], scale=0.05))]}
    conv = dict(nb_row=k, nb_col=k, subsample=[1, 1], border_mode="valid",
                activation="relu", dim_ordering="th")
    pool = dict(pool_size=[2, 2], strides=[2, 2], border_mode="valid",
                dim_ordering="th")
    config = {"class_name": "Sequential", "config": [
        {"class_name": "Convolution2D", "config": dict(
            name="conv1", nb_filter=c1, batch_input_shape=[None, 1, 28, 28],
            **conv)},
        {"class_name": "MaxPooling2D", "config": dict(name="pool1", **pool)},
        {"class_name": "Convolution2D", "config": dict(name="conv2",
                                                       nb_filter=c2,
                                                       **conv)},
        {"class_name": "MaxPooling2D", "config": dict(name="pool2", **pool)},
        {"class_name": "Flatten", "config": {"name": "flat"}},
        {"class_name": "Dense", "config": {
            "name": "dense1", "output_dim": KERAS_LENET["dense"],
            "activation": "relu"}},
        {"class_name": "Dense", "config": {
            "name": "dense2", "output_dim": KERAS_LENET["labels"],
            "activation": "softmax"}}]}
    return config, weights, InMemoryH5(config, weights)


def keras_residual_source():
    """A functional model in the Keras-1/2 inbound format: conv -> conv ->
    Add (residual) -> relu -> 1x1 conv -> Concatenate -> Dense."""

    rs = np.random.RandomState(15)

    def w(*shape):
        return (rs.randn(*shape) * 0.3).astype(np.float32)

    def conv(name, n, k, inbound, act="linear"):
        return {"class_name": "Conv2D", "name": name, "config": {
            "name": name, "filters": n, "kernel_size": [k, k],
            "strides": [1, 1], "padding": "same", "activation": act,
            "data_format": "channels_last"},
            "inbound_nodes": [[[i, 0, 0] for i in inbound]]}

    layers = [
        {"class_name": "InputLayer", "name": "in0", "config": {
            "name": "in0", "batch_input_shape": [None, 8, 8, 3]},
         "inbound_nodes": []},
        conv("c1", 4, 3, ["in0"], "relu"), conv("c2", 4, 3, ["c1"]),
        {"class_name": "Add", "name": "add1", "config": {"name": "add1"},
         "inbound_nodes": [[["c1", 0, 0], ["c2", 0, 0]]]},
        {"class_name": "Activation", "name": "act1", "config": {
            "name": "act1", "activation": "relu"},
         "inbound_nodes": [[["add1", 0, 0]]]},
        conv("c3", 2, 1, ["act1"]),
        {"class_name": "Concatenate", "name": "cat1", "config": {
            "name": "cat1", "axis": -1},
         "inbound_nodes": [[["act1", 0, 0], ["c3", 0, 0]]]},
        {"class_name": "Flatten", "name": "fl", "config": {"name": "fl"},
         "inbound_nodes": [[["cat1", 0, 0]]]},
        {"class_name": "Dense", "name": "d1", "config": {
            "name": "d1", "units": 5, "activation": "softmax"},
         "inbound_nodes": [[["fl", 0, 0]]]}]
    weights = {"c1": [("c1_W", w(3, 3, 3, 4)), ("c1_b", w(4))],
               "c2": [("c2_W", w(3, 3, 4, 4)), ("c2_b", w(4))],
               "c3": [("c3_W", w(1, 1, 4, 2)), ("c3_b", w(2))],
               "d1": [("d1_W", w(8 * 8 * 6, 5) * 0.2), ("d1_b", w(5))]}
    config = {"class_name": "Model", "config": {
        "name": "residual", "layers": layers,
        "input_layers": [["in0", 0, 0]], "output_layers": [["d1", 0, 0]]}}
    return weights, InMemoryH5(config, weights)


def np_softmax(z):
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def np_lenet(x_nchw, weights):
    """The Keras-1 th forward in f64 numpy: true convolution (flipped
    kernels) over NCHW, 2x2 max pooling, the (c, h, w) flatten."""
    from numpy.lib.stride_tricks import sliding_window_view

    def conv(x, k, b):
        win = sliding_window_view(x, k.shape[2:], axis=(2, 3))
        out = np.einsum("bchwij,ocij->bohw", win, k[:, :, ::-1, ::-1])
        return np.maximum(out + b[None, :, None, None], 0)

    def pool(x):
        B, C, H, W = x.shape
        return x.reshape(B, C, H // 2, 2, W // 2, 2).max(axis=(3, 5))

    p = {n: a.astype(np.float64) for ws in weights.values() for n, a in ws}
    h = pool(conv(x_nchw, p["conv1_W"], p["conv1_b"]))
    h = pool(conv(h, p["conv2_W"], p["conv2_b"]))
    h = np.maximum(h.reshape(h.shape[0], -1) @ p["dense1_W"]
                   + p["dense1_b"], 0)
    return np_softmax(h @ p["dense2_W"] + p["dense2_b"])


def np_residual(x, weights):
    """The functional model's forward in f64 numpy (NHWC, 'same'
    cross-correlation)."""
    from numpy.lib.stride_tricks import sliding_window_view

    p = {n: a.astype(np.float64) for ws in weights.values() for n, a in ws}

    def conv(h, k, b):
        r = k.shape[0] // 2
        hp = np.pad(h, ((0, 0), (r, r), (r, r), (0, 0)))
        win = sliding_window_view(hp, k.shape[:2], axis=(1, 2))
        return np.einsum("bhwcij,ijco->bhwo", win, k) + b

    c1 = np.maximum(conv(x, p["c1_W"], p["c1_b"]), 0)
    act = np.maximum(c1 + conv(c1, p["c2_W"], p["c2_b"]), 0)
    cat = np.concatenate([act, conv(act, p["c3_W"], p["c3_b"])], axis=-1)
    return np_softmax(cat.reshape(x.shape[0], -1) @ p["d1_W"] + p["d1_b"])


def phase_keras(w2v, card, dev):
    """14e: Keras import onto the card (a Keras-1 LeNet, a residual /
    concat functional model, int8), ``/import`` then ``/predict`` and
    ``/fit`` over HTTP, and ``load_model_guess`` on each format; the files
    live in a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        return keras_checks(w2v, card, dev, tmp)


def keras_checks(w2v, card, dev, tmp):
    import importlib.util
    import urllib.error
    import urllib.request

    from deeplearning4j_torch.modelimport import (
        import_keras_model_and_weights,
        import_keras_sequential_model_and_weights)
    from deeplearning4j_torch.modelimport.server import KerasBackendServer
    from deeplearning4j_torch.nlp.sequence_vectors import host
    from deeplearning4j_torch.nlp.serde import (write_word2vec_binary,
                                                write_word_vectors_text)
    from deeplearning4j_torch.utils.model_guesser import (guess_format,
                                                          load_model_guess)
    from deeplearning4j_torch.utils.model_serializer import save_model

    has_h5py = importlib.util.find_spec("h5py") is not None
    log(f"  14e: h5py {'present: the Keras files are written as .h5' if has_h5py else 'absent on this machine: the importers read an InMemoryH5 source (the HDF5 read is CPU-tested)'}")
    config, lw, lenet_mem = keras_lenet_source()
    rw, res_mem = keras_residual_source()
    lenet_src, res_src = lenet_mem, res_mem
    if has_h5py:
        import h5py

        for name, (cfg, ws) in (("lenet", (config, lw)),
                                ("residual", (json.loads(
                                    res_mem.attrs["model_config"]), rw))):
            path = os.path.join(tmp, f"{name}.h5")
            with h5py.File(path, "w") as f:
                f.attrs["model_config"] = json.dumps(cfg)
                mw = f.create_group("model_weights")
                for layer, arrays in ws.items():
                    g = mw.create_group(layer)
                    g.attrs["weight_names"] = [n.encode() for n, _ in arrays]
                    for n, a in arrays:
                        g.create_dataset(n, data=a)
            if name == "lenet":
                lenet_src = path
            else:
                res_src = path
    from deeplearning4j_torch.datasets.mnist import synthetic_mnist

    rs = np.random.RandomState(16)
    x = np.ascontiguousarray(synthetic_mnist(
        KERAS_LENET["batch"], seed=16).features.reshape(-1, 28, 28, 1),
        np.float32)
    x_nchw = np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))
    t = time.perf_counter()
    lenet = import_keras_sequential_model_and_weights(lenet_src, device=dev)
    import_s = time.perf_counter() - t
    lenet_cpu = import_keras_sequential_model_and_weights(lenet_src,
                                                          device="cpu")
    with torch.no_grad():
        out = host(lenet.output(x))
        out_cpu = host(lenet_cpu.output(x))
    ref = np_lenet(x_nchw.astype(np.float64), lw)
    lenet_err, lenet_np = float(np.max(np.abs(out - out_cpu))), \
        float(np.max(np.abs(out - ref)))
    check(next(iter(lenet.params["0"].values())).device.type ==
          torch.device(dev).type and lenet_err <= 1e-5 and lenet_np <= 1e-4,
          f"14e: LeNet card vs CPU {lenet_err:.3g}, vs numpy {lenet_np:.3g}")
    xr = rs.randn(16, 8, 8, 3).astype(np.float32)
    res = import_keras_model_and_weights(res_src, device=dev)
    res_cpu = import_keras_model_and_weights(res_src, device="cpu")
    with torch.no_grad():
        r_out, r_cpu = host(res.output(xr)), host(res_cpu.output(xr))
    res_err = float(np.max(np.abs(r_out - r_cpu)))
    res_np = float(np.max(np.abs(r_out - np_residual(
        xr.astype(np.float64), rw))))
    check(type(res).__name__ == "ComputationGraph" and res_err <= 1e-5
          and res_np <= 1e-4, f"14e: functional card vs CPU {res_err:.3g}, "
          f"vs numpy {res_np:.3g}")
    q = import_keras_sequential_model_and_weights(lenet_src, quantize="int8",
                                                  device=dev)
    q_cpu = import_keras_sequential_model_and_weights(
        lenet_src, quantize="int8", device="cpu")
    with torch.no_grad():
        q_out, q_cpu_out = host(q.output(x)), host(q_cpu.output(x))
    q_err = float(np.max(np.abs(q_out - q_cpu_out)))
    flips = q_out.argmax(1) != out.argmax(1)
    top2 = np.sort(out, axis=1)[:, -2:]
    moved = np.max(np.abs(q_out - out), axis=1)
    changed = float(np.mean(flips))
    # a prediction may change only where int8 moved the row by at least
    # half its top-2 gap (untrained weights leave near-ties)
    check(q_err <= 1e-5 and changed <= 0.05
          and np.all(2 * moved[flips] >= (top2[:, 1] - top2[:, 0])[flips]),
          f"14e: int8 card vs CPU {q_err:.3g}, {changed:.3f} of the "
          f"predictions changed")

    srv = KerasBackendServer(device=dev)
    try:
        base = f"http://127.0.0.1:{srv.start()}"

        def post(path, body):
            req = urllib.request.Request(
                base + path, json.dumps(body).encode(),
                {"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=300) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        if has_h5py:
            status, body = post("/import", {"path": lenet_src})
            check(status == 200, f"14e: /import {status} {body}")
            mid = body["model"]
            fit_mid = post("/import", {"path": lenet_src})[1]["model"]
        else:
            status, body = post("/import", {"path": os.path.join(
                tmp, "lenet.h5")})
            check(status == 500 and "h5py" in body.get("error", ""),
                  f"14e: /import without h5py: {status} {body}")
            mid = srv.import_model(lenet_mem)
            fit_mid = srv.import_model(lenet_mem)
        status, body = post("/predict", {"model": mid,
                                         "features": x[:16].tolist()})
        with torch.no_grad():
            want = host(lenet.output(x[:16]))
        # bit for bit on the card; a CPU rehearsal's HTTP thread runs
        # another thread pool, whose sums round apart
        tol = 0.0 if torch.device(dev).type == "cuda" else 1e-5
        check(status == 200 and np.max(np.abs(np.asarray(
            body["output"], np.float32) - want)) <= tol,
            f"14e: /predict {status}, rows differ from output()")
        labels = np.eye(KERAS_LENET["labels"], dtype=np.float32)[
            rs.randint(0, KERAS_LENET["labels"], (2, 32))]
        paths = []
        for i in range(2):
            p = os.path.join(tmp, f"b{i}.npz")
            np.savez(p, features=x[i * 32:(i + 1) * 32], labels=labels[i])
            paths.append(p)
        status, body = post("/fit", {"model": fit_mid, "batches": paths})
        ref_net = import_keras_sequential_model_and_weights(lenet_src,
                                                            device=dev)
        ref_scores = direct_fit(ref_net, paths)
        check(status == 200 and body["iterations"] == 2
              and abs(body["score"] - ref_scores[-1]) <= tol,
              f"14e: /fit {status} {body} against direct fit {ref_scores}")
    finally:
        srv.stop()

    zp = os.path.join(tmp, "lenet.zip")
    save_model(lenet, zp)
    bp, tp = os.path.join(tmp, "v.bin"), os.path.join(tmp, "v.txt")
    write_word2vec_binary(w2v, bp)
    write_word_vectors_text(w2v, tp)
    hp = lenet_src if has_h5py else os.path.join(tmp, "sig.h5")
    if not has_h5py:
        with open(hp, "wb") as f:
            f.write(b"\x89HDF\r\n\x1a\n" + bytes(56))
    kinds = {zp: "dl4j-zip", bp: "word2vec-binary", tp: "word-vectors-text",
             hp: "keras-h5"}
    for p, kind in kinds.items():
        check(guess_format(p) == kind, f"14e: guess_format {p} != {kind}")
    with torch.no_grad():
        check(np.array_equal(host(load_model_guess(zp, device=dev)
                                  .output(x)), out),
              "14e: load_model_guess(zip) output differs")
    syn0 = host(w2v.syn0)
    words, vecs = load_model_guess(bp)
    check(np.array_equal(vecs, syn0[:len(words)]), "14e: binary vectors")
    words_t, vecs_t = load_model_guess(tp)
    check(words_t == words and np.max(np.abs(vecs_t - vecs)) <= 1e-6,
          "14e: text vectors")
    if has_h5py:
        with torch.no_grad():
            check(np.array_equal(host(load_model_guess(hp, device=dev)
                                      .output(x)), out),
                  "14e: load_model_guess(h5) output differs")
    log(f"  14e Keras: LeNet ({KERAS_LENET['conv']} @ 5x5, "
        f"{KERAS_LENET['dense']}, {KERAS_LENET['labels']}) imported in "
        f"{import_s * 1e3:.1f} ms, card vs CPU {lenet_err:.3g}, vs numpy "
        f"{lenet_np:.3g}; residual/concat graph card vs CPU {res_err:.3g}, "
        f"vs numpy {res_np:.3g}; int8 card vs CPU {q_err:.3g}, "
        f"{changed:.3f} of the predictions changed; /predict bitwise "
        f"output(), /fit bitwise a direct fit; guessed {len(kinds)} formats"
        f"{'' if has_h5py else ' (the .h5 by its signature only)'}; "
        f"[{card}]")
    return dict(h5py=has_h5py, import_ms=import_s * 1e3,
                lenet_max_abs_err=lenet_err, lenet_numpy_err=lenet_np,
                residual_max_abs_err=res_err, residual_numpy_err=res_np,
                int8_max_abs_err=q_err, int8_changed=changed)


def phase_nlp(card, dev="cuda"):
    """Phase 14: the NLP embedding stack, DeepWalk and Keras import
    (14a-14e)."""
    t0 = time.perf_counter()
    log("phase 14a: Word2Vec at the JAX bench leg (device, native), then "
        "the class defaults")
    w2v, wv = phase_word2vec(card, dev)
    log("phase 14b: ParagraphVectors DBOW at bench_doc2vec's shape, "
        "infer_vector, DM")
    d2v = phase_doc2vec(card, dev)
    log("phase 14c: GloVe")
    # 14a's first sentences: RandomState's Zipf draws are sequential
    sents = zipf_text(GLOVE["sentences"], W2V["words"], W2V["vocab"],
                      W2V["seed"])
    glove = phase_glove(sents, card, dev)
    log("phase 14d: DeepWalk on a two-community graph")
    deepwalk = phase_deepwalk(card, dev)
    log("phase 14e: Keras import, /import, /predict, /fit, the guesser")
    keras = phase_keras(w2v, card, dev)
    wall = time.perf_counter() - t0
    log(f"  phase 14: {wall:.1f} s; [{card}]")
    return dict(word2vec=wv, doc2vec=d2v, glove=glove, deepwalk=deepwalk,
                keras=keras, wall_s=wall)


# ---------------------------------------------------------------- phase 15
#: 15a: MNIST's test set as the CSV users download (the label, then 784
#: integer pixels; 10,000 rows) read in batches of 128 into one epoch of
#: examples/mnist_mlp.py's net; phase 11c's synthetic-control series as
#: one CSV per sequence (600 files) in batches of 30 into its graph net
MNIST_CSV = dict(rows=10_000, batch=128, classes=10)
#: 15b: examples/streaming_training.py at its full size (400 batches of
#: 64 from a producer process, the route buffering 8); the consumer of a
#: producer that stops without END waits ``stall_timeout_s``
STREAM = dict(batches=400, batch=64, buffer=8, stall_timeout_s=1.0,
              stall_frames=3)
#: 15c: the phase-7c model through ``fit`` for 40 steps under
#: ``StatsListener`` (a report every 10, histograms on); ms a step from
#: marginal windows of ``window`` against ``2 * window`` steps; the legacy
#: listeners on bench.py's LeNet (``bench_lenet``: batch 512)
UI = dict(steps=40, frequency=10, distinct=10, window=10, windows=2,
          lenet_batch=512, lenet_steps=4)
#: the CSV's MNIST pixels are scaled to [0, 1] before the net, the same
#: division on both sides of the bitwise gate
PIXEL_SCALE = np.float32(255)


def mnist_csv(path):
    """The port's synthetic MNIST test set written as the CSV users
    download: the label, then 784 integer pixels, an image a row. Returns
    the written pixels (f32) and labels."""
    from deeplearning4j_torch.datasets.mnist import MnistDataSetIterator

    n = MNIST_CSV["rows"]
    it = MnistDataSetIterator(batch_size=n, train=False, num_examples=n)
    check(it.synthetic, "15a: MNIST files were found; the phase runs on the "
                        "synthetic set")
    ds = next(iter(it))
    pix = np.rint(ds.features * 255).astype(np.int64)
    lab = ds.labels.argmax(1)
    np.savetxt(path, np.column_stack([lab, pix]), fmt="%d", delimiter=",")
    return pix.astype(np.float32), lab


def mnist_mlp(dev):
    """examples/mnist_mlp.py's net: 784-256-128-10, Adam 1e-3, seed 123."""
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers.core import (DenseLayer,
                                                          OutputLayer)
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.nn.updater import Adam

    conf = (NeuralNetConfiguration.builder().seed(123)
            .updater(Adam(learning_rate=1e-3))
            .list(DenseLayer(n_out=256, activation="relu"),
                  DenseLayer(n_out=128, activation="relu"),
                  OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional_flat(28, 28, 1)).build())
    return MultiLayerNetwork(conf).init(device=dev)


def scaled(batches):
    from deeplearning4j_torch.datasets.dataset import DataSet

    for ds in batches:
        yield DataSet(ds.features / PIXEL_SCALE, ds.labels)


def timed_fit(net, data, dev):
    """Wall seconds of ``net.fit(data)``, the loss fetched and the device
    synced."""
    sync(dev)
    t0 = time.perf_counter()
    net.fit(data)
    float(net.score())
    sync(dev)
    return time.perf_counter() - t0


class WindowProfile:
    """Device busy share of the steps that take the last ``n`` batches of a
    stream of ``total`` under ``torch.profiler`` (``wrap`` the stream
    handed to ``fit``; the fused fit pulls a block's batches ahead, so the
    window is that many steps give or take one block). Profiling only a
    window keeps the trace small: a whole 400-step stream's takes tens of
    seconds to read. The window comes last so that the steps before it
    run as they would unprofiled: ``before_s`` is the time from asking
    for the first batch to the window, ``result`` the window's wall and busy seconds,
    idle share and launches a step."""

    def __init__(self, total, n, dev):
        n = min(n, total // 2)
        self.start, self.n, self.dev = total - n, n, dev
        self.prof = self.result = None

    def wrap(self, batches):
        from torch.profiler import ProfilerActivity, profile

        t_first = time.perf_counter()         # the first batch is asked
        for i, ds in enumerate(batches):
            if i == self.start:
                self.before_s = time.perf_counter() - t_first
                sync(self.dev)
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.t0 = time.perf_counter()
            yield ds
        if self.prof is not None:
            sync(self.dev)
            wall = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)
            busy_s, launches, top = profile_table(self.prof, None, None, "")
            self.result = dict(wall_s=wall, device_busy_s=busy_s,
                               busy_share=busy_s / wall,
                               idle_share=1 - busy_s / wall, steps=self.n,
                               kernel_launches_per_step=launches / self.n,
                               top=top[:6])


def phase_csv_mnist(card, dev, tmp):
    """15a (i): the MNIST CSV through ``CSVRecordReader`` (the native
    parser) and ``RecordReaderDataSetIterator`` into one epoch of the MLP:
    every batch bitwise the written arrays, the epoch's parameters bitwise
    a fit from the same batches in memory; rows/s of the reader and of the
    iterator, images/s of both fits (the CSV fit's up to a profiled
    window of its last 16 steps) and that window's idle share."""
    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.datavec import (CSVRecordReader,
                                              RecordReaderDataSetIterator)

    path = os.path.join(tmp, "mnist_test.csv")
    t0 = time.perf_counter()
    pix, lab = mnist_csv(path)
    write_s = time.perf_counter() - t0
    n, B, C = len(lab), MNIST_CSV["batch"], MNIST_CSV["classes"]
    eye = np.eye(C, dtype=np.float32)
    steps = -(-n // B)

    def csv_batches():
        return RecordReaderDataSetIterator(CSVRecordReader(path), B,
                                           label_index=0, num_classes=C)

    reader = CSVRecordReader(path)
    check(reader.read_numeric() is not None,
          "15a: the MNIST CSV did not take the native parser")
    t0 = time.perf_counter()
    rows = sum(1 for _ in reader)
    reader_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seen, bad = 0, []
    for i, ds in enumerate(csv_batches()):
        s = slice(i * B, (i + 1) * B)
        if not (ds.features.dtype == ds.labels.dtype == np.float32
                and np.array_equal(ds.features, pix[s])
                and np.array_equal(ds.labels, eye[lab[s]])):
            bad.append(i)
        seen += len(ds.features)
    iter_s = time.perf_counter() - t0
    check(rows == seen == n and not bad,
          f"15a: {rows} rows read, {seen} in batches, batches {bad} differ "
          f"from the written arrays")

    memory = [DataSet(pix[i:i + B] / PIXEL_SCALE, eye[lab[i:i + B]])
              for i in range(0, n, B)]
    mnist_mlp(dev).fit(memory[:8])        # warm: the shapes' first calls
    mem_net, csv_net = mnist_mlp(dev), mnist_mlp(dev)
    mem_s = timed_fit(mem_net, memory, dev)
    window = WindowProfile(steps, 16, dev)
    csv_s = timed_fit(csv_net, window.wrap(scaled(csv_batches())), dev)
    prof = window.result
    # images/s of the steps before the profiled window
    csv_rate = window.start * B / window.before_s
    bitwise = same_params(mem_net, csv_net)
    check(mem_net.iteration == csv_net.iteration == steps and bitwise[0],
          f"15a: the MLP's epoch from the CSV vs from memory: iterations "
          f"{csv_net.iteration}/{mem_net.iteration}, bitwise {bitwise}")
    loss = float(csv_net.score())
    log(f"  15a MNIST CSV ({n} rows, {os.path.getsize(path)} bytes, written "
        f"in {write_s:.2f} s): reader {rows / reader_s:.0f} rows/s (native "
        f"parser), iterator {n / iter_s:.0f} rows/s, every batch bitwise "
        f"the written arrays; one epoch ({steps} steps of {B}) "
        f"{csv_rate:.0f} images/s from the CSV (the {window.start} steps "
        f"before the profiled window) vs {n / mem_s:.0f} from memory, "
        f"parameters bitwise; idle {prof['idle_share']:.3f} over the last "
        f"{prof['steps']} steps of the CSV fit, "
        f"{prof['kernel_launches_per_step']:.1f} launches a step; loss "
        f"{loss:.4f}; [{card}]")
    return dict(rows=n, csv_bytes=os.path.getsize(path), write_s=write_s,
                reader_rows_s=rows / reader_s, iterator_rows_s=n / iter_s,
                batches_bitwise=not bad, steps=steps, csv_images_s=csv_rate,
                memory_images_s=n / mem_s,
                fit_bitwise=bitwise[0], loss=loss, profile=prof)


def phase_csv_sequences(card, dev, tmp):
    """15a (ii): phase 11c's 600 synthetic-control series as one CSV per
    sequence (the values, then the label), read by
    ``CSVSequenceRecordReader`` and ``SequenceRecordReaderDataSetIterator``
    (batch 30, 6 classes): every batch bitwise the one JAX's iterator
    builds (computed here with numpy: padded at the end to the batch's
    longest, masked, the one-hot labels masked), and one epoch of 11c's
    graph net bitwise the same epoch from those arrays in memory."""
    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.datavec import (
        CSVSequenceRecordReader, SequenceRecordReaderDataSetIterator)
    from deeplearning4j_torch.nn.graph import ComputationGraph

    train, test = uci_data()
    x = np.concatenate([b[0] for b in train + test])[..., 0]
    cls = np.concatenate([b[1] for b in train + test]).argmax(1)
    lengths = np.concatenate([b[2] for b in train + test]).sum(1).astype(int)
    N, B, C = len(cls), UCI["batch"], UCI["classes"]
    d = os.path.join(tmp, "uci")
    os.makedirs(d)
    for i in range(N):
        with open(os.path.join(d, f"{i:04d}.csv"), "w") as f:
            f.write("".join(f"{float(v)!r},{cls[i]}\n"
                            for v in x[i, :lengths[i]]))
    eye = np.eye(C, dtype=np.float32)
    want = []
    for s in range(0, N, B):
        L = lengths[s:s + B]
        T = int(L.max())
        m = (np.arange(T)[None] < L[:, None]).astype(np.float32)
        xb = (x[s:s + B, :T] * m)[..., None]
        yb = eye[cls[s:s + B]][:, None, :] * m[..., None]
        want.append(DataSet(xb.astype(np.float32), yb, m, m))

    def csv_batches():
        return SequenceRecordReaderDataSetIterator(
            CSVSequenceRecordReader(d), B, num_classes=C)

    t0 = time.perf_counter()
    got = list(csv_batches())
    iter_s = time.perf_counter() - t0
    names = ("features", "labels", "features_mask", "labels_mask")
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if not all(getattr(a, k).dtype == getattr(b, k).dtype
                      and np.array_equal(getattr(a, k), getattr(b, k))
                      for k in names)]
    check(len(got) == len(want) and not bad,
          f"15a: sequence batches {bad} of {len(got)} differ from the numpy "
          f"build")
    mem_net = ComputationGraph(uci_conf("graph")).init(device=dev)
    csv_net = ComputationGraph(uci_conf("graph")).init(device=dev)
    mem_s = timed_fit(mem_net, want, dev)
    csv_s = timed_fit(csv_net, csv_batches(), dev)
    bitwise = same_params(mem_net, csv_net)
    check(mem_net.iteration == csv_net.iteration == len(want) and bitwise[0],
          f"15a: the sequence net's epoch from the CSVs vs from memory: "
          f"iterations {csv_net.iteration}/{mem_net.iteration}, bitwise "
          f"{bitwise}")
    log(f"  15a synthetic control ({N} CSV files, lengths "
        f"{lengths.min()}..{lengths.max()}): iterator {N / iter_s:.0f} "
        f"sequences/s, every batch bitwise the numpy build; one epoch "
        f"({len(want)} steps of {B}) {N / csv_s:.0f} sequences/s from the "
        f"CSVs vs {N / mem_s:.0f} from memory, parameters bitwise; "
        f"[{card}]")
    return dict(sequences=N, iterator_seqs_s=N / iter_s,
                batches_bitwise=not bad, steps=len(want),
                csv_seqs_s=N / csv_s, memory_seqs_s=N / mem_s,
                fit_bitwise=bitwise[0])


def spiral_batches(n, batch, seed=0):
    """examples/streaming_training.py's producer stream: a two-class
    spiral from ``RandomState(seed)``, as (features, one-hot labels)."""
    rs = np.random.RandomState(seed)
    for _ in range(n):
        theta = rs.rand(batch) * 3 * np.pi
        cls = rs.randint(0, 2, batch)
        r = theta / (3 * np.pi)
        x = np.stack([r * np.cos(theta + np.pi * cls),
                      r * np.sin(theta + np.pi * cls)], 1)
        x = (x + rs.randn(batch, 2) * 0.02).astype(np.float32)
        yield x, np.eye(2, dtype=np.float32)[cls]


def spiral_net(dev):
    """examples/streaming_training.py's net: 2-64-64-2, Adam 3e-3."""
    from deeplearning4j_torch.nn.conf.builders import NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.conf.layers.core import (DenseLayer,
                                                          OutputLayer)
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.nn.updater import Adam

    conf = (NeuralNetConfiguration.builder().seed(7)
            .updater(Adam(learning_rate=3e-3))
            .list(DenseLayer(n_out=64, activation="relu"),
                  DenseLayer(n_out=64, activation="relu"),
                  OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(2)).build())
    return MultiLayerNetwork(conf).init(device=dev)


#: the producer process: the publisher client and numpy (and this file's
#: stream), never the model
_SPIRAL_PRODUCER = r"""
import sys
sys.path.insert(0, sys.argv[4])
from chip_smoke import spiral_batches
from deeplearning4j_torch.streaming import NDArrayPublisher

port, n, batch = (int(a) for a in sys.argv[1:4])
with NDArrayPublisher("127.0.0.1", port, "spiral") as pub:
    print("producer: ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        sys.exit(3)
    for x, y in spiral_batches(n, batch):
        pub.publish_arrays(x, y)
    pub.end()
print("producer: published", n, "batches", flush=True)
"""


def start_producer(broker):
    """The 15b producer process, started ahead of its part (its imports
    take seconds): it connects to ``broker``, says it is ready and
    publishes once told to go."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    root = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-c", _SPIRAL_PRODUCER, str(broker.port),
         str(STREAM["batches"]), str(STREAM["batch"]), root], env=env,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def phase_streaming(card, dev, broker, producer):
    """15b: examples/streaming_training.py at its full size: a producer
    process publishes 400 spiral batches of 64 to an in-process broker, an
    ``NDArrayRoute(buffer_batches=8)`` feeds ``fit`` on the card. Gates:
    400 iterations, no frame dropped, held-out accuracy over 0.85, the
    parameters bitwise a fit on the same batches from memory, and a
    consumer whose producer stops without END raising ``StreamStalled``
    within its idle timeout. Batches/s is of the fit from its first
    batch's arrival to a profiled window of its last 40 steps, which
    gives the idle share."""
    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.streaming import (NDArrayConsumer,
                                                NDArrayPublisher,
                                                NDArrayRoute, StreamStalled)

    N, Bs = STREAM["batches"], STREAM["batch"]
    net, ref = spiral_net(dev), spiral_net(dev)
    # warm the card before subscribing: a consumer that stalls past the
    # broker's 0.5 s patience loses frames by design
    net.output(np.zeros((1, 2), np.float32))
    spiral_net(dev).fit([DataSet(x, y) for x, y in spiral_batches(8, Bs, 1)])
    sync(dev)
    ready = producer.stdout.readline()
    check(ready.startswith("producer: ready"),
          f"15b: the producer did not start: {ready!r} "
          f"{producer.stderr.read()[-2000:] if producer.poll() else ''}")
    route = NDArrayRoute("127.0.0.1", broker.port, "spiral",
                         buffer_batches=STREAM["buffer"])

    def unblock_on_producer_crash():
        if producer.wait() != 0:
            route.iterator().end()

    threading.Thread(target=unblock_on_producer_crash, daemon=True).start()
    t0 = time.perf_counter()
    producer.stdin.write("go\n")
    producer.stdin.flush()
    stream = iter(route.iterator())
    first = next(stream, None)
    first_s = time.perf_counter() - t0
    check(first is not None, "15b: the stream ended before its first batch")

    def with_first():
        yield first
        yield from stream

    window = WindowProfile(N, N // 10, dev)
    timed_fit(net, window.wrap(with_first()), dev)
    prof = window.result
    out, err = producer.communicate(timeout=120)
    check(producer.returncode == 0 and f"published {N}" in out,
          f"15b: the producer failed: {err[-2000:]}")
    route.join(10)
    stats = broker.stats()

    # a producer that stops without END: the consumer fails typed
    cons = NDArrayConsumer("127.0.0.1", broker.port, "cut",
                           idle_timeout_s=STREAM["stall_timeout_s"])
    with NDArrayPublisher("127.0.0.1", broker.port, "cut") as pub:
        for x, y in spiral_batches(STREAM["stall_frames"], Bs, 2):
            pub.publish_arrays(x, y)
    got, stalled = 0, False
    t0 = time.perf_counter()
    try:
        for _ in cons:
            got += 1
    except StreamStalled:
        stalled = True
    stall_s = time.perf_counter() - t0
    cons.close()
    check(net.iteration == N, f"15b: {net.iteration} iterations from the "
                              f"stream, expected {N}")
    check(stats["frames_dropped"] == 0 and
          stats["subscribers_disconnected"] == 0,
          f"15b: the broker dropped frames: {stats}")
    check(stalled and got == STREAM["stall_frames"]
          and stall_s < STREAM["stall_timeout_s"] + 5.0,
          f"15b: a producer that stopped without END: stalled {stalled} "
          f"after {got} frames and {stall_s:.2f} s")
    rs = np.random.RandomState(9)
    theta = rs.rand(512) * 3 * np.pi
    cls = rs.randint(0, 2, 512)
    r = theta / (3 * np.pi)
    xt = np.stack([r * np.cos(theta + np.pi * cls),
                   r * np.sin(theta + np.pi * cls)], 1).astype(np.float32)
    out_t = net.output(xt)
    check(out_t.device.type == torch.device(dev).type,
          f"15b: output on {out_t.device}")
    acc = float((out_t.cpu().numpy().argmax(1) == cls).mean())
    check(acc > 0.85, f"15b: held-out accuracy {acc:.4f}")
    mem_s = timed_fit(ref, [DataSet(x, y)
                            for x, y in spiral_batches(N, Bs)], dev)
    bitwise = same_params(net, ref)
    check(bitwise[0], f"15b: the streamed fit vs the same batches from "
                      f"memory: {bitwise}")
    rate = window.start / window.before_s
    log(f"  15b streaming: {N} batches of {Bs} from a producer process "
        f"(first batch {first_s * 1e3:.1f} ms after go) through the broker "
        f"and NDArrayRoute(buffer_batches={STREAM['buffer']}) into fit: "
        f"{rate:.0f} batches/s over the {window.start} steps before the "
        f"profiled window ({N / mem_s:.0f} from memory), idle {prof['idle_share']:.3f} over the last "
        f"{prof['steps']} steps, {prof['kernel_launches_per_step']:.1f} "
        f"launches a step; {stats['frames_dropped']} frames dropped; "
        f"held-out accuracy {acc:.4f}; parameters bitwise the fit from "
        f"memory; StreamStalled after {got} frames and {stall_s:.2f} s "
        f"(idle timeout {STREAM['stall_timeout_s']} s); [{card}]")
    return dict(batches=N, batch=Bs, first_batch_s=first_s, batches_s=rate,
                memory_batches_s=N / mem_s, profile=prof, broker=stats,
                accuracy=acc, fit_bitwise=bitwise[0],
                stalled_after_frames=got, stall_s=stall_s)


def http_json(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        check(r.status == 200, f"15c: GET {path} answered {r.status}")
        return json.loads(r.read())


def marginal_fit_ms(net, stream, dev):
    """ms a step of ``fit``: the median of ``UI["windows"]`` windows, each
    the time of a fit of 2n batches less that of n (n = UI["window"])."""
    n = UI["window"]
    windows = []
    for _ in range(UI["windows"]):
        t1 = timed_fit(net, stream[:n], dev)
        t2 = timed_fit(net, stream[:2 * n], dev)
        windows.append((t2 - t1) / n * 1e3)
    return float(np.median(windows)), windows


def phase_ui(card, dev, tmp):
    """15c part 1: the phase-7c model (the JAX bench leg's bf16
    TransformerLM at [32, 512]) through ``fit`` at its defaults for 40
    steps under ``StatsListener(reporting_frequency=10,
    collect_histograms=True)`` writing a ``FileStatsStorage``: parameters
    bitwise the same fit without the listener, reports at 10, 20, 30, 40,
    the last norms within 1e-5 of f64 norms on the host, histogram counts
    summing to each parameter's size, and a ``UIServer`` over the reopened
    file answering the overview, model, system and histogram views over
    HTTP with the stored series; ms a step with and without the
    listener."""
    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.ui import (FileStatsStorage, StatsListener,
                                         UIServer)

    V, T, B = BENCH["num_labels"], BENCH["max_length"], BENCH_BATCH
    probe = bench_net(None, "cpu")
    params = numpy_params(probe, seed=1)
    del probe
    rs = np.random.RandomState(7)
    eye = np.eye(V, dtype=np.float32)
    distinct = []
    for _ in range(UI["distinct"]):
        idx = rs.randint(0, V, (B, T + 1))
        distinct.append(DataSet(eye[idx[:, :-1]], eye[idx[:, 1:]]))
    stream = [distinct[i % len(distinct)] for i in range(UI["steps"])]

    path = os.path.join(tmp, "bench_stats.jsonl")
    store = FileStatsStorage(path)
    watched, plain = bench_net(params, dev), bench_net(params, dev)
    watched.set_listeners(StatsListener(
        store, session_id="bench", reporting_frequency=UI["frequency"],
        collect_histograms=True))
    watched.fit(stream)
    plain.fit(stream)
    sync(dev)
    store.close()
    bitwise = same_params(watched, plain)
    check(watched.iteration == plain.iteration == UI["steps"]
          and bitwise[0], f"15c: fit with the listener vs without: "
                          f"iterations {watched.iteration}/"
                          f"{plain.iteration}, bitwise {bitwise}")

    reopened = FileStatsStorage(path)
    upd = reopened.get_all_updates_after("bench", "StatsListener")
    iters = [r["data"]["iteration"] for r in upd]
    want_iters = list(range(UI["frequency"], UI["steps"] + 1,
                            UI["frequency"]))
    check(iters == want_iters, f"15c: reports at {iters}, expected "
                               f"{want_iters}")
    last = upd[-1]["data"]
    worst_rel = 0.0
    for v in watched.params:
        for k, t in watched.params[v].items():
            want = float(np.linalg.norm(
                t.detach().cpu().double().numpy().ravel()))
            got = last["param_norms"][f"{v}/{k}"]
            worst_rel = max(worst_rel, abs(got - want) / want)
            h = last["param_histograms"][f"{v}/{k}"]
            check(sum(h["counts"]) == t.numel(),
                  f"15c: histogram of {v}/{k} counts {sum(h['counts'])} of "
                  f"{t.numel()}")
    check(worst_rel <= 1e-5, f"15c: the last param_norms vs f64 host norms: "
                             f"rel {worst_rel:.3g}")
    srv = UIServer()
    srv.attach(reopened)
    port = srv.start()
    try:
        sessions = http_json(port, "/train/sessions")
        ov = http_json(port, "/train/overview?sid=bench")
        model = http_json(port, "/train/model?sid=bench")
        system = http_json(port, "/train/system?sid=bench")
        hist = http_json(port, "/train/histograms?sid=bench")
    finally:
        srv.stop()
        reopened.close()
    check(sessions == ["bench"] and ov["iterations"] == want_iters
          and ov["scores"] == [r["data"]["score"] for r in upd]
          and ov["latest_param_norms"] == last["param_norms"]
          and model.get("num_params") == watched.num_params()
          and model.get("torch_backend") == torch.device(dev).type
          and system["iterations"] == want_iters
          and hist["iteration"] == UI["steps"]
          and hist["param_histograms"] == last["param_histograms"],
          f"15c: the UIServer's views differ from the stored series: "
          f"{sessions}, {ov['iterations']}, {model.get('num_params')}, "
          f"{system['iterations']}, {hist['iteration']}")

    timing = FileStatsStorage(os.path.join(tmp, "timing_stats.jsonl"))
    watched.set_listeners(StatsListener(
        timing, session_id="timing", reporting_frequency=UI["frequency"],
        collect_histograms=True))
    with_ms, with_w = marginal_fit_ms(watched, stream, dev)
    without_ms, without_w = marginal_fit_ms(plain, stream, dev)
    watched.set_listeners()
    timing.close()
    log(f"  15c StatsListener on the bench leg [{B}, {T}] bf16: {UI['steps']}"
        f" steps, reports at {iters}, parameters bitwise the fit without "
        f"it; last norms vs f64 host norms rel {worst_rel:.2e}; histogram "
        f"counts whole; UIServer overview/model/system/histograms over "
        f"HTTP equal the stored series; {with_ms:.3f} ms a step with the "
        f"listener vs {without_ms:.3f} without (marginal windows of "
        f"{UI['window']} steps: {[round(w, 3) for w in with_w]} / "
        f"{[round(w, 3) for w in without_w]}); [{card}]")
    return dict(reports=iters, fit_bitwise=bitwise[0],
                norms_max_rel=worst_rel, with_listener_ms=with_ms,
                with_listener_windows=with_w, without_listener_ms=without_ms,
                without_listener_windows=without_w,
                file_bytes=os.path.getsize(path))


def components_of(path):
    """The component list a ``render_html`` page embeds."""
    import re

    with open(path, encoding="utf-8") as f:
        page = f.read()
    m = re.search(r"const COMPONENTS = (\[.*?\]);\n", page, re.S)
    check(m is not None, f"15c: {path} holds no component data")
    return json.loads(m.group(1).replace("<\\/", "</"))


def phase_legacy(card, dev, tmp):
    """15c part 2: the three legacy listeners on bench.py's LeNet (batch
    512) writing their reports during ``fit``; the
    ``ConvolutionalIterationListener`` maps of the last report within
    1e-5 of the same listener's on a CPU net holding the card's
    parameters."""
    from deeplearning4j_torch.ui import (ConvolutionalIterationListener,
                                         FlowIterationListener,
                                         HistogramIterationListener)

    Bl, steps = UI["lenet_batch"], UI["lenet_steps"]
    data = mnist_nhwc(True, steps * Bl, Bl)
    probe = data[0].features[:1]
    card_dir, cpu_dir = os.path.join(tmp, "legacy"), \
        os.path.join(tmp, "legacy_cpu")
    net = twin("LeNet", dev)
    net.set_listeners(HistogramIterationListener(card_dir, frequency=2),
                      FlowIterationListener(card_dir, frequency=2),
                      ConvolutionalIterationListener(card_dir, probe,
                                                     frequency=2))
    t0 = time.perf_counter()
    net.fit(data)
    sync(dev)
    fit_s = time.perf_counter() - t0
    net.set_listeners()
    check(net.iteration == steps, f"15c: LeNet {net.iteration} iterations")
    pages = {f: components_of(os.path.join(card_dir, f))
             for f in ("histograms.html", "flow.html", "activations.html")}
    n_params = sum(int(t.numel()) for p in net.params.values()
                   for t in p.values())
    hists = [c for c in pages["histograms.html"]
             if c["componentType"] == "ChartHistogram"]
    check(sum(sum(c["y_values"]) for c in hists) == n_params,
          "15c: the histogram report does not count every parameter")
    rows = [c for c in pages["flow.html"]
            if c["componentType"] == "ComponentTable"][0]["content"]
    check(sum(int(r[2]) for r in rows) == n_params,
          f"15c: the flow report counts {sum(int(r[2]) for r in rows)} "
          f"parameters of {n_params}")
    cpu = twin("LeNet", "cpu", params=net.params)
    ConvolutionalIterationListener(cpu_dir, probe, frequency=2) \
        .iteration_done(cpu, steps)
    ref = components_of(os.path.join(cpu_dir, "activations.html"))
    maps = [c for c in pages["activations.html"]
            if c["componentType"] == "ChartMatrix"]
    ref_maps = [c for c in ref if c["componentType"] == "ChartMatrix"]
    check([c["title"] for c in maps] == [c["title"] for c in ref_maps]
          and len(maps) > 0, "15c: the card's and the CPU's activation "
                             "reports hold different maps")
    map_err = max(float(np.abs(np.asarray(a["values"])
                               - np.asarray(b["values"])).max())
                  for a, b in zip(maps, ref_maps))
    check(map_err <= 1e-5, f"15c: activation maps card vs CPU differ by "
                           f"{map_err:.3g}")
    log(f"  15c legacy listeners on LeNet (batch {Bl}, {steps} steps, "
        f"{fit_s:.2f} s with the reports): histogram, flow and "
        f"{len(maps)} activation maps written; maps card vs CPU max|err| "
        f"{map_err:.2e}; [{card}]")
    return dict(maps=len(maps), map_max_err=map_err, fit_s=fit_s,
                params=n_params)


def ingest_parts(card, dev, tmp, broker, producer):
    """Phase 15's parts in order: their results, and each one's launches
    counted apart."""
    from deeplearning4j_torch import kernels

    out, by_part = {}, {}
    before = dict(kernels.LAUNCHES)
    log("phase 15a: DataVec into fit (the MNIST CSV, the "
        "synthetic-control sequence CSVs)")
    out["csv_mnist"] = phase_csv_mnist(card, dev, tmp)
    out["csv_sequences"] = phase_csv_sequences(card, dev, tmp)
    by_part["15a"] = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    before = dict(kernels.LAUNCHES)
    log("phase 15b: streaming (a producer process, the broker, "
        "NDArrayRoute into fit)")
    out["streaming"] = phase_streaming(card, dev, broker, producer)
    by_part["15b"] = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    before = dict(kernels.LAUNCHES)
    log("phase 15c: the UI stats pipeline on the bench leg's fit, the "
        "legacy listeners on LeNet")
    out["ui"] = phase_ui(card, dev, tmp)
    out["legacy"] = phase_legacy(card, dev, tmp)
    by_part["15c"] = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    return out, by_part


def phase_ingest(card, dev="cuda"):
    """Phase 15: the data-ingest and telemetry stack (15a-15c), the launch
    counters read between the parts: no attention kernel in 15a or 15b;
    K1, K3 and K4 in 15c (the bench leg's fit), K2 nowhere. 15b's
    producer process starts first, its imports overlapping 15a."""
    from deeplearning4j_torch.streaming import StreamingBroker

    t0 = time.perf_counter()
    broker = StreamingBroker(port=0).start()
    producer = start_producer(broker)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out, by_part = ingest_parts(card, dev, tmp, broker, producer)
    finally:
        if producer.poll() is None:
            producer.kill()
            producer.wait()
        broker.stop()
    check(not any(by_part["15a"].values())
          and not any(by_part["15b"].values()),
          f"phase 15: an attention kernel launched in 15a or 15b: {by_part}")
    check(all(by_part["15c"][k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                               "flash_bwd_dkv"))
          and not any(v for k, v in by_part["15c"].items()
                      if k.startswith("paged_attn")),
          f"phase 15c: K1, K3 and K4 must launch and K2 must not: "
          f"{by_part['15c']}")
    wall = time.perf_counter() - t0
    log(f"  phase 15: {wall:.1f} s; launches by part {by_part}; [{card}]")
    return dict(out, launches_by_part=by_part, wall_s=wall)


# ---------------------------------------------------------------- phase 16
#: phase 16: the tensor-parallel degrees served beside tp = 1, and the
#: data-parallel width of 16d and of 16e's first part
MESH_TPS = (2, 4)
MESH_WORKERS = 4
#: 16e part 1: the phase-7 model trained over MESH_WORKERS workers on the
#: phase-7 batch and one from RandomState(8) (one round each), with
#: ``Sgd(MESH_SGD_LR)`` averaged every step and with the conf's Adam
#: sharing gradients; tolerances are JAX's tests' (``tests/test_parallel.py``)
MESH_SGD_LR = 0.1
MESH_TOL = {"averaging": (1e-5, 1e-6), "shared_gradients": (1e-4, 1e-5)}
#: 16e part 2: phase 7c's bench leg (bf16, T = 512, batch 32 a worker) over
#: 2 workers averaging every 2 steps, for this many timed rounds
MESH_BENCH = dict(workers=2, frequency=2, rounds=10)


def mesh_entries(n):
    """``n`` mesh entries: the first ``n`` cards where the machine has them,
    else ``cuda:0`` named ``n`` times; and which of the two."""
    if n == 1:
        return [torch.device("cuda", 0)], "one card"
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)], "distinct cards"
    return [torch.device("cuda", 0)] * n, "cuda:0 repeated"


def mesh_of(n, axis):
    from deeplearning4j_torch.parallel.mesh import Mesh

    devs, how = mesh_entries(n)
    return Mesh(devs, (axis,)), how


def shard_read_checks(dev):
    """K2 on the head shards a tp server reads (``[8, 8/tp, T, 32]``
    queries over ``[P, 8/tp, 16, 32]`` pools of Tmax 512, f32 and int8, the
    decode route at T = 1 and the chunk route at T = 256, the served
    prefill's shape): each shard's read against the plain version (phase
    3's tolerances), the shards concatenated bitwise the whole pool's read
    under the full head count's split rule; the chunk route also under the
    shard's own rule (another split count at this shape: its largest
    difference from the whole read reported); one shard read timed beside
    its plain version."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.nn.conf.layers import paged_attention as ppa

    g = torch.Generator().manual_seed(16)
    H = SLICE["n_heads"]
    d = SLICE["d_model"] // H
    ext = kernels.load()
    out = {}
    for quant in (False, True):
        for B, T in ((8, 1), (8, 256)):
            kp, vp, ks, vs, bt = paged_pool(g, B, H, 16, d, 512, quant, dev)
            NP = bt.shape[1]
            pos = torch.randint(0, 512 - T + 1, (B,), generator=g).to(
                torch.int32).to(dev)
            q = torch.randn(B, H, T, d, generator=g).to(dev)
            whole = ppa.paged_attention(q, kp, vp, bt, pos, kscales=ks,
                                        vscales=vs)
            atol = 1e-3 if quant else 1e-4
            for tp in MESH_TPS:
                hl = H // tp
                parts, own, err = [], [], 0.0
                for i in range(tp):
                    hs = slice(i * hl, (i + 1) * hl)

                    def cut(t):
                        return None if t is None else t[:, hs].contiguous()

                    args = (cut(q), cut(kp), cut(vp), bt, pos)
                    kw = dict(kscales=cut(ks), vscales=cut(vs))
                    o = ppa.paged_attention(*args, split_heads=H, **kw)
                    ref = ppa.paged_attention_plain(*args, **kw)
                    err = max(err, (o - ref).abs().max().item())
                    parts.append(o)
                    own.append(ppa.paged_attention(*args, **kw))
                name = (f"{'int8' if quant else 'f32'}_T{T}_B{B}_tp{tp}")
                kind = ppa.pool_kind(kp)
                split_full = ext.paged_attn_splits(B, H, T, d, 16, NP, kind)
                split_local = ext.paged_attn_splits(B, hl, T, d, 16, NP, kind)
                check(err <= atol, f"K2 shard {name}: max |err| {err:.3g} > "
                                   f"{atol:.3g}")
                check(torch.equal(torch.cat(parts, dim=1), whole),
                      f"K2 shard {name}: the shards' reads do not "
                      f"concatenate bitwise to the whole pool's")
                own_diff = (torch.cat(own, dim=1) - whole).abs().max().item()
                kernel = lambda: ppa.paged_attention(  # noqa: E731
                    *args, split_heads=H, **kw)
                plain = lambda: ppa.paged_attention_plain(  # noqa: E731
                    *args, **kw)
                ms, plain_ms = time_ms(kernel, iters=20), time_ms(plain,
                                                                  iters=5)
                out[name] = dict(max_abs_err=err, tolerance=atol,
                                 bitwise_whole=True, splits=split_full,
                                 splits_by_shard_rule=split_local,
                                 shard_rule_max_diff=own_diff, ms=ms,
                                 plain_ms=plain_ms)
                log(f"  K2 shard {name:18s} err {err:.2e} (atol {atol:.0e}), "
                    f"concatenation bitwise the whole read, splits "
                    f"{split_full} (the shard's own rule: {split_local}, "
                    f"{own_diff:.2e} from the whole read); {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms")
    return out


def paged_logits(net, prompt, mesh):
    """A fresh server's paged forward of ``prompt`` from position 0 (K2's
    chunk route) and of one more token after it (its decode route), on
    pages 1.. of its pool: the two logit tensors."""
    import torch.nn.functional as F
    from deeplearning4j_torch.parallel.generation import GenerationServer

    V = SLICE["num_labels"]
    srv = GenerationServer(net, V, mesh=mesh, **SERVER)
    try:
        n = -(-(len(prompt) + 1) // srv._ps)
        bt = np.zeros((1, srv._np), np.int32)
        bt[0, :n] = np.arange(1, n + 1)
        logits = []
        with torch.inference_mode():
            for ids, p0 in ((prompt, 0), (prompt[-1:], len(prompt))):
                x = F.one_hot(srv._to_dev(np.asarray(ids)[None]), V).float()
                carry = srv._carry(srv._to_dev(bt),
                                   srv._to_dev(np.array([p0], np.int32)))
                logits.append(srv._fwd(*srv._weights, x, carry)[0])
        torch.cuda.synchronize()
    finally:
        srv.close()
    return logits


def phase_mesh_serve(net, want, card):
    """Phase 16a: the phase-5 requests served at tp = 1, 2 and 4 with f32
    and int8 KV, every stream phase 5's; K2's launches a token per route,
    tokens/s and peak pages per shard; one prompt's logits at tp = 2 and 4
    bitwise tp = 1's (the chunk route, then a decode step)."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.parallel.mesh import MODEL_AXIS

    results = dict(shard_reads=uncounted(shard_read_checks,
                                         torch.device("cuda")))
    reqs = serve_requests()
    nb, M = SLICE["n_blocks"], SERVER["steps_per_dispatch"]
    for kv in (None, "int8"):
        tag = kv or "f32"
        for tp in (1,) + MESH_TPS:
            mesh, how = mesh_of(tp, MODEL_AXIS)
            # an untimed serve first, so each device of the mesh has its
            # context and kernels loaded before the timed one
            uncounted(serve, net, reqs[:1], kv_dtype=kv, mesh=mesh)
            before = dict(kernels.LAUNCHES)
            outs, wall, st = serve(net, reqs, kv_dtype=kv, mesh=mesh)
            k2 = kernels.LAUNCHES["paged_attn"] - before["paged_attn"]
            chunk = (kernels.LAUNCHES["paged_attn_chunk"]
                     - before["paged_attn_chunk"])
            check_streams(f"mesh serve {tag} tp={tp}", outs, want[tag],
                          "phase 5's stream")
            check(k2 == tp * nb * (st["prefill_rounds"]
                                   + M * st["decode_steps"])
                  and chunk == tp * nb * st["prefill_rounds"],
                  f"mesh serve {tag} tp={tp}: K2 launched {k2} times "
                  f"({chunk} chunk) for {st['prefill_rounds']} prefill rounds "
                  f"and {st['decode_steps']} decode dispatches")
            ntok = sum(len(o) for o in outs)
            pg = st["pages"]
            r = results[f"{tag}_tp{tp}"] = dict(
                tp=tp, mesh=how, tokens=ntok, wall_s=wall,
                tokens_per_s=ntok / wall, k2_launches=k2,
                k2_chunk_launches=chunk,
                k2_decode_per_token=(k2 - chunk) / ntok,
                k2_chunk_per_token=chunk / ntok,
                prefill_rounds=st["prefill_rounds"],
                decode_steps=st["decode_steps"],
                peak_pages_per_shard=pg["peak_pages"],
                peak_kv_bytes_per_shard=pg["peak_resident_kv_bytes"] // tp)
            log(f"  mesh serve {tag} tp={tp} ({how}): {ntok} tokens in "
                f"{wall:.3f} s = {r['tokens_per_s']:.1f} tok/s, streams "
                f"phase 5's; K2 {r['k2_decode_per_token']:.3f} decode and "
                f"{r['k2_chunk_per_token']:.3f} chunk launches a token; peak "
                f"{pg['peak_pages']} pages a shard "
                f"({r['peak_kv_bytes_per_shard']} bytes); [{card}]")
    prompt = reqs[1][0]
    base = paged_logits(net, prompt, mesh_of(1, MODEL_AXIS)[0])
    for tp in MESH_TPS:
        got = paged_logits(net, prompt, mesh_of(tp, MODEL_AXIS)[0])
        check(all(torch.equal(a, b) for a, b in zip(got, base)),
              f"mesh serve: a {len(prompt)}-token prompt's logits at tp={tp} "
              f"are not bitwise tp=1's")
    results["logits_bitwise"] = dict(prompt_tokens=len(prompt),
                                     tps=list(MESH_TPS))
    log(f"  mesh logits: a {len(prompt)}-token prefill and one decode step "
        f"at tp={list(MESH_TPS)} bitwise tp=1's; [{card}]")
    return results


def phase_mesh_handoff(net, card):
    """Phase 16b: four live requests exported from a tp = 2 server after
    at least HANDOFF_AFTER tokens (header ``shards=2``), round-tripped
    through their bytes and adopted at tp = 4 and at tp = 1, f32 and int8
    KV: completions equal the uninterrupted streams, 4 resumes each, no
    fallback."""
    from deeplearning4j_torch.parallel.mesh import MODEL_AXIS

    reqs = prefix_requests()[1:5]
    results = {}
    for kv in (None, "int8"):
        tag = kv or "f32"
        r = results[tag] = handoff_round(
            net, reqs, kv, source=mesh_of(2, MODEL_AXIS)[0],
            adopters=(mesh_of(4, MODEL_AXIS)[0], None))
        log(f"  mesh handoff {tag}: 4 requests exported from tp=2 at tokens "
            f"{r['exported_at']} (shards={r['shards']}, "
            f"{sum(r['wire_bytes'])} wire bytes), adopted at tp=4 and tp=1: "
            f"resumes {[a['resumes'] for a in r['adopted']]}, fallbacks "
            f"{[a['fallbacks'] for a in r['adopted']]}, completions equal "
            f"the uninterrupted streams; [{card}]")
    return results


def phase_mesh_fleet(net, reqs, want, card):
    """Phase 16c: ``device_groups(2, tp=2)`` and a ``ReplicaFleet`` of two
    tp = 2 servers (their weights replicated onto each group's first
    device) serving phase 9's traffic, replica 0 killed once it decodes:
    every stream phase 5's or 5b's, a death, nothing lost."""
    from deeplearning4j_torch.parallel.fleet import (ReplicaFleet,
                                                     device_groups)
    from deeplearning4j_torch.parallel.generation import GenerationServer
    from deeplearning4j_torch.parallel.mesh import MODEL_AXIS, Mesh

    entries, how = mesh_entries(4)
    groups = device_groups(2, tp=2, devices=entries)

    def factory(rid):
        return GenerationServer(net, SLICE["num_labels"],
                                mesh=Mesh(groups[rid % 2], (MODEL_AXIS,)),
                                **SERVER)

    fleet = ReplicaFleet(factory, replicas=2, restart_backoff_s=0.05)
    try:
        def kill_when_decoding():
            def decoding():
                blk = fleet.stats()["replicas"][0]
                return blk["inflight"] > 0 and \
                    (blk["server"] or {}).get("tokens_generated", 0) > 0
            wait_for(decoding, 60, "replica 0 to decode")
            check(fleet.kill_replica(0), "mesh fleet: replica 0 was not live")

        outs, wall = fleet_serve(fleet, reqs, kill_when_decoding)
        st = fleet.stats()
    finally:
        fleet.close()
    check(outs == want, "mesh fleet: a stream differs from phase 5's/5b's")
    check(st["deaths"] >= 1, f"mesh fleet: deaths {st['deaths']}")
    check_fleet("mesh fleet", st, len(reqs))
    ntok = sum(len(w) for w in want)
    log(f"  mesh fleet: 2 replica groups of tp=2 ({how}: "
        f"{[[str(d) for d in g] for g in groups]}), {len(reqs)} requests "
        f"({ntok} tokens) with replica 0 killed mid-run: "
        f"{ntok / wall:.1f} tok/s, deaths {st['deaths']}, "
        f"{st['redispatched']} re-dispatched, every stream phase 5's/5b's, "
        f"none lost; [{card}]")
    return dict(mesh=how, requests=len(reqs), tokens=ntok, wall_s=wall,
                tokens_per_s=ntok / wall, deaths=st["deaths"],
                redispatched=st["redispatched"],
                handoff_resumes=st["handoff_resumes"])


def allclose_excess(got, ref, rtol, atol):
    """The largest ``|got - ref| - (atol + rtol |ref|)`` (<= 0 passes
    ``np.allclose``'s rule)."""
    return float((np.abs(got - ref) - (atol + rtol * np.abs(ref))).max())


def phase_mesh_inference(net, card):
    """Phase 16d: ``ParallelInference`` over a 4-device data mesh on the
    slice model (K1) and on LeNet (trained on 32 synthetic MNIST batches),
    rows against the net's own ``output()`` (JAX's rtol 1e-5 / atol 1e-6);
    ``evaluate_on_mesh`` fused and per batch on LeNet over 4 test batches
    and a ragged fifth, counts equal ``net.evaluate``'s."""
    from deeplearning4j_torch.models.zoo import LeNet
    from deeplearning4j_torch.parallel.evaluation import evaluate_on_mesh
    from deeplearning4j_torch.parallel.inference import ParallelInference
    from deeplearning4j_torch.parallel.mesh import DATA_AXIS

    mesh, how = mesh_of(MESH_WORKERS, DATA_AXIS)
    lenet = LeNet(num_labels=10, seed=1).init(device="cuda")
    lenet.fit(mnist_nhwc(True, LENET_BATCH * PI_TRAIN_BATCHES, LENET_BATCH))
    test = mnist_nhwc(False, 4 * LENET_BATCH + 20, LENET_BATCH)
    rs = np.random.RandomState(3)
    V, T = SLICE["num_labels"], SLICE["max_length"]
    x_lm = np.eye(V, dtype=np.float32)[rs.randint(0, V, (PI_SUBMITS, T))]
    results = {}
    for tag, model, x in (("transformer", net, x_lm),
                          ("lenet", lenet, test[0].features)):
        inf = ParallelInference(model, mesh=mesh)
        try:
            rows = inf.output(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = inf.output(x)
            wall = time.perf_counter() - t0
        finally:
            inf.close()
        ref = uncounted(lambda: host_rows(model.output(x)))
        t0 = time.perf_counter()
        uncounted(lambda: host_rows(model.output(x)))
        one_wall = time.perf_counter() - t0
        excess = allclose_excess(rows, ref, 1e-5, 1e-6)
        check(excess <= 0, f"mesh inference {tag}: rows vs output() beyond "
                           f"rtol 1e-5 / atol 1e-6 by {excess:.3g}")
        results[tag] = dict(rows=len(x), workers=inf.workers, wall_s=wall,
                            rows_per_s=len(x) / wall,
                            one_device_rows_per_s=len(x) / one_wall,
                            max_abs_err=float(np.abs(rows - ref).max()))
        log(f"  mesh inference {tag}: {len(x)} rows over {inf.workers} "
            f"workers ({how}), within rtol 1e-5 / atol 1e-6 of output() "
            f"(max |err| {results[tag]['max_abs_err']:.2e}); "
            f"{len(x) / wall:.0f} rows/s (one output(): "
            f"{len(x) / one_wall:.0f}); [{card}]")
    seq = uncounted(lenet.evaluate, test)
    for fused in (True, False):
        ev = evaluate_on_mesh(lenet, test, mesh=mesh, fused=fused)
        check(np.array_equal(ev.confusion, seq.confusion),
              f"evaluate_on_mesh(fused={fused}): counts differ from "
              f"net.evaluate's")
        results[f"evaluate_fused_{fused}"] = dict(accuracy=ev.accuracy())
    images = sum(len(d.features) for d in test)
    log(f"  evaluate_on_mesh fused and per batch: {images} "
        f"images, counts equal net.evaluate's (accuracy "
        f"{seq.accuracy():.4f}); [{card}]")
    return results


def mesh_slice_net(params, device, mode):
    """The phase-7 model on ``params``, with ``Sgd(MESH_SGD_LR)`` for
    ``averaging`` and the conf's Adam for ``shared_gradients``."""
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.nn.updater import Sgd
    from deeplearning4j_torch.utils.convert import params_from_jax

    net = TransformerLM(**SLICE).init(device=device)
    params_from_jax(params, net)
    if mode == "averaging":
        net.conf.updater = Sgd(learning_rate=MESH_SGD_LR)
        net.updater_state = net.conf.updater.init(net.params)
    return net


def mesh_rounds():
    """16e's two rounds on the phase-7 model (the phase-7 batch, then one
    from RandomState(8)), and ``split(x, y)``: a round's MESH_WORKERS
    DataSets of TRAIN_BATCH / MESH_WORKERS rows."""
    from deeplearning4j_torch.datasets.dataset import DataSet

    V, T = SLICE["num_labels"], SLICE["max_length"]
    eye = np.eye(V, dtype=np.float32)
    tok = np.random.RandomState(8).randint(0, V, (TRAIN_BATCH, T + 1))
    rows = TRAIN_BATCH // MESH_WORKERS

    def split(x, y):
        return [DataSet(x[w * rows:(w + 1) * rows], y[w * rows:(w + 1) * rows])
                for w in range(MESH_WORKERS)]

    return [train_batch(), (eye[tok[:, :-1]], eye[tok[:, 1:]])], split


def worst_rule(got, ref, rtol, atol):
    """Over two trees of tensors, the largest ``|got - ref| - (atol + rtol
    |ref|)``."""
    return max(allclose_excess(got[v][k].detach().cpu().double().numpy(),
                               ref[v][k].detach().cpu().double().numpy(),
                               rtol, atol)
               for v in ref for k in ref[v])


def phase_mesh_train(card):
    """Phase 16e: ``ParallelWrapper`` over 4 workers on the phase-7 model:
    ``AVERAGING`` every step with Sgd and ``SHARED_GRADIENTS`` with Adam,
    two rounds against one device on the concatenated batches (JAX's
    tolerances), and the first round against a 4-worker run on the CPU
    (the round's update under SGD, Adam's first moment under Adam, within
    1e-4 of the leaf's max, phase 7's rule); then phase 7c's bench leg over
    2 workers averaging every 2 steps: tokens/s, ``last_phase_timings``,
    skips, K1/K3/K4 launches a round."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.optimize.health import HealthPolicy
    from deeplearning4j_torch.parallel.mesh import DATA_AXIS, Mesh
    from deeplearning4j_torch.parallel.trainer import ParallelWrapper

    W = MESH_WORKERS
    mesh, how = mesh_of(W, DATA_AXIS)
    cpu_mesh = Mesh([torch.device("cpu")] * W, (DATA_AXIS,))
    rounds, split = mesh_rounds()
    params = numpy_params(fabric_net(), seed=0)
    results = {}
    for mode, (rtol, atol) in MESH_TOL.items():
        single = mesh_slice_net(params, "cuda", mode)
        for x, y in rounds:
            single.do_step(x, y)
        dist = mesh_slice_net(params, "cuda", mode)
        p0 = {v: {k: t.clone() for k, t in p.items()}
              for v, p in dist.params.items()}
        pw = ParallelWrapper(dist, mesh=mesh, mode=mode)
        pw.fit(split(*rounds[0]))
        first = (dist.params if mode == "averaging"
                 else dist.updater_state["m"])
        first = {v: {k: t.clone() for k, t in p.items()}
                 for v, p in first.items()}
        pw.fit(split(*rounds[1]))
        excess = worst_rule(dist.params, single.params, rtol, atol)
        check(excess <= 0, f"mesh train {mode}: params vs one device on the "
                           f"concatenated batches beyond rtol {rtol} / atol "
                           f"{atol} by {excess:.3g}")
        cpu = mesh_slice_net(params, "cpu", mode)
        ParallelWrapper(cpu, mesh=cpu_mesh, mode=mode).fit(
            split(*rounds[0]))
        if mode == "averaging":     # the round's update
            got = {v: {k: first[v][k] - p0[v][k] for k in p0[v]} for v in p0}
            ref = {v: {k: cpu.params[v][k] - p0[v][k].cpu() for k in p0[v]}
                   for v in p0}
        else:                       # Adam's first moment: 0.1 x the gradient
            got, ref = first, cpu.updater_state["m"]
        cpu_err = max(((got[v][k].cpu() - ref[v][k]).abs().max()
                       / ref[v][k].abs().max().clamp_min(1e-30)).item()
                      for v in ref for k in ref[v])
        check(cpu_err <= 1e-4, f"mesh train {mode}: the first round card vs "
                               f"CPU, worst leaf {cpu_err:.3g} of its max")
        results[mode] = dict(workers=W, mesh=how, excess=excess,
                             rtol=rtol, atol=atol, cpu_rel_err=cpu_err,
                             timings=pw.last_phase_timings)
        log(f"  mesh train {mode}: {W} workers ({how}) two rounds within "
            f"rtol {rtol} / atol {atol} of one device on the concatenated "
            f"batches; first round card vs CPU {cpu_err:.2e} of each leaf's "
            f"max; [{card}]")
    nb = BENCH["n_blocks"]
    Wb, Fb, R = (MESH_BENCH["workers"], MESH_BENCH["frequency"],
                 MESH_BENCH["rounds"])
    bmesh, bhow = mesh_of(Wb, DATA_AXIS)
    # phase 7c's batches without its NaN one: 4 full batches, cycled
    stream = [ds for i, ds in enumerate(bench_stream())
              if i != BENCH_NAN_AT][:Wb * Fb]
    net = bench_net(numpy_params(bench_net(None, "cpu"), seed=1), "cuda")
    policy = HealthPolicy()
    pw = ParallelWrapper(net, mesh=bmesh, averaging_frequency=Fb,
                         health_guard=policy)
    pw.fit(stream)                                         # warm-up round
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pw.fit(stream * R)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_round = {k: (kernels.LAUNCHES[k] - before[k]) / R
                 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    check(all(n == nb * Wb * Fb for n in per_round.values()),
          f"mesh bench: K1/K3/K4 launches a round {per_round}, expected "
          f"{nb * Wb * Fb} each")
    tokens = R * Wb * Fb * BENCH_BATCH * BENCH["max_length"]
    check(np.isfinite(net.score_value), "mesh bench: non-finite score")
    results["bench"] = dict(workers=Wb, frequency=Fb, rounds=R, mesh=bhow,
                            wall_s=wall, tokens_per_s=tokens / wall,
                            ms_per_round=wall / R * 1e3,
                            launches_per_round=per_round,
                            skips=policy.total_skips,
                            last_phase_timings=pw.last_phase_timings,
                            score=float(net.score_value))
    log(f"  mesh bench: the 7c bench leg over {Wb} workers ({bhow}), "
        f"averaging every {Fb} steps, {R} rounds in {wall:.3f} s = "
        f"{tokens / wall:.0f} tokens/s ({wall / R * 1e3:.1f} ms a round), "
        f"skips {policy.total_skips}, K1/K3/K4 a round {per_round}, last "
        f"round {pw.last_phase_timings}; [{card}]")
    return results


def phase_mesh(card, greedy=None, int8=None, sampled=None):
    """Phase 16: several devices of one process (16a-16e); the mesh entries
    are distinct cards where the machine has enough, else ``cuda:0``
    repeated, and every line says which."""
    from deeplearning4j_torch import kernels

    kernels.load()
    t0 = time.perf_counter()
    net = fabric_net()
    reqs = serve_requests()
    if greedy is None:
        greedy = uncounted(serve, net, reqs)[0]
    if int8 is None:
        int8 = uncounted(serve, net, reqs, kv_dtype="int8")[0]
    log(f"phase 16a: tensor-parallel serving at tp = 1, {MESH_TPS} "
        f"({mesh_entries(max(MESH_TPS))[1]}; {torch.cuda.device_count()} "
        f"card(s))")
    out = dict(serve=phase_mesh_serve(net, dict(f32=greedy, int8=int8),
                                      card))
    log("phase 16b: cross-tp handoff (tp=2 to tp=4 and tp=1)")
    out["handoff"] = phase_mesh_handoff(net, card)
    log("phase 16c: replica groups (two tp=2 servers, a mid-stream kill)")
    freqs, fwant = fabric_requests(net, greedy, sampled)
    out["fleet"] = phase_mesh_fleet(net, freqs, fwant, card)
    log("phase 16d: data-parallel inference and evaluation")
    out["inference"] = phase_mesh_inference(net, card)
    log("phase 16e: ParallelWrapper (both modes, then the bench leg)")
    out["train"] = phase_mesh_train(card)
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 16: {out['wall_s']:.1f} s; [{card}]")
    return out


# ---------------------------------------------------------------- phase 17
#: phase 17a: the phase-10 stores sharded over a data mesh of this many
#: entries (bench.py's 1M x 32 flat f32 and int8, then the 10M x 16 int8
#: IVF trained by the sharded k-means and searched probe-local)
SHARD_ENTRIES = 4
#: 17a: queries held one-card against sharded, and the recall probe rows
SHARD_QUERIES = 64
#: 17b: the slice TransformerLM over data_model_mesh(2, 2) at phase 7's
#: 16 x 128 tokens with the conf's Adam, this many steps against one card
#: (JAX's dp x tp tolerance, ``tests/test_model_sharding.py``)
SHARDED_STEPS = 3
SHARDED_TOL = (2e-4, 2e-5)
#: 17c: ring and Ulysses attention on the slice's attention layer at this
#: many positions over a 4-entry ``seq`` axis (JAX's tolerances: outputs
#: 2e-5, gradients 3e-5, relative to the leaf's max for the gradients);
#: the pipeline over 2 stages x 4 microbatches of phase 8's LeNet (its
#: AdaDelta) on batches of 64, in f64, held to one card's steps within
#: PIPE_REL of each leaf's largest change: in f32 the ReLU and max-pool
#: choices turn a microbatch's other summation order into ~1e-3 of a
#: change after three steps (on the CPU too), in f64 into ~1e-14
SEQ_T = 2048
SEQ_TOL = (2e-5, 3e-5)
PIPE17 = dict(stages=2, micro=4, batch=64, steps=3)
PIPE_REL = 1e-9
#: 17d: Word2Vec at 14a's corpus and width over tables sharded on 2
#: entries, held to the unsharded fit (CUDA's index_add_ adds with
#: atomics, in an order that varies from run to run: allclose, ROADMAP C5)
W2V_SHARDED_ATOL = 1e-4


def one_card_q_s():
    """Phase 10a's coalesced euclidean q/s of this run, where it ran."""
    exact = REPORT.get("retrieval", {}).get("exact", {})
    q_s = exact.get("euclidean", {}).get("coalesced_q_s")
    return "not run" if q_s is None else f"{q_s:.1f} q/s"


def shard_store_checks(pts, qs, card):
    """17a part 1: the 1M x 32 flat stores sharded over SHARD_ENTRIES
    entries against one card's, the server over the sharded f32 store,
    and the sharded open loop."""
    from deeplearning4j_torch.nearestneighbors.index import (
        EmbeddingIndex, _quantize_rows, _shard_bytes)
    import urllib.request

    from deeplearning4j_torch.nearestneighbors.server import (
        NearestNeighborsServer)

    mesh, how = mesh_of(SHARD_ENTRIES, "data")
    q = qs[:SHARD_QUERIES]
    out = dict(entries=how)
    for store in ("f32", "int8"):
        one = EmbeddingIndex(pts, store=store, device="cuda")
        t0 = time.perf_counter()
        sh = EmbeddingIndex(pts, store=store, mesh=mesh,
                            max_batch=KNN["queries"])
        torch.cuda.synchronize()
        build = time.perf_counter() - t0
        try:
            want = one.search_batch_arrays(q, 10)
            got = sh.search_batch_arrays(q, 10)
            if store == "f32":
                held = pts
            else:
                qq, s = _quantize_rows(pts)
                held = qq.astype(np.float32) * s[:, None]
            rule = tie_rule(f"17a sharded {store} vs one card", got, want,
                            held, q)
            ids_equal = bool(np.array_equal(got[1], want[1]))
            d_err = float(np.abs(got[0] - want[0]).max())
            check(d_err <= 1e-5 * max(1.0, float(np.abs(want[0]).max())),
                  f"17a {store}: distances differ by {d_err:.3g}")
            recall = sh.measure_recall(q, k=10)
            check(recall >= (0.9 if store == "int8" else 1.0),
                  f"17a sharded {store}: recall@10 {recall:.4f}")
            per_entry = _shard_bytes(sh._store)
            r = dict(build_s=build, ids_equal=ids_equal, max_dist_err=d_err,
                     tie_rule=rule, recall=recall,
                     bytes_per_entry=per_entry,
                     one_card_bytes=one.resident_bytes)
            if store == "f32":
                _rows, qps, p99, failed = open_loop(sh, qs)
                check(failed == 0, f"17a: {failed} sharded queries failed")
                r.update(q_s=qps, p99_ms=p99)
                srv = NearestNeighborsServer(pts[:65536], port=0,
                                             backend="index", mesh=mesh)
                srv.start()
                try:
                    base = f"http://127.0.0.1:{srv.port}"
                    qv = qs[:3].tolist()
                    req = urllib.request.Request(
                        base + "/knn", data=json.dumps(
                            {"k": 5, "points": qv}).encode(),
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=60) as res:
                        body = json.loads(res.read())
                    ids = [[x["index"] for x in row]
                           for row in body["results"]]
                    check(ids == srv.index.search_batch_arrays(
                        qs[:3], 5)[1].tolist(),
                          "17a: the sharded server's /knn differs from its "
                          "index")
                    r["server_variant"] = srv.index.stats()["variant"]
                finally:
                    srv.stop()
            out[store] = r
            log(f"  17a {store} 1M x 32 over {SHARD_ENTRIES} entries "
                f"({how}): ids equal {ids_equal} (tie rule: near-ties "
                f"{rule['near_ties']}), max |d err| {d_err:.3g}, recall@10 "
                f"{recall:.4f}, bytes per entry {per_entry} (one card "
                f"{one.resident_bytes}), build {build:.2f} s"
                + (f"; open loop {r['q_s']:.1f} q/s (phase 10a's one "
                   f"card: {one_card_q_s()}), p99 {r['p99_ms']:.1f} ms; "
                   f"server /knn as its index" if store == "f32" else "")
                + f"; [{card}]")
        finally:
            one.close()
            sh.close()
    return out


def shard_ivf_checks(card):
    """17a part 2: the 10M x 16 int8 IVF with sharded k-means and the
    probe-local search against the global probe of one card's store."""
    from deeplearning4j_torch.nearestneighbors.index import (EmbeddingIndex,
                                                             _shard_bytes)

    mesh, how = mesh_of(SHARD_ENTRIES, "data")
    pts, rs = rag_store()
    n, d = RAG["n"], RAG["d"]
    probe = (pts[rs.choice(n, 32, replace=False)]
             + rs.randn(32, d).astype(np.float32) * 0.2)
    kw = dict(store="int8", partitions=RAG["partitions"],
              nprobe=RAG["nprobe"], train_sample=32768, kmeans_iters=10,
              seed=0)
    t0 = time.perf_counter()
    local = EmbeddingIndex(pts, mesh=mesh, kmeans="sharded", **kw)
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    try:
        st = local.stats()
        check(st["probe_local"] is True and st["variant"] == "ivf"
              and st["nprobe"] == RAG["nprobe"],
              f"17a: sharded IVF stats {st}")
        r_local = local.measure_recall(probe, k=10)
        per_entry = _shard_bytes(local._store)
        ms, _ = device_ms(lambda: local._dispatch_knn(probe, 16), iters=5)
    finally:
        local.close()
    globl = EmbeddingIndex(pts, device="cuda", **kw)
    try:
        r_global = globl.measure_recall(probe, k=10)
    finally:
        globl.close()
    del pts
    check(r_local >= 0.95, f"17a: sharded IVF recall@10 {r_local:.4f} < "
                           f"0.95 (JAX's sharded k-means gate)")
    check(r_local >= r_global, f"17a: probe-local recall {r_local:.4f} "
                               f"below the global probe's {r_global:.4f}")
    log(f"  17a 10M x 16 int8 IVF, sharded k-means, probe-local over "
        f"{SHARD_ENTRIES} entries ({how}): recall@10 {r_local:.4f} (one "
        f"card's global probe {r_global:.4f}), build {build:.1f} s, "
        f"list_len {st['list_len']}, bytes per entry {per_entry}, one Q=32 "
        f"dispatch {ms:.4f} device ms; [{card}]")
    return dict(entries=how, recall=r_local, global_recall=r_global,
                build_s=build, list_len=st["list_len"],
                bytes_per_entry=per_entry, dispatch_device_ms=ms)


def phase_sharded_trainer(card):
    """17b: dp x tp ShardedTrainer on the slice TransformerLM (data 2 x
    model 2) at phase 7's batch with Adam, against one card's fit from the
    same weights; K1/K3/K4 launch on 4-head shards."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.parallel.mesh import data_model_mesh
    from deeplearning4j_torch.parallel.model_sharding import (
        MODEL_AXIS, ShardedTrainer)
    from deeplearning4j_torch.utils.convert import params_from_jax

    devs, how = mesh_entries(4)
    mesh = data_model_mesh(2, 2, devices=devs)
    rs = np.random.RandomState(17)
    V, T = SLICE["num_labels"], SLICE["max_length"]
    eye = np.eye(V, dtype=np.float32)
    data = []
    for _ in range(SHARDED_STEPS):
        tok = rs.randint(0, V, (TRAIN_BATCH, T + 1))
        data.append(DataSet(eye[tok[:, :-1]], eye[tok[:, 1:]]))

    def make():
        net = TransformerLM(**SLICE).init(device=devs[0])
        params_from_jax(numpy_params(net, seed=0, gain=1.0), net)
        net.updater_state = net.conf.updater.init(net.params)
        return net

    def reference():
        before = dict(kernels.LAUNCHES)
        net = make()
        net.fit(data)
        torch.cuda.synchronize()
        return net, {k: kernels.LAUNCHES[k] - before[k] for k in before}

    ref, ref_launches = uncounted(reference)
    net = make()
    full = sum(t.numel() * t.element_size() for v in net.params.values()
               for t in v.values())
    heads, first = [], []
    from deeplearning4j_torch.ops import flash_attention as fa
    orig = fa.flash_attention

    def spy(q, k, v, **kw):
        heads.append(int(q.shape[1]))
        if not first:            # one shard's inputs, as K1 receives them
            first.append(([t.detach().contiguous().clone()
                           for t in (q, k, v)], kw))
        return orig(q, k, v, **kw)

    trainer = ShardedTrainer(net, mesh)
    before = dict(kernels.LAUNCHES)
    fa.flash_attention = spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        fa.flash_attention = orig
    launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    check(set(heads) == {SLICE["n_heads"] // 2},
          f"17b: the attention core saw {sorted(set(heads))} heads, "
          f"expected {SLICE['n_heads'] // 2}")
    shard = uncounted(hold_shard, fa, *first[0])
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[k] > 0 and launches[k] == 4 * ref_launches[k],
              f"17b: {k} launched {launches[k]} times sharded, "
              f"{ref_launches[k]} on one card (expected 4x)")
    excess = worst_rule({k: {n: st.gather(devs[0]) for n, st in v.items()}
                         for k, v in net.params.items()}, ref.params,
                        *SHARDED_TOL)
    check(excess <= 0, f"17b: dp x tp params after {SHARDED_STEPS} Adam "
                       f"steps exceed rtol/atol {SHARDED_TOL} by {excess:.3g}")
    per_entry = trainer.entry_bytes()
    sharded = sum(st.pieces[0].numel() * st.pieces[0].element_size()
                  for v in net.params.values() for st in v.values()
                  if MODEL_AXIS in st.spec)
    ms, _ = device_ms(lambda: trainer.fit(data[0]), iters=3)
    log(f"  17b ShardedTrainer dp 2 x tp 2 ({how}): {SHARDED_STEPS} Adam "
        f"steps within rtol/atol {SHARDED_TOL} of one card (worst excess "
        f"{excess:.3g}); wall {wall * 1e3 / SHARDED_STEPS:.1f} ms a step "
        f"(first steps, warm-up included), {ms:.3f} device ms a step; "
        f"K1/K3/K4 on {SLICE['n_heads'] // 2}-head shards "
        f"{list(shard['shape'])}, the first shard's forward and backward "
        f"against the plain versions: |O err| {shard['o_err']:.3g}, |lse "
        f"err| {shard['lse_err']:.3g}, dq/dk/dv rel "
        f"{shard['grad_rel_err']:.3g}; launches "
        f"{ {k: launches[k] for k in ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')} } "
        f"= 4 x one card's; params+Adam bytes per entry {per_entry} "
        f"(one card params {full} B, of it sharded leaves {2 * sharded} B); "
        f"[{card}]")
    return dict(entries=how, worst_excess=excess, step_wall_ms=wall * 1e3
                / SHARDED_STEPS, step_device_ms=ms, launches=launches,
                one_card_launches=ref_launches, heads=SLICE["n_heads"] // 2,
                bytes_per_entry=per_entry, one_card_param_bytes=full,
                shard_check=shard)


def hold_shard(fa, qkv, kw):
    """17b: K1's, K3's and K4's wrappers on one head shard's q/k/v as the
    sharded step gave them, against the plain forward and backward (phase
    2's and 6's f32 tolerances) with a seeded dO."""
    q, k, v = qkv
    causal, mask = kw.get("causal", False), kw.get("mask")
    o, lse = fa.flash_attention_forward(q, k, v, causal=causal, mask=mask)
    po, plse = fa.flash_attention_plain(q, k, v, causal=causal, mask=mask)
    g = torch.Generator(device="cpu").manual_seed(17)
    do = torch.randn(q.shape, generator=g).to(q.device, q.dtype)
    grads = fa.flash_attention_backward(q, k, v, o, lse, do, causal=causal,
                                        mask=mask)
    plain = fa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                              causal=causal, mask=mask)
    o_err = float((o - po).abs().max())
    lse_err = float((lse - plse).abs().max())
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(grads, plain))
    check(o_err <= 1e-4 and lse_err <= 1e-4,
          f"17b: K1 on a {list(q.shape)} shard: |O err| {o_err:.3g}, |lse "
          f"err| {lse_err:.3g} > 1e-4")
    check(rel <= BWD_TOL[torch.float32],
          f"17b: K3/K4 on a {list(q.shape)} shard: max|err|/max|g| {rel:.3g}"
          f" > {BWD_TOL[torch.float32]}")
    return dict(shape=list(q.shape), o_err=o_err, lse_err=lse_err,
                grad_rel_err=rel)


def phase_model_parallel(card):
    """17c: the tensor-parallel MLP step, ring and Ulysses attention on
    the slice's attention layer at T = SEQ_T, and the pipeline over LeNet,
    each against one card."""
    from deeplearning4j_torch.models.zoo import LeNet
    from deeplearning4j_torch.nn.conf.layers.attention import (
        SelfAttentionLayer)
    from deeplearning4j_torch.parallel.mesh import Mesh
    from deeplearning4j_torch.parallel.pipeline import PipelineTrainer
    from deeplearning4j_torch.parallel.sequence import (
        sequence_parallel_self_attention)
    from deeplearning4j_torch.parallel.tensor import (dp_tp_mesh,
                                                      tp_mlp_train_step)

    out = {}
    devs, how = mesh_entries(4)
    # the tensor-parallel MLP at JAX's test shapes
    rs = np.random.RandomState(5)
    x = rs.randn(8, 6).astype(np.float32)
    y = rs.randn(8, 4).astype(np.float32)
    p = {"w1": rs.randn(6, 12).astype(np.float32) * 0.3,
         "b1": np.zeros(12, np.float32),
         "w2": rs.randn(12, 4).astype(np.float32) * 0.3,
         "b2": np.zeros(4, np.float32)}
    step = tp_mlp_train_step(dp_tp_mesh(2, 2, devices=devs), torch.tanh,
                             lambda o, t: (o - t) ** 2, lr=0.1)
    new, loss = step({k: torch.tensor(v, device=devs[0])
                      for k, v in p.items()}, x, y)
    tp = {k: torch.tensor(v, device=devs[0], requires_grad=True)
          for k, v in p.items()}
    xt, yt = (torch.tensor(a, device=devs[0]) for a in (x, y))
    ref = torch.mean((torch.tanh(xt @ tp["w1"] + tp["b1"]) @ tp["w2"]
                      + tp["b2"] - yt) ** 2)
    grads = torch.autograd.grad(ref, list(tp.values()))
    mlp_err = max(float(np.abs(np.asarray(new[k])
                               - (tp[k] - 0.1 * g).detach().cpu().numpy()
                               ).max()) for k, g in zip(tp, grads))
    check(mlp_err <= 1e-5 and abs(float(loss) - float(ref.detach())) <= 1e-5,
          f"17c: tp MLP step vs one card {mlp_err:.3g}")
    out["tp_mlp"] = dict(max_err=mlp_err)
    # ring and Ulysses on the slice's attention layer
    D, H = SLICE["d_model"], SLICE["n_heads"]
    layer = SelfAttentionLayer(n_in=D, n_out=D, n_heads=H, causal=True)
    layer.finalize(None)
    rs = np.random.RandomState(9)
    params = {k: torch.tensor((rs.randn(*s) / np.sqrt(s[0])).astype(
                              np.float32), device=devs[0],
                              requires_grad=True)
              for k, s in (("Wq", (D, D)), ("Wk", (D, D)), ("Wv", (D, D)),
                           ("Wo", (D, D)))}
    params["b"] = torch.zeros(D, device=devs[0], requires_grad=True)
    xs = torch.tensor(rs.randn(1, SEQ_T, D).astype(np.float32),
                      device=devs[0], requires_grad=True)
    seq_mesh = Mesh(devs, ("seq",))

    def grads_of(fn):
        o = fn()
        g = torch.autograd.grad((o ** 2).sum(), [xs] + list(params.values()))
        return o.detach(), g

    dense_o, dense_g = uncounted(grads_of, lambda: layer.forward(
        params, {}, xs)[0])
    for impl in ("ring", "ulysses"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o, g = grads_of(lambda: sequence_parallel_self_attention(
            layer, params, xs, mesh=seq_mesh, impl=impl))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        f_err = allclose_excess(o.double().cpu().numpy(),
                                dense_o.double().cpu().numpy(),
                                SEQ_TOL[0], SEQ_TOL[0])
        g_err = max(allclose_excess(a.double().cpu().numpy() / float(
            b.abs().max()), b.double().cpu().numpy() / float(b.abs().max()),
            SEQ_TOL[1], SEQ_TOL[1]) for a, b in zip(g, dense_g))
        check(f_err <= 0 and g_err <= 0,
              f"17c {impl}: forward excess {f_err:.3g}, gradient excess "
              f"{g_err:.3g} over JAX's tolerances")
        out[impl] = dict(forward_excess=f_err, grad_excess=g_err,
                         wall_ms=wall * 1e3)
    # the pipeline over LeNet
    pdevs, phow = mesh_entries(PIPE17["stages"])
    data = mnist_nhwc(True, PIPE17["batch"] * PIPE17["steps"],
                      PIPE17["batch"])
    one = LeNet(dtype="float64").init(device=pdevs[0])
    start = {k: {n: t.clone() for n, t in v.items()}
             for k, v in one.params.items()}
    pnet = one.clone()
    pt = PipelineTrainer(pnet, n_stages=PIPE17["stages"],
                         n_micro=PIPE17["micro"], devices=pdevs)
    for ds in data:
        uncounted(one.do_step, ds.features, ds.labels)
        pt.do_step(ds.features, ds.labels)
    pt._sync_back()
    pipe_err = max(float((pnet.params[k][n] - one.params[k][n]).abs().max()
                         / (one.params[k][n] - start[k][n]).abs().max()
                         .clamp_min(1e-30))
                   for k in start for n in start[k])
    check(pipe_err <= PIPE_REL, f"17c: pipeline LeNet vs one card: worst "
                                f"leaf {pipe_err:.3g} of its largest change")
    out["pipeline"] = dict(rel_err=pipe_err, stages=pt.stages, entries=phow)
    log(f"  17c ({how}): tp MLP step max |err| {mlp_err:.3g}; ring and "
        f"Ulysses on the slice layer at T = {SEQ_T} over 4 seq entries, "
        f"excess over (2e-5, 3e-5): ring {out['ring']['forward_excess']:.3g}"
        f"/{out['ring']['grad_excess']:.3g}, ulysses "
        f"{out['ulysses']['forward_excess']:.3g}/"
        f"{out['ulysses']['grad_excess']:.3g}, forward+backward "
        f"{out['ring']['wall_ms']:.1f} / {out['ulysses']['wall_ms']:.1f} ms "
        f"wall; LeNet pipeline {PIPE17['stages']} x {PIPE17['micro']} "
        f"({phow}, f64) worst leaf |err| {pipe_err:.3g} of its largest "
        f"change after {PIPE17['steps']} AdaDelta steps; [{card}]")
    return out


def phase_scaleout(card):
    """17d: parameter averaging through ``SparkComputationGraph`` on the
    phase-7 model against one machine, Word2Vec at 14a's corpus and width
    over tables sharded on 2 entries against unsharded, and the parameter
    server's wrapper on the phase-7 model."""
    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.nlp import CollectionSentenceIterator, Word2Vec
    from deeplearning4j_torch.nlp.distributed import shard_embedding_tables
    from deeplearning4j_torch.parallel.mesh import DATA_AXIS, Mesh
    from deeplearning4j_torch.parallel.parameter_server import (
        ParameterServerParallelWrapper)
    from deeplearning4j_torch.parallel.spark import (
        ParameterAveragingTrainingMaster, SparkComputationGraph)

    W = MESH_WORKERS
    mesh, how = mesh_of(W, DATA_AXIS)
    rounds, split = mesh_rounds()
    params = numpy_params(fabric_net(), seed=0)
    # Spark averaging every round against one machine on each round's
    # concatenated batch (16e's Sgd and JAX's averaging tolerance)
    spark = mesh_slice_net(params, "cuda", "averaging")
    t0 = time.perf_counter()
    SparkComputationGraph(spark, ParameterAveragingTrainingMaster(
        batch_size_per_worker=TRAIN_BATCH // W, averaging_frequency=1,
        mesh=mesh)).fit([ds for x, y in rounds for ds in split(x, y)])
    torch.cuda.synchronize()
    spark_s = time.perf_counter() - t0
    single = mesh_slice_net(params, "cuda", "averaging")
    for x, y in rounds:
        uncounted(single.do_step, x, y)
    rtol, atol = MESH_TOL["averaging"]
    spark_err = worst_rule(spark.params, single.params, rtol, atol)
    check(spark_err <= 0, f"17d: Spark averaging vs one machine exceeds "
                          f"{MESH_TOL['averaging']} by {spark_err:.3g}")
    del spark, single
    # Word2Vec at 14a's corpus and width over tables sharded on 2 entries
    mdevs, mhow = mesh_entries(2)
    sents = zipf_text(W2V["sentences"], W2V["words"], W2V["vocab"],
                      W2V["seed"])

    def w2v():
        w = Word2Vec(layer_size=W2V["layer"], window=W2V["window"],
                     min_word_frequency=W2V["min_freq"],
                     negative=W2V["negative"], use_hierarchic_softmax=False,
                     epochs=1, batch_size=W2V["batch"], seed=3,
                     backend="device", device=mdevs[0])
        w.build_vocab(sents)
        w.reset_weights()
        return w

    def timed_fit(w):
        torch.cuda.synchronize()
        t = time.perf_counter()
        w.fit(CollectionSentenceIterator(sents))
        torch.cuda.synchronize()
        return time.perf_counter() - t

    plain, sharded = w2v(), w2v()
    plain_s = timed_fit(plain)
    shard_embedding_tables(sharded, Mesh(mdevs, ("model",)))
    sharded_s = timed_fit(sharded)
    V = plain.syn0.shape[0]
    w_err, scale = 0.0, 0.0
    for t in ("syn0", "syn1neg"):
        ref = getattr(plain, t)
        w_err = max(w_err, float((getattr(sharded, t).gather(ref.device)[:V]
                                  - ref).abs().max()))
        scale = max(scale, float(ref.abs().max()))
    check(w_err <= W2V_SHARDED_ATOL,
          f"17d: sharded Word2Vec tables differ by {w_err:.3g} > "
          f"{W2V_SHARDED_ATOL} (max|table| {scale:.3g})")
    words = len(sents) * W2V["words"]
    del plain, sharded
    # the parameter server's wrapper on the phase-7 model with its Adam
    ps_net = mesh_slice_net(params, "cuda", "shared_gradients")
    batches = [ds for x, y in rounds for ds in split(x, y)]
    merged = DataSet(*train_batch())
    s0 = float(ps_net.score(merged))
    wrapper = ParameterServerParallelWrapper(ps_net, workers=2, alpha=0.5)
    t0 = time.perf_counter()
    wrapper.fit(batches, epochs=2)
    torch.cuda.synchronize()
    ps_s = time.perf_counter() - t0
    pulled = wrapper.server.pull()
    s1 = float(ps_net.score(merged))
    check(wrapper.server.pushes == 2 * len(batches)
          and np.array_equal(ps_net.params_flat().astype(np.float32), pulled)
          and s1 < s0 and all(r.device == ps_net.device
                              for r in wrapper.replicas),
          f"17d: parameter server pushes {wrapper.server.pushes}, score "
          f"{s0:.4f} -> {s1:.4f}")
    log(f"  17d: Spark averaging of the phase-7 model over {W} workers "
        f"({how}), 2 rounds in {spark_s:.2f} s, vs one machine excess "
        f"{spark_err:.3g} over {MESH_TOL['averaging']}; Word2Vec "
        f"({len(sents)} x {W2V['words']} words, vocab {V}, layer "
        f"{W2V['layer']}) over tables sharded on 2 entries ({mhow}): "
        f"{words / sharded_s:.0f} words/s against {words / plain_s:.0f} "
        f"unsharded, max |table diff| {w_err:.3g} (max|table| "
        f"{scale:.3g}); parameter server on the phase-7 model, 2 workers: "
        f"{wrapper.server.pushes} pushes in {ps_s:.2f} s, score "
        f"{s0:.4f} -> {s1:.4f}, pulled params in the net; [{card}]")
    return dict(spark_excess=spark_err, spark_s=spark_s, w2v_max_diff=w_err,
                w2v_max_table=scale, w2v_words_s=words / sharded_s,
                w2v_plain_words_s=words / plain_s,
                ps_pushes=wrapper.server.pushes, ps_s=ps_s,
                ps_score=(s0, s1))


def phase_model_parallelism(card):
    """Phase 17: sharded stores and one-process model parallelism
    (17a-17d); mesh entries are distinct cards where the machine has
    enough, else ``cuda:0`` repeated, and every line says which."""
    from deeplearning4j_torch import kernels

    kernels.load()
    t0 = time.perf_counter()
    log(f"phase 17a: sharded retrieval stores over {SHARD_ENTRIES} data "
        f"entries ({mesh_entries(SHARD_ENTRIES)[1]})")
    walls = {}
    t = time.perf_counter()
    pts, qs = knn_store()
    out = dict(stores=shard_store_checks(pts, qs, card))
    del pts
    walls["17a_flat"] = time.perf_counter() - t
    t = time.perf_counter()
    out["ivf"] = shard_ivf_checks(card)
    walls["17a_ivf"] = time.perf_counter() - t
    log("phase 17b: dp x tp ShardedTrainer on the slice TransformerLM")
    t = time.perf_counter()
    out["sharded_trainer"] = phase_sharded_trainer(card)
    walls["17b"] = time.perf_counter() - t
    log("phase 17c: tensor-parallel MLP, ring and Ulysses attention, the "
        "LeNet pipeline")
    t = time.perf_counter()
    out["model_parallel"] = phase_model_parallel(card)
    walls["17c"] = time.perf_counter() - t
    log("phase 17d: Spark averaging, sharded Word2Vec tables, the "
        "parameter server")
    t = time.perf_counter()
    out["scaleout"] = phase_scaleout(card)
    walls["17d"] = time.perf_counter() - t
    out["wall_s"] = time.perf_counter() - t0
    out["part_wall_s"] = walls
    log(f"  phase 17: {out['wall_s']:.1f} s "
        f"{json.dumps({k: round(v, 1) for k, v in walls.items()})}; "
        f"[{card}]")
    return out


# ---------------------------------------------------------------- phase 18
#: 18a: phase 7's model and batch size in a ``FaultTolerantTrainer`` child
#: process: ``batches`` seeded batches an epoch, ``epochs`` epochs, a
#: checkpoint every ``frequency`` iterations (a checkpoint of the model and
#: its Adam state takes ~1 s to write, so every 4th, not JAX's test's 2nd),
#: run 1 killed with ``os._exit(137)`` once iteration ``crash_at`` is done
#: (so run 2 resumes mid-epoch); heartbeats every ``beat_s``, aged out by a
#: detector of ``stale_s``
ELASTIC18 = dict(batches=6, epochs=2, frequency=4, crash_at=5, beat_s=0.05,
                 stale_s=0.5)
#: 18c: the crash drill's hosts publish a snapshot every step, one step a
#: dispatch, each dispatch stalled ``stall_s`` by a seeded ChaosPolicy so
#: the kill lands mid-stream
DRILL18 = dict(snapshot_every=1, steps_per_dispatch=1, stall_s=0.005)
#: 18b and 18c: host processes behind one router, each serving phase 9's
#: fleet (``FLEET_REPLICAS`` replicas)
FED_HOSTS = 2
#: phase 18's device and the module its child processes import: the card
#: and this script (a CPU rehearsal names the CPU and a wrapper module)
DEVICE18 = "cuda"
MODULE18 = "chip_smoke"
#: the K1/K3/K4 and K2 counters a child reports
PATH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_attn",
                "paged_attn_chunk", "paged_attn_merge")


def load_built_kernels():
    """Load the extension phase 1 built into ``kernels/build/`` in a child
    process, and raise if loading rebuilt any object of it. Returns the
    seconds the load took."""
    from deeplearning4j_torch import kernels

    def objects():
        if not os.path.isdir(kernels.BUILD_DIR):
            return {}
        return {f: os.stat(os.path.join(kernels.BUILD_DIR, f)).st_mtime_ns
                for f in os.listdir(kernels.BUILD_DIR)
                if f.endswith((".so", ".o"))}

    before = objects()
    t0 = time.perf_counter()
    kernels.load()
    load_s = time.perf_counter() - t0
    after = objects()
    if not before or after != before:
        raise RuntimeError(
            f"a child process rebuilt the kernels instead of loading phase "
            f"1's build (objects before {sorted(before)}, after "
            f"{sorted(after)})")
    return load_s


def elastic_batches():
    """18a's stream: ``ELASTIC18["batches"]`` phase-7-sized batches (one-hot
    tokens and next-token labels, [16, 128, 256]) from RandomState(17)."""
    from deeplearning4j_torch.datasets.dataset import DataSet

    rs = np.random.RandomState(17)
    V, T = SLICE["num_labels"], SLICE["max_length"]
    eye = np.eye(V, dtype=np.float32)
    out = []
    for _ in range(ELASTIC18["batches"]):
        tok = rs.randint(0, V, (TRAIN_BATCH, T + 1))
        out.append(DataSet(eye[tok[:, :-1]], eye[tok[:, 1:]]))
    return out


def elastic_child(directory, crash_at, name, gate="now"):
    """One 18a run, in its own process: phase 7's model (phase 5's
    weights) trained by a ``FaultTolerantTrainer`` over ``elastic_batches``
    with checkpoints in ``directory/ckpt``, beating into
    ``directory/../hb/<name>.heartbeat``. ``crash_at > 0`` ends the process
    with ``os._exit(137)`` after that iteration. ``gate="wait"`` sets up
    (imports, the card, the kernels, the net) and then waits for a line on
    stdin before it looks at the checkpoints. Prints one ``ELASTIC`` JSON
    line (the process's own kernel launches included) and saves the final
    weights to ``directory/final.npy``."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.datasets.iterators import ListDataSetIterator
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.optimize.listeners import TrainingListener
    from deeplearning4j_torch.parallel.elastic import (
        CheckpointStore, FaultTolerantTrainer, Heartbeat)
    from deeplearning4j_torch.utils.convert import params_from_jax

    crash_at = int(crash_at)
    t_start = time.perf_counter()
    load_s = load_built_kernels()
    net = TransformerLM(**SLICE).init(device=DEVICE18)
    params_from_jax(numpy_params(net, seed=0), net)
    batches = elastic_batches()
    if gate == "wait":
        sys.stdin.readline()
    hb_dir = os.path.join(os.path.dirname(directory), "hb")
    os.makedirs(hb_dir, exist_ok=True)
    beat = Heartbeat(os.path.join(hb_dir, f"{name}.heartbeat"),
                     interval=ELASTIC18["beat_s"]).start()
    store = CheckpointStore(os.path.join(directory, "ckpt"), keep=3)
    latest = store.latest()
    resumed_from = None
    if latest is not None:
        with zipfile.ZipFile(latest) as zf:
            resumed_from = dict(json.loads(zf.read("elastic.json")),
                                iteration=int(os.path.basename(latest)[5:15]))
    report = dict(run=name, crash_at=crash_at, load_s=load_s,
                  resumed_from=resumed_from, trained=0)

    def emit(**kw):
        torch.cuda.synchronize()
        report.update(kw, launches={k: kernels.LAUNCHES[k]
                                    for k in PATH_KERNELS},
                      wall_s=time.perf_counter() - t_start)
        print("ELASTIC " + json.dumps(report), flush=True)

    class Steps(TrainingListener):
        def iteration_done(self, model, iteration):
            report["trained"] += 1
            if iteration == crash_at:
                emit(killed_at=iteration)
                os._exit(137)   # a simulated SIGKILL: no cleanup

    net.set_listeners(Steps())
    trainer = FaultTolerantTrainer(net, store,
                                   frequency=ELASTIC18["frequency"])
    t0 = time.perf_counter()
    final = trainer.run(lambda: ListDataSetIterator(list(batches),
                                                    batch_size=TRAIN_BATCH),
                        epochs=ELASTIC18["epochs"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    flat = np.asarray(final.params_flat(), np.float32)
    np.save(os.path.join(directory, "final.npy"), flat)
    beat.stop()
    emit(iteration=final.iteration, train_s=train_s,
         finite=bool(np.isfinite(flat).all()))
    return 0


def start_elastic(tmp, run, crash_at, gate="now"):
    """Start one 18a run as ``python3 -c`` in its own process (no fork of
    this CUDA process); ``gate="wait"`` holds it, set up, until a line
    reaches its stdin."""
    root = os.path.dirname(os.path.abspath(__file__))
    directory = os.path.join(tmp, "elastic", "run3" if run == 3 else "run")
    os.makedirs(directory, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root] + sys.path))
    code = (f"import sys, {MODULE18} as c; "
            "sys.exit(c.elastic_child(*sys.argv[1:]))")
    return subprocess.Popen(
        [sys.executable, "-c", code, directory, str(crash_at), f"run{run}",
         gate], cwd=root, env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def elastic_report(proc, what, rc):
    out, err = proc.communicate(timeout=300)
    check(proc.returncode == rc,
          f"{what}: exit code {proc.returncode}, expected {rc}; stderr "
          f"tail: {err[-2000:]}")
    lines = [ln for ln in out.splitlines() if ln.startswith("ELASTIC ")]
    check(len(lines) == 1, f"{what}: no ELASTIC line; stdout tail "
                           f"{out[-2000:]} stderr tail {err[-2000:]}")
    return json.loads(lines[0][len("ELASTIC "):])


def elastic_runs(tmp, procs):
    """Watch run 1 (``procs[0]``) beat and die, then let run 2
    (``procs[1]``, waiting at its gate) go, and collect all three reports,
    with how often run 1's heartbeat was seen advancing and how long after
    its exit it aged out."""
    from deeplearning4j_torch.parallel.elastic import FailureDetector

    p1, p2, p3 = procs
    det = FailureDetector(os.path.join(tmp, "elastic", "hb"),
                          timeout=ELASTIC18["stale_s"])
    fresh_scans = 0
    last_ts = None
    while p1.poll() is None:
        info = det.workers().get("run1")
        dead = det.dead_workers()
        if info and "run1" not in dead and info["ts"] != last_ts:
            fresh_scans += 1
            last_ts = info["ts"]
        time.sleep(0.02)
    r1 = elastic_report(p1, "18a run 1", 137)
    t_dead = time.perf_counter()
    wait_for(lambda: "run1" in det.dead_workers(), 10,
             "run 1's heartbeat to age out after the kill")
    aged_s = time.perf_counter() - t_dead
    check(fresh_scans >= 2, f"18a: run 1's heartbeat was seen advancing "
                            f"{fresh_scans} times while it trained")
    p2.stdin.write("go\n")
    p2.stdin.flush()
    r2 = elastic_report(p2, "18a run 2", 0)
    r3 = elastic_report(p3, "18a run 3", 0)
    return r1, r2, r3, fresh_scans, aged_s


def phase_elastic(tmp, card):
    """18a: run 1 dies with ``os._exit(137)`` after iteration
    ``crash_at``; run 2, the same command (started beside it and held at
    its gate until then), resumes from its checkpoint;
    run 3 trains uninterrupted in a fresh directory (beside run 1). Runs 2
    and 3 end at the same iteration, run 2 trains only the batches after
    its checkpoint, and their weights agree at phase 7's tolerance
    (bitwise or not, said). A ``FailureDetector`` sees run 1's heartbeat
    alive while it trains and aged out after the kill."""
    t0 = time.perf_counter()
    # run 2 starts with the others and waits, set up, for run 1's death:
    # a process takes ~10 s to reach the card beside the others
    procs = [start_elastic(tmp, 1, ELASTIC18["crash_at"]),
             start_elastic(tmp, 2, 0, gate="wait"),
             start_elastic(tmp, 3, 0)]
    try:
        r1, r2, r3, fresh_scans, aged_s = elastic_runs(tmp, procs)
    finally:
        for proc in procs:     # none outlives a failed check
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    total = ELASTIC18["batches"] * ELASTIC18["epochs"]
    # the newest periodic checkpoint before the kill
    resume_at = (ELASTIC18["crash_at"] // ELASTIC18["frequency"]
                 * ELASTIC18["frequency"])
    resumed = r2["resumed_from"] or {}
    check(r1["trained"] == ELASTIC18["crash_at"]
          and r3["trained"] == total and r3["iteration"] == total
          and r2["iteration"] == total
          and resumed.get("iteration", -1) + r2["trained"] == total
          and resumed.get("iteration") == resume_at,
          f"18a: iterations: run 1 trained {r1['trained']}, run 2 resumed "
          f"from {resumed} and trained {r2['trained']} to "
          f"{r2['iteration']}, run 3 trained {r3['trained']} to "
          f"{r3['iteration']} (expected {total}, each batch once)")
    w2 = np.load(os.path.join(tmp, "elastic", "run", "final.npy"))
    w3 = np.load(os.path.join(tmp, "elastic", "run3", "final.npy"))
    bitwise = bool(np.array_equal(w2, w3))
    rel = float(np.abs(w2 - w3).max() / np.abs(w3).max())
    check(r2["finite"] and r3["finite"] and rel <= 1e-4,
          f"18a: resumed weights vs uninterrupted max|err|/max|w| "
          f"{rel:.3g} > 1e-4")
    for r in (r1, r2, r3):
        check(all(r["launches"][k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                                 "flash_bwd_dkv")),
              f"18a {r['run']}: K1/K3/K4 did not all launch in the child: "
              f"{r['launches']}")
    wall = time.perf_counter() - t0
    log(f"  18a: run 1 killed after iteration {r1['killed_at']} "
        f"(heartbeat seen advancing {fresh_scans} times, aged out "
        f"{aged_s:.2f} s after the exit); run 2 resumed at iteration "
        f"{resumed.get('iteration')} (epoch {resumed.get('epoch')}, batch "
        f"{resumed.get('batch_in_epoch')}) and trained {r2['trained']} "
        f"steps to {r2['iteration']}; run 3 {r3['iteration']}; weights "
        f"bitwise {bitwise}, max rel {rel:.3g}; child K1/K3/K4 launches "
        f"{[r['launches']['flash_fwd'] for r in (r1, r2, r3)]}/"
        f"{[r['launches']['flash_bwd_dq'] for r in (r1, r2, r3)]}/"
        f"{[r['launches']['flash_bwd_dkv'] for r in (r1, r2, r3)]}; "
        f"kernel load {[round(r['load_s'], 2) for r in (r1, r2, r3)]} s; "
        f"{wall:.1f} s; [{card}]")
    return dict(runs=dict(run1=r1, run2=r2, run3=r3), bitwise=bitwise,
                max_rel_err=rel, heartbeat_fresh_scans=fresh_scans,
                heartbeat_aged_out_s=aged_s, wall_s=wall)


def fed_fleet(*, device, snapshot_every=0,
              steps_per_dispatch=SERVER["steps_per_dispatch"], stall_s=0.0):
    """Phase 18's host builder (``chip_smoke:fed_fleet`` in a
    ``spawn_host`` spec): phase 9's fleet, ``FLEET_REPLICAS`` phase-5
    servers of the slice model on phase 5's weights, on the card; it
    loads phase 1's kernel build and never rebuilds it. The fleet's
    ``stats()`` (which the router's stats RPC returns) carries this
    process's kernel launches and its extension's load time."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.parallel.fleet import ReplicaFleet
    from deeplearning4j_torch.parallel.generation import GenerationServer
    from deeplearning4j_torch.parallel.resilience import ChaosPolicy
    from deeplearning4j_torch.utils.convert import params_from_jax

    if torch.device(device).type != torch.device(DEVICE18).type:
        raise RuntimeError(f"phase 18's hosts serve on {DEVICE18}, not "
                           f"{device}")
    load_s = load_built_kernels()
    net = TransformerLM(**SLICE).init(device=device)
    params_from_jax(numpy_params(net, seed=0), net)

    class CountedFleet(ReplicaFleet):
        def stats(self):
            st = super().stats()
            st["kernel_launches"] = {k: kernels.LAUNCHES[k]
                                     for k in PATH_KERNELS}
            st["kernel_load_s"] = load_s
            return st

    def factory(rid):
        chaos = (ChaosPolicy(seed=1000 + rid, stall_rate=1.0,
                             stall_s=stall_s) if stall_s else None)
        return GenerationServer(
            net, SLICE["num_labels"], device=device, chaos=chaos,
            snapshot_every=snapshot_every,
            **dict(SERVER, steps_per_dispatch=steps_per_dispatch))

    return CountedFleet(factory, replicas=FLEET_REPLICAS)


def spawn_hosts(tmp, prefix, **builder_kwargs):
    """Start ``FED_HOSTS`` host processes (``spawn_host`` on the card, the
    builder ``fed_fleet``) without waiting: one future a host."""
    from concurrent.futures import ThreadPoolExecutor
    from deeplearning4j_torch.parallel.federation import spawn_host

    hb = os.path.join(tmp, f"hb_{prefix}")
    spec = {"heartbeat_dir": hb, "heartbeat_interval": 0.05,
            "builder": f"{MODULE18}:fed_fleet",
            "builder_kwargs": builder_kwargs}
    pool = ThreadPoolExecutor(max_workers=FED_HOSTS)
    t0 = time.perf_counter()

    def one(i):
        hh = spawn_host(dict(spec, hid=f"{prefix}{i}"), timeout=240,
                        device=DEVICE18)
        return hh, time.perf_counter() - t0

    futs = [pool.submit(one, i) for i in range(FED_HOSTS)]
    pool.shutdown(wait=False)
    return hb, futs


def host_k2(launches):
    """A host's K2 launches by route (decode: every K2 call but the chunk
    route's)."""
    return dict(decode=launches["paged_attn"] - launches["paged_attn_chunk"],
                chunk=launches["paged_attn_chunk"])


def check_routes(tag, per_host):
    check(all(v["decode"] > 0 and v["chunk"] > 0
              for v in per_host.values()),
          f"{tag}: K2 did not launch on both routes in every host process: "
          f"{per_host}")


def ledger_of(fed, tag, n):
    st = fed.stats()["federation"]
    check(st["submitted"] == st["completed"] + st["failed"] + st["expired"]
          + st["rejected_submits"] and st["inflight"] == 0
          and st["parked"] == 0 and st["completed"] == n
          and st["failed"] == 0 and st["expired"] == 0,
          f"{tag}: federated ledger {st}")
    return st


def phase_routing(handles, hb, reqs, want, fabric_tps, card):
    """18b: one ``FleetFederation`` routes phase 9's traffic over the two
    hosts: every stream equal to phase 5's/5b's, both hosts dispatched,
    the ledger balanced; tokens/s beside phase 9a's in-process fleet and
    beside the same traffic through a router over one host. The K2 counts
    are read before the one-host run."""
    from deeplearning4j_torch.parallel.federation import FleetFederation

    ntok = sum(len(w) for w in want)
    fed = FleetFederation(handles, heartbeat_dir=hb, dead_after_s=600.0)
    try:
        wait_for(lambda: fed.stats()["federation"]["ready"] == FED_HOSTS,
                 30, "18b's hosts READY")
        t0 = time.perf_counter()
        futs = [fed.submit(p, n, deadline_s=300.0, **o) for p, n, o in reqs]
        outs = [f.result(timeout=300).tolist() for f in futs]
        wall = time.perf_counter() - t0
        check(outs == want, "18b: a federated stream differs from phase "
                            "5's/5b's")
        st = ledger_of(fed, "18b", len(reqs))
        per = {b["hid"]: b for b in fed.stats()["hosts"]}
        check(all(b["dispatched"] > 0 for b in per.values()),
              f"18b: a host took no request: "
              f"{ {h: b['dispatched'] for h, b in per.items()} }")
        host = {h.hid: fed.host_stats(h.hid, timeout=10) for h in handles}
    finally:
        fed.close()
    # the same traffic through a router over the first host alone: the
    # router's and the wire's cost without a second process on the card
    with FleetFederation(handles[:1], dead_after_s=600.0) as one:
        wait_for(lambda: one.stats()["federation"]["ready"] == 1, 30,
                 "18b's first host READY again")
        t0 = time.perf_counter()
        futs = [one.submit(p, n, deadline_s=300.0, **o) for p, n, o in reqs]
        outs = [f.result(timeout=300).tolist() for f in futs]
        one_wall = time.perf_counter() - t0
        check(outs == want, "18b: a stream through one host differs from "
                            "phase 5's/5b's")
        ledger_of(one, "18b one host", len(reqs))
    launches = {h: s["kernel_launches"] for h, s in host.items()}
    k2 = {h: host_k2(v) for h, v in launches.items()}
    check_routes("18b", k2)
    tps = ntok / wall
    in_process = ("not measured in this run" if fabric_tps is None
                  else f"{fabric_tps:.1f} tok/s")
    log(f"  18b: {len(reqs)} requests ({ntok} tokens) over {FED_HOSTS} host "
        f"processes x {FLEET_REPLICAS} replicas: {tps:.1f} tok/s, over one "
        f"of them {ntok / one_wall:.1f} tok/s (phase 9a's in-process fleet: "
        f"{in_process}); dispatched "
        f"{[per[h]['dispatched'] for h in sorted(per)]}; "
        f"every stream equal to phase 5's/5b's; K2 by host {k2}; kernel "
        f"load {[round(host[h]['kernel_load_s'], 2) for h in sorted(host)]} "
        f"s; [{card}]")
    return dict(requests=len(reqs), tokens=ntok, wall_s=wall,
                tokens_per_s=tps, one_host_wall_s=one_wall,
                one_host_tokens_per_s=ntok / one_wall,
                fabric_tokens_per_s=fabric_tps,
                dispatched={h: per[h]["dispatched"] for h in per},
                launches=launches, k2=k2,
                load_s={h: host[h]["kernel_load_s"] for h in host},
                federation=st)


def phase_crash(handles, hb, reqs, want, card):
    """18c: the crash drill at full width (JAX's
    ``test_sigkill_whole_process_bit_exact``): snapshots every step, the
    victim SIGKILLed once the router holds published snapshots of at
    least 2 requests in flight on it; every stream equal to phase
    5's/5b's, handoff resumes, a death, degraded mode, a balanced ledger
    and no lost future; one scrape shows both hosts' families."""
    from deeplearning4j_torch.metrics.exposition import render_text
    from deeplearning4j_torch.parallel.federation import FleetFederation

    survivor, victim = handles
    fed = FleetFederation(handles, heartbeat_dir=hb, suspect_after_s=0.5,
                          dead_after_s=600.0)
    try:
        wait_for(lambda: fed.stats()["federation"]["ready"] == FED_HOSTS
                 and len(fed.metrics_sources()) == FED_HOSTS + 1, 30,
                 "18c's hosts READY and gossiping")

        def victim_snapshots():
            with fed._cond:
                return sum(fq.hid == victim.hid
                           and fq.snapshot_blob is not None
                           for fq in fed._rpc.values())

        t0 = time.perf_counter()
        futs = [fed.submit(p, n, deadline_s=300.0, **o) for p, n, o in reqs]
        wait_for(lambda: victim_snapshots() >= 2, 120,
                 "the router to hold snapshots of 2 requests in flight on "
                 "the victim")
        at_kill = fed.host_stats(victim.hid, timeout=10)
        t_kill = time.perf_counter() - t0
        victim.kill()
        outs = [f.result(timeout=300).tolist() for f in futs]
        wall = time.perf_counter() - t0
        check(not victim.alive, "18c: the victim outlived its SIGKILL")
        check(outs == want, "18c: a stream differs from phase 5's/5b's "
                            "after the SIGKILL")
        st = ledger_of(fed, "18c", len(reqs))
        check(st["deaths"] >= 1 and st["handoff_resumes"] >= 1
              and st["degraded_mode"] is True,
              f"18c: deaths {st['deaths']}, handoff resumes "
              f"{st['handoff_resumes']}, degraded {st['degraded_mode']}")
        text = render_text(fed.metrics_sources())
        fams = {h.hid: f'fleet_submitted_total{{host="{h.hid}"}}' in text
                for h in handles}
        check(all(fams.values()) and "fed_handoff_resumes_total" in text,
              f"18c: one scrape lacks a host's families: {fams}")
        after = fed.host_stats(survivor.hid, timeout=10)
    finally:
        fed.close()
    launches = {victim.hid: at_kill["kernel_launches"],
                survivor.hid: after["kernel_launches"]}
    k2 = {h: host_k2(v) for h, v in launches.items()}
    check_routes("18c", k2)
    ntok = sum(len(w) for w in want)
    log(f"  18c: {victim.hid} SIGKILLed {t_kill:.2f} s in with "
        f"{st['snapshots']} snapshots at the router; {len(reqs)} streams "
        f"equal to phase 5's/5b's; deaths {st['deaths']}, handoff resumes "
        f"{st['handoff_resumes']}, fallbacks {st['handoff_fallbacks']}, "
        f"redispatched {st['redispatched']}, degraded "
        f"{st['degraded_mode']}, ledger balanced, none lost; one scrape "
        f"shows {sorted(fams)}; K2 by host {k2} ({victim.hid}'s at the "
        f"kill); {ntok / wall:.1f} tok/s through the kill; kernel load "
        f"{round(at_kill['kernel_load_s'], 2)}, "
        f"{round(after['kernel_load_s'], 2)} s; [{card}]")
    return dict(wall_s=wall, kill_after_s=t_kill, tokens_per_s=ntok / wall,
                launches=launches, k2=k2,
                load_s={victim.hid: at_kill["kernel_load_s"],
                        survivor.hid: after["kernel_load_s"]},
                federation=st)


def phase_federation(card, greedy=None, sampled=None, fabric_tps=None):
    """Phase 18: processes on one host (18a-18c). The four host processes
    and 18a's first two runs start together; 18b runs once 18a is done and
    18c after 18b's hosts are gone. Returns (report, launches summed over
    every child process of the phase)."""
    from deeplearning4j_torch import kernels

    kernels.load()
    t0 = time.perf_counter()
    reqs, want = fabric_requests(
        fabric_net() if greedy is None or sampled is None else None,
        greedy, sampled)
    tmp = tempfile.mkdtemp(prefix="chip18_")
    hb_b, fut_b = spawn_hosts(tmp, "b")
    hb_c, fut_c = spawn_hosts(tmp, "c", stall_s=DRILL18["stall_s"],
                              snapshot_every=DRILL18["snapshot_every"],
                              steps_per_dispatch=DRILL18[
                                  "steps_per_dispatch"])
    out = {}
    walls = {}
    try:
        log("phase 18a: a FaultTolerantTrainer child killed and resumed "
            "(phase 7's model)")
        t = time.perf_counter()
        out["elastic"] = phase_elastic(tmp, card)
        walls["18a"] = time.perf_counter() - t
        b = [f.result(timeout=240) for f in fut_b]
        c = [f.result(timeout=240) for f in fut_c]
        spawn_s = {h.hid: s for h, s in b + c}
        log(f"  host processes READY after "
            f"{json.dumps({k: round(v, 1) for k, v in spawn_s.items()})} s")
        log("phase 18b: one router over two host processes, phase 9's "
            "traffic")
        t = time.perf_counter()
        out["routing"] = phase_routing([h for h, _ in b], hb_b, reqs, want,
                                       fabric_tps, card)
        walls["18b"] = time.perf_counter() - t
        for h, _ in b:
            h.terminate()
        log("phase 18c: the crash drill, a host process SIGKILLed "
            "mid-stream")
        t = time.perf_counter()
        out["crash"] = phase_crash([h for h, _ in c], hb_c, reqs, want,
                                   card)
        walls["18c"] = time.perf_counter() - t
    finally:
        # every host spawned, whether or not a phase got to use it
        for f in fut_b + fut_c:
            try:
                h = f.result(timeout=240)[0]
            except Exception:
                continue
            if h.alive:
                h.terminate()
        shutil.rmtree(tmp, ignore_errors=True)
    children = dict(out["elastic"]["runs"])
    children.update({f"18b_{h}": v for h, v in
                     out["routing"]["launches"].items()})
    children.update({f"18c_{h}": v for h, v in
                     out["crash"]["launches"].items()})
    out["children_launches"] = {k: v.get("launches", v)
                                for k, v in children.items()}
    total = {k: sum(v[k] for v in out["children_launches"].values())
             for k in PATH_KERNELS}
    out["spawn_s"] = spawn_s
    out["wall_s"] = time.perf_counter() - t0
    out["part_wall_s"] = walls
    log(f"  phase 18: {out['wall_s']:.1f} s "
        f"{json.dumps({k: round(v, 1) for k, v in walls.items()})}; "
        f"child launches {total}; [{card}]")
    return out, total


# ---------------------------------------------------------------- phase 19
#: 19: process groups. Two ranks train phase 7's model (phase 5's
#: weights) on phase 7's batch split by rows, with the conf's Adam, for
#: ``steps`` steps and save a checkpoint after step ``save_at``; a fresh
#: pair of ranks restores it into its sharded net and takes the last step
#: again. Children are joined within ``timeout_s``; the group's
#: collectives time out after ``group_timeout_s``. Both ranks against one
#: process on the whole batch: JAX's Adam tolerance for data parallelism
#: (ROADMAP C5)
GROUP19 = dict(steps=5, save_at=4, timeout_s=240, group_timeout_s=120)
GROUP_TOL = (1e-4, 1e-5)
#: 19b: a resumed step against the uninterrupted one where a rank drives
#: two cards (the dp x tp leg): there two runs of one step part by an ulp
#: or so (2.98e-08 and 5.96e-08 on four H100s), as a tensor takes
#: gradients from both cards' autograd threads; a rank of one device is
#: held bitwise
GROUP_RESUME_ATOL = 1e-6
#: phase 19's device and the module its child processes import (a CPU
#: rehearsal names the CPU and a wrapper module)
DEVICE19 = "cuda"
MODULE19 = "chip_smoke"


def group_legs():
    """Phase 19's legs on this machine: two gloo ranks sharing the first
    card (NCCL refuses two ranks on one device) always; with two cards one
    card a rank over NCCL; with four, two ranks of two cards each under
    ``data_model_mesh(2, 2)`` (the data rows are the processes)."""
    if DEVICE19 != "cuda":
        return [dict(name="gloo_host", backend="gloo",
                     devices=[[DEVICE19], [DEVICE19]], mesh="data")]
    n = torch.cuda.device_count()
    legs = [dict(name="gloo_one_card", backend="gloo",
                 devices=[["cuda:0"], ["cuda:0"]], mesh="data")]
    if n >= 2:
        legs.append(dict(name="nccl_card_a_rank", backend="nccl",
                         devices=[["cuda:0"], ["cuda:1"]], mesh="data"))
    if n >= 4:
        legs.append(dict(name="nccl_dp2_tp2", backend="nccl",
                         devices=[["cuda:0", "cuda:1"],
                                  ["cuda:2", "cuda:3"]],
                         mesh="data_model"))
    return legs


def group_child(leg, role, rank, port, directory):
    """One rank of a phase-19 pair, in its own process: phase 1's kernel
    build loaded, the group joined through ``distributed.initialize`` (the
    parent's ``TCPStore`` under a prefix of the leg and role, so no two
    groups race for a port), phase 7's model on phase 5's weights sharded
    over ``data_mesh()`` (or ``data_model_mesh(2, 2)``), steps through
    ``do_step`` on ``make_array_from_process_local_data`` arrays of this
    rank's rows. ``role="train"`` takes ``GROUP19["steps"]`` steps and
    saves the checkpoint after ``save_at``; ``role="resume"`` sets up,
    waits for a line on stdin, restores the checkpoint into its sharded
    net and takes the last step. Prints one ``GROUP`` JSON line (its own
    kernel launches included) and saves its params to ``directory``."""
    import datetime

    import torch.distributed as tdist

    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.parallel import distributed
    from deeplearning4j_torch.parallel import mesh as M
    from deeplearning4j_torch.parallel.model_sharding import shard_network
    from deeplearning4j_torch.utils.convert import params_from_jax
    from deeplearning4j_torch.utils.orbax_checkpoint import (
        load_checkpoint, save_checkpoint)

    leg, rank = json.loads(leg), int(rank)
    torch.set_num_threads(1)
    t_start = time.perf_counter()
    load_s = load_built_kernels()
    t0 = time.perf_counter()
    import torch.distributed.checkpoint as dcp  # noqa: F401 (timed apart)
    dcp_import_s = time.perf_counter() - t0
    devs = leg["devices"][rank]
    timeout = GROUP19["group_timeout_s"]
    store = tdist.PrefixStore(
        f"{leg['name']}/{role}",
        tdist.TCPStore("127.0.0.1", int(port), is_master=False,
                       timeout=datetime.timedelta(seconds=timeout)))
    distributed.initialize(num_processes=2, process_id=rank, device=devs,
                           backend=leg["backend"], store=store,
                           timeout=timeout)
    try:
        net = TransformerLM(**SLICE).init(device=devs[0])
        params_from_jax(numpy_params(net, seed=0), net)
        mesh = (M.data_model_mesh(2, 2) if leg["mesh"] == "data_model"
                else M.data_mesh())
        shard_network(net, mesh)
        sh = M.DataSharding(mesh)
        x, y = train_batch()
        rows = slice(rank * TRAIN_BATCH // 2, (rank + 1) * TRAIN_BATCH // 2)

        def step():
            net.do_step(
                M.make_array_from_process_local_data(sh, x[rows], x.shape),
                M.make_array_from_process_local_data(sh, y[rows], y.shape))

        ckpt = os.path.join(directory, "ckpt")
        report = dict(leg=leg["name"], role=role, rank=rank, load_s=load_s,
                      dcp_import_s=dcp_import_s,
                      backend=distributed.group_backend(),
                      devices=devs,
                      global_devices=distributed.global_device_count(),
                      mesh=repr(mesh))
        step_ms = []
        if role == "train":
            for _ in range(GROUP19["steps"]):
                sync(devs[0])
                t0 = time.perf_counter()
                step()
                sync(devs[0])
                step_ms.append((time.perf_counter() - t0) * 1e3)
                if net.iteration == GROUP19["save_at"]:
                    np.save(os.path.join(directory, f"saved_{rank}.npy"),
                            net.params_flat())
                    t0 = time.perf_counter()
                    save_checkpoint(net, ckpt)
                    report["save_s"] = time.perf_counter() - t0
        else:
            sys.stdin.readline()        # the checkpoint is written
            t0 = time.perf_counter()
            load_checkpoint(ckpt, net=net)
            sync(devs[0])
            report["restore_s"] = time.perf_counter() - t0
            np.save(os.path.join(directory, f"restored_{rank}.npy"),
                    net.params_flat())
            report["restored_iteration"] = net.iteration
            report["sharded_leaf"] = type(
                net.params["ff0a"]["W"]).__name__
            step()
            sync(devs[0])
        np.save(os.path.join(directory, f"{role}_{rank}.npy"),
                net.params_flat())
        report.update(iteration=net.iteration, step_ms=step_ms,
                      launches={k: kernels.LAUNCHES[k] for k in PATH_KERNELS},
                      wall_s=time.perf_counter() - t_start)
        print("GROUP " + json.dumps(report), flush=True)
    finally:
        distributed.shutdown()
    return 0


def start_group_child(leg, role, rank, port, directory):
    """Start one rank as ``python3 -c`` in its own process, its output in
    files under ``directory`` (a rank held at its gate writes on)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root] + sys.path))
    code = (f"import sys, {MODULE19} as c; "
            "sys.exit(c.group_child(*sys.argv[1:]))")
    logs = [open(os.path.join(directory, f"{role}_{rank}.{s}"), "w")
            for s in ("out", "err")]
    proc = subprocess.Popen(
        [sys.executable, "-c", code, json.dumps(leg), role, str(rank),
         str(port), directory], cwd=root, env=env, stdin=subprocess.PIPE,
        stdout=logs[0], stderr=logs[1], text=True)
    for f in logs:
        f.close()
    proc.tag = (role, rank)
    return proc


def group_report(proc, directory, what, deadline):
    """The child's ``GROUP`` report once it exits with 0 before
    ``deadline``; a failed check otherwise (the caller kills it)."""
    role, rank = proc.tag
    try:
        rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        rc = None
    with open(os.path.join(directory, f"{role}_{rank}.out")) as f:
        out = f.read()
    with open(os.path.join(directory, f"{role}_{rank}.err")) as f:
        err = f.read()
    check(rc == 0, f"{what}: exit code {rc} (None: still running after the "
                   f"{GROUP19['timeout_s']} s limit); stderr tail "
                   f"{err[-2000:]}")
    lines = [ln for ln in out.splitlines() if ln.startswith("GROUP ")]
    check(len(lines) == 1, f"{what}: no GROUP line; stdout tail "
                           f"{out[-2000:]} stderr tail {err[-2000:]}")
    return json.loads(lines[0][len("GROUP "):])


def group_reference():
    """One process's ``GROUP19["steps"]`` Adam steps of phase 7's model on
    phase 7's whole batch (the comparison run, on the first card): the
    params after each of the last two steps and the ms a step."""
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.utils.convert import params_from_jax

    net = TransformerLM(**SLICE).init(device=DEVICE19)
    params_from_jax(numpy_params(net, seed=0), net)
    x, y = train_batch(net.device)
    step_ms = []
    for _ in range(GROUP19["steps"]):
        sync(net.device)
        t0 = time.perf_counter()
        net.do_step(x, y)
        sync(net.device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return np.asarray(net.params_flat()), step_ms


def run_group_leg(leg, port, tmp, ref, card):
    """19a and 19b on one leg: the training pair and the resuming pair
    start together (the resuming pair set up and held at its gate until
    the checkpoint is written); every child is joined or killed."""
    from deeplearning4j_torch.utils.orbax_checkpoint import load_checkpoint

    d = os.path.join(tmp, leg["name"])
    os.makedirs(d)
    t0 = time.perf_counter()
    deadline = t0 + GROUP19["timeout_s"]
    procs = [start_group_child(leg, role, r, port, d)
             for role in ("train", "resume") for r in (0, 1)]
    try:
        train = [group_report(p, d, f"19a {leg['name']} training rank "
                              f"{p.tag[1]}", deadline) for p in procs[:2]]
        for p in procs[2:]:
            p.stdin.write("go\n")
            p.stdin.flush()
        resume = [group_report(p, d, f"19b {leg['name']} resuming rank "
                               f"{p.tag[1]}", deadline) for p in procs[2:]]
    finally:
        for p in procs:            # none outlives a failed check
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    final = [np.load(os.path.join(d, f"train_{r}.npy")) for r in (0, 1)]
    saved = [np.load(os.path.join(d, f"saved_{r}.npy")) for r in (0, 1)]
    again = [np.load(os.path.join(d, f"resume_{r}.npy")) for r in (0, 1)]
    restored = [np.load(os.path.join(d, f"restored_{r}.npy"))
                for r in (0, 1)]
    name = leg["name"]
    check(np.array_equal(final[0], final[1])
          and np.array_equal(saved[0], saved[1]),
          f"19a {name}: the ranks' params differ (max |diff| "
          f"{float(np.abs(final[0] - final[1]).max()):.3g})")
    excess = float(np.max(np.abs(final[0] - ref) - (
        GROUP_TOL[1] + GROUP_TOL[0] * np.abs(ref))))
    rel = float(np.abs(final[0] - ref).max() / np.abs(ref).max())
    check(excess <= 0, f"19a {name}: two ranks vs one process after "
                       f"{GROUP19['steps']} Adam steps exceed rtol/atol "
                       f"{GROUP_TOL} by {excess:.3g}")
    for r in train + resume:
        check(all(r["launches"][k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                                 "flash_bwd_dkv")),
              f"19 {name} {r['role']} rank {r['rank']}: K1/K3/K4 did not "
              f"all launch in the child: {r['launches']}")
    check(all(r["restored_iteration"] == GROUP19["save_at"]
              and r["sharded_leaf"] == "SpecTensor" for r in resume)
          and all(np.array_equal(a, saved[0]) for a in restored),
          f"19b {name}: the ranks' sharded restore is not the saved params "
          f"bitwise (max |diff| "
          f"{float(np.abs(restored[0] - saved[0]).max()):.3g}; restored at "
          f"{[r['restored_iteration'] for r in resume]})")
    one_device = all(len(devs) == 1 for devs in leg["devices"])
    resumed_diff = max(float(np.abs(a - final[0]).max()) for a in again)
    resumed_bitwise = all(np.array_equal(a, final[0]) for a in again)
    check(resumed_bitwise if one_device
          else resumed_diff <= GROUP_RESUME_ATOL,
          f"19b {name}: the restored ranks' step {GROUP19['steps']} against "
          f"the uninterrupted ranks': max |diff| {resumed_diff:.3g} "
          f"({'bitwise required: one device a rank' if one_device else f'limit {GROUP_RESUME_ATOL}: two cards a rank'})")
    t = time.perf_counter()
    whole = load_checkpoint(os.path.join(d, "ckpt"), device=DEVICE19)
    sync(DEVICE19)
    parent_restore_s = time.perf_counter() - t
    check(whole.iteration == GROUP19["save_at"]
          and np.array_equal(np.asarray(whole.params_flat()), saved[0]),
          f"19b {name}: the checkpoint restored whole in this process is "
          f"not the ranks' params bitwise")
    del whole
    step_ms = [float(np.median(r["step_ms"][1:])) for r in train]
    out = dict(leg=leg, wall_s=wall, ranks_bitwise=True, worst_excess=excess,
               resumed_bitwise=resumed_bitwise, resumed_max_diff=resumed_diff,
               max_rel_err=rel, step_ms=step_ms,
               first_step_ms=[r["step_ms"][0] for r in train],
               save_s=[r["save_s"] for r in train],
               dcp_import_s=[r["dcp_import_s"] for r in train + resume],
               restore_s=[r["restore_s"] for r in resume],
               parent_restore_s=parent_restore_s,
               kernel_load_s=[r["load_s"] for r in train + resume],
               child_wall_s=[r["wall_s"] for r in train + resume],
               launches={f"19_{name}_{r['role']}{r['rank']}": r["launches"]
                         for r in train + resume},
               backend=train[0]["backend"], devices=[r["devices"]
                                                     for r in train])
    log(f"  19a {name} ({train[0]['backend']}, ranks on "
        f"{[r['devices'] for r in train]}, {train[0]['mesh']}): ranks "
        f"bitwise equal, vs one process max rel {rel:.3g} (worst excess "
        f"over rtol/atol {GROUP_TOL} {excess:.3g}); "
        f"{np.median(step_ms):.1f} ms a step (median of steps 2-"
        f"{GROUP19['steps']}, each rank; first step "
        f"{[round(r['step_ms'][0], 1) for r in train]} ms); K1/K3/K4 "
        f"launches per child "
        f"{[r['launches']['flash_fwd'] for r in train + resume]}/"
        f"{[r['launches']['flash_bwd_dq'] for r in train + resume]}/"
        f"{[r['launches']['flash_bwd_dkv'] for r in train + resume]}; "
        f"[{card}]")
    log(f"  19b {name}: saved after step {GROUP19['save_at']} in "
        f"{[round(s, 3) for s in out['save_s']]} s, restored sharded by a "
        f"fresh pair in {[round(s, 3) for s in out['restore_s']]} s and "
        f"whole in this process in {parent_restore_s:.3f} s (the "
        f"checkpoint module's import apart: "
        f"{[round(s, 2) for s in out['dcp_import_s']]} s), bitwise the "
        f"saved params; step {GROUP19['steps']} against the uninterrupted "
        f"ranks': bitwise {resumed_bitwise} (max |diff| "
        f"{resumed_diff:.3g}); leg {wall:.1f} s; [{card}]")
    return out


def phase_process_groups(card):
    """Phase 19: process groups (19a training, 19b checkpoints) on every
    leg this machine has. Returns (report, launches summed over every
    child process of the phase)."""
    import datetime

    import torch.distributed as tdist

    import torch.distributed.checkpoint as dcp  # noqa: F401 (19b times
    #                                               the calls, not this)

    from deeplearning4j_torch import kernels

    kernels.load()
    t0 = time.perf_counter()
    store = tdist.TCPStore("127.0.0.1", 0, is_master=True,
                           wait_for_workers=False,
                           timeout=datetime.timedelta(
                               seconds=GROUP19["group_timeout_s"]))
    ref, ref_ms = uncounted(group_reference)
    tmp = tempfile.mkdtemp(prefix="chip19_")
    out = dict(one_process_step_ms=float(np.median(ref_ms[1:])), legs={})
    try:
        for leg in group_legs():
            log(f"phase 19 leg {leg['name']}: two ranks over "
                f"{leg['backend']} on {leg['devices']}")
            out["legs"][leg["name"]] = run_group_leg(leg, store.port, tmp,
                                                     ref, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    children = {k: v for leg in out["legs"].values()
                for k, v in leg["launches"].items()}
    out["children_launches"] = children
    total = {k: sum(v[k] for v in children.values()) for k in PATH_KERNELS}
    sharded = REPORT.get("model_parallel", {}).get("sharded_trainer", {})
    out["dp2_tp2_one_process_step_wall_ms"] = sharded.get("step_wall_ms")
    out["dp2_tp2_one_process_step_device_ms"] = sharded.get(
        "step_device_ms")
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 19: {out['wall_s']:.1f} s; ms a step: one process on the "
        f"whole batch {out['one_process_step_ms']:.1f}, "
        f"{ {k: round(float(np.median(v['step_ms'])), 1) for k, v in out['legs'].items()} } "
        f"by leg, phase 17b's one-process dp 2 x tp 2 "
        f"{sharded.get('step_wall_ms')} wall / "
        f"{sharded.get('step_device_ms')} device; child launches {total}; "
        f"[{card}]")
    return out, total


# --------------------------------------------------------------------------
# phase 20: graftcheck (the static gate, a lock-checked serve, the bite)
# --------------------------------------------------------------------------
#: 20b's traffic beside phase 9's 24 fleet requests, spread round-robin
#: over eight client threads: RAG turns on phase 10's /rag query, one-row
#: k-NN queries, one-row ParallelInference submits and one broker consumer
#: of the 15b producer's 400 spiral batches
ANALYSIS = dict(clients=8, rag=8, knn=32, pi_rows=16, knn_k=10)

#: 20a's child: ``python3 -m deeplearning4j_torch.analysis --check`` (run as
#: ``-m`` runs it), then one line saying what it imported
_STATIC_GATE = r"""
import json, runpy, sys, time
t0 = time.perf_counter()
sys.argv = ["deeplearning4j_torch.analysis", "--check"]
try:
    runpy.run_module("deeplearning4j_torch.analysis", run_name="__main__",
                     alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code if isinstance(e.code, int) else 1
mods = list(sys.modules)
print("static-gate:", json.dumps({
    "rc": rc, "seconds": time.perf_counter() - t0,
    "jax": sorted(m for m in mods if m == "jax" or m.startswith("jax.")),
    "tpu": sorted(m for m in mods if m.startswith("deeplearning4j_tpu"))}),
    flush=True)
sys.exit(rc)
"""


def start_static_gate():
    """20a's child process, started at the phase's start (torch's import
    and the scan take seconds) and read at its end."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root] + sys.path))
    return subprocess.Popen([sys.executable, "-c", _STATIC_GATE], cwd=root,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_static_gate(child, card):
    """20a: rc 0, no JAX in the child; files scanned, findings, baselined
    entries and seconds from its summary line."""
    import re

    out, err = child.communicate(timeout=300)
    status = [ln for ln in out.splitlines() if ln.startswith("static-gate:")]
    check(status, f"20a: the static gate's child printed no status (rc "
                  f"{child.returncode}): {out[-2000:]} {err[-2000:]}")
    st = json.loads(status[-1].split(":", 1)[1])
    check(child.returncode == 0 and st["rc"] == 0,
          f"20a: graftcheck --check exited {st['rc']}: {out[-3000:]}")
    check(not st["jax"] and not st["tpu"],
          f"20a: the static gate imported {st['jax'] + st['tpu']}")
    m = re.search(r"graftcheck: (\d+) files, (\d+) findings \((\d+) "
                  r"unbaselined, (\d+) baselined, (\d+) stale", out)
    check(m is not None, f"20a: no graftcheck summary line: {out[-2000:]}")
    files, found, unbased, based, stale = (int(g) for g in m.groups())
    check(unbased == 0 and stale == 0,
          f"20a: {unbased} unbaselined findings, {stale} stale entries")
    log(f"  20a graftcheck --check: {files} files, {found} findings "
        f"({based} baselined, {unbased} unbaselined), {st['seconds']:.2f} s "
        f"in the child (its torch import included), no JAX imported; "
        f"[{card}]")
    return dict(files=files, findings=found, baselined=based,
                unbaselined=unbased, stale=stale, seconds=st["seconds"])


def rag_docs():
    """The first ``COS_ROWS`` documents of ``rag_store()`` (phase 10's
    /rag corpus), bitwise: only its first draw chunk is drawn."""
    d, c = RAG["d"], RAG["partitions"]
    rs = np.random.RandomState(0)
    centers = rs.randn(c, d).astype(np.float32) * 2.0
    m = min(1 << 20, RAG["n"])
    pts = (centers[rs.randint(0, c, m)]
           + rs.randn(m, d).astype(np.float32) * 0.6)
    return np.ascontiguousarray(pts[:COS_ROWS])


def post_json(url, body):
    import urllib.request

    req = urllib.request.Request(url, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def run_clients(items, work, clients):
    """``work(item)`` for every item, the items dealt round-robin over
    ``clients`` threads that start together; a client resolves the futures
    its work returned (fleet submits) after its last item: (results in
    item order, wall seconds). The first failure is raised."""
    from concurrent.futures import Future

    results, errors = [None] * len(items), []
    start = threading.Barrier(clients + 1)

    def client(c):
        start.wait()
        mine = range(c, len(items), clients)
        try:
            for i in mine:
                results[i] = work(items[i])
            for i in mine:
                if isinstance(results[i], Future):
                    results[i] = results[i].result(timeout=300).tolist()
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads),
          "20b: a client thread did not finish")
    if errors:
        raise errors[0]
    return results, wall


def fleet_clients(fleet, reqs, clients):
    """Phase 9's fleet requests from ``clients`` threads, each submitting
    its share at once and then waiting: (streams, wall seconds)."""
    def submit(j):
        p, n, o = reqs[j]
        return fleet.submit(p, n, **o)
    return run_clients(list(range(len(reqs))), submit, clients)


def plain_fleet_tps(net, reqs, want):
    """20b's control, after ``uninstall()``: the same fleet and the same
    eight-client serve with plain locks (tokens/s)."""
    fleet = fleet_of(net, restart_backoff_s=0.05)
    try:
        outs, wall = fleet_clients(fleet, reqs, ANALYSIS["clients"])
    finally:
        fleet.close()
    check(outs == want, "20b: a stream of the plain control differs from "
                        "phase 9's")
    return sum(len(w) for w in want) / wall


def lock_checked_serve(card, greedy, sampled, fleet_tps, rag_want, child):
    """20b, with the instrument installed: phase 9's fleet, phase 10's /rag
    route, a ``NearestNeighborsServer`` over the same documents, a
    ``ParallelInference`` coalescer over the slice model and a broker fed
    by the 15b producer, all built after ``install()``; eight clients.
    20a's ``child`` is read before the timed serve, so its scan does not
    share the host with it. Returns (measurements, 20a's, the net, the
    fleet requests and their streams)."""
    from deeplearning4j_torch.analysis import instrument
    from deeplearning4j_torch.modelimport.server import KerasBackendServer
    from deeplearning4j_torch.nearestneighbors.server import (
        NearestNeighborsServer)
    from deeplearning4j_torch.parallel.fleet import ReplicaFleet
    from deeplearning4j_torch.parallel.generation import GenerationServer
    from deeplearning4j_torch.parallel.inference import ParallelInference
    from deeplearning4j_torch.parallel.resilience import (CircuitBreaker,
                                                          RetryPolicy)
    from deeplearning4j_torch.parallel.runtime import supervisor
    from deeplearning4j_torch.streaming import (NDArrayConsumer,
                                                StreamingBroker)

    V, C = SLICE["num_labels"], ANALYSIS["clients"]
    recoveries0 = supervisor().recoveries
    # block-forever backpressure: the consumer shares a busy process, so
    # every frame must arrive rather than be dropped after 0.5 s
    broker = StreamingBroker(port=0, publish_patience_s=None).start()
    producer = start_producer(broker)
    closers = [broker.close]
    try:
        net = fabric_net()
        reqs, want = fabric_requests(net, greedy, sampled)
        ntok = sum(len(w) for w in want)

        def factory(rid):
            return GenerationServer(net, V, device="cuda",
                                    retry=RetryPolicy(),
                                    breaker=CircuitBreaker(), **SERVER)
        fleet = ReplicaFleet(factory, replicas=FLEET_REPLICAS,
                             restart_backoff_s=0.05)
        closers.append(fleet.close)
        docs = rag_docs()
        knn = NearestNeighborsServer(docs, backend="index", device="cuda")
        closers.append(knn.stop)
        knn_url = f"http://127.0.0.1:{knn.start()}/knnVector"
        keras = KerasBackendServer()
        closers.append(keras.stop)
        passages = VirtualPassages(V, RAG["passage_len"])
        mid = keras.attach_rag(net, vocab=V, passages=passages,
                               doc_vectors=docs, k=RAG["k"],
                               slots=RAG["slots"], page_size=RAG["page_size"],
                               mid="rag", index_kw={"store": "int8"},
                               device="cuda")
        rag = keras._rags[mid]
        rag_url = f"http://127.0.0.1:{keras.start()}/rag"
        inf = ParallelInference(net, max_batch=PI_BATCH, max_wait_ms=5.0,
                                device="cuda")
        closers.append(inf.close)
        prompt = np.arange(1, 9, dtype=np.int64)
        q_rag = docs[123] + 0.01
        rs = np.random.RandomState(20)
        knn_ids = rs.choice(COS_ROWS, ANALYSIS["knn"], replace=False)
        qs = docs[knn_ids] + 0.01
        x_lm = np.eye(V, dtype=np.float32)[
            rs.randint(0, V, (ANALYSIS["pi_rows"], SLICE["max_length"]))]
        # references (off the counters): each PI row's unpadded forward,
        # and, where phase 10 did not run, one serial /rag answer
        alone = uncounted(lambda: np.concatenate(
            [host_rows(net.output(x_lm[i:i + 1]))
             for i in range(len(x_lm))]))
        scale = float(np.abs(alone).max())

        def rag_answer(http=False):
            if http:
                return post_json(rag_url, {
                    "model": mid, "prompt_ids": prompt.tolist(),
                    "max_tokens": RAG["tokens"],
                    "query_vec": q_rag.tolist()})
            f = rag.submit(prompt, RAG["tokens"], query_vec=q_rag)
            return dict(tokens=f.result(timeout=300).tolist(),
                        docs=list(f._rag_docs), prefix_len=f._rag_prefix_len)

        def knn_answer(j, http=False):
            if not http:
                return knn.knn(qs[j][None], ANALYSIS["knn_k"])
            got = post_json(knn_url, {"points": qs[j][None].tolist(),
                                      "k": ANALYSIS["knn_k"]})["results"]
            return (np.asarray([[r["distance"] for r in got[0]]], np.float32),
                    np.asarray([[r["index"] for r in got[0]]]))
        if rag_want is None:
            rag_want = uncounted(rag_answer)
        knn_want = [knn_answer(j) for j in range(len(qs))]

        static = finish_static_gate(child, card)
        ready = producer.stdout.readline()
        check(ready.startswith("producer: ready"),
              f"20b: the producer did not start: {ready!r}")

        # (i) the fleet alone: phase 9a's clean serve from eight clients
        outs, wall = fleet_clients(fleet, reqs, C)
        check(outs == want, f"20b: {sum(a != b for a, b in zip(outs, want))}"
                            f" fleet streams differ from phase 9's")
        tps = ntok / wall

        # (ii) everything at once

        def consume():
            got = 0
            with NDArrayConsumer("127.0.0.1", broker.port, "spiral",
                                 idle_timeout_s=120.0) as cons:
                producer.stdin.write("go\n")
                producer.stdin.flush()
                for ds, (x, y) in zip(cons, spiral_batches(
                        STREAM["batches"], STREAM["batch"])):
                    check(np.array_equal(ds.features, x)
                          and np.array_equal(ds.labels, y),
                          f"20b: broker frame {got} differs from the "
                          f"producer's")
                    got += 1
            return got

        def work(item):
            kind, j = item
            if kind == "stream":
                return consume()
            if kind == "gen":
                p, n, o = reqs[j]
                return fleet.submit(p, n, **o)
            # odd rag and knn items go over HTTP (/rag, /knnVector)
            if kind == "rag":
                return rag_answer(http=j % 2 == 1)
            if kind == "knn":
                return knn_answer(j, http=j % 2 == 1)
            return inf.submit(x_lm[j:j + 1]).result(timeout=300)

        items = ([("stream", 0)] + [("gen", j) for j in range(len(reqs))]
                 + [("rag", j) for j in range(ANALYSIS["rag"])]
                 + [("knn", j) for j in range(ANALYSIS["knn"])]
                 + [("pi", j) for j in range(ANALYSIS["pi_rows"])])
        res, mixed_wall = run_clients(items, work, C)
        by = {}
        for (kind, j), r in zip(items, res):
            by.setdefault(kind, []).append((j, r))
        out, _err = producer.communicate(timeout=120)
        check(producer.returncode == 0
              and f"published {STREAM['batches']}" in out,
              f"20b: the producer failed: {_err[-2000:]}")
        check(by["stream"][0][1] == STREAM["batches"],
              f"20b: {by['stream'][0][1]} of {STREAM['batches']} broker "
              f"frames arrived")
        check([r for _j, r in by["gen"]] == want,
              "20b: a fleet stream of the mixed serve differs from phase 9's")
        check(all(r == rag_want for _j, r in by["rag"])
              and 123 in rag_want["docs"],
              f"20b: a /rag answer differs from phase 10's route "
              f"{rag_want}: {[r for _j, r in by['rag']][:2]}")
        # coalesced batches round differently from one-row searches:
        # held to the serial answers by phase 10a's tie rule
        knn_got = sorted(by["knn"], key=lambda t: t[0])
        knn_rule = tie_rule(
            "20b concurrent k-NN vs serial",
            tuple(np.concatenate([r[n] for _j, r in knn_got])
                  for n in (0, 1)),
            tuple(np.concatenate([w[n] for w in knn_want]) for n in (0, 1)),
            docs, qs)
        top1 = float(np.mean([knn_want[j][1][0, 0] == knn_ids[j]
                              for j in range(len(qs))]))
        rows = np.concatenate([r for _j, r in by["pi"]])
        pi_err = float(np.abs(rows - alone).max())
        check(pi_err <= 1e-5 * scale,
              f"20b: coalesced rows vs unpadded output() {pi_err:.3g} > "
              f"1e-5 x {scale:.3g}")

        built = instrument.built()
        loops = [o for o in built if type(o).__name__ == "ServingLoop"]
        kinds = sorted({type(o).__name__ for o in built})
        unwrapped = instrument.unwrapped()
        check(not unwrapped, f"20b: ranked locks not rank-checked: "
                             f"{unwrapped}")
        check(not instrument.violations,
              f"20b: lock-order violations: {instrument.violations}")
        crashed = [lp.name for lp in loops
                   if lp.crashed is not None or lp.restarts]
        check(not crashed and supervisor().recoveries == recoveries0,
              f"20b: serving loops crashed or restarted: {crashed} "
              f"(supervisor recoveries {recoveries0} -> "
              f"{supervisor().recoveries})")
        fst = fleet.stats()
        check(fst["deaths"] == 0 and fst["failed"] == 0,
              f"20b: fleet deaths {fst['deaths']}, failed {fst['failed']}")
    finally:
        for close in reversed(closers):
            close()
        if producer.poll() is None:
            producer.kill()
            producer.wait()
    log(f"  20b lock-checked serve: {len(built)} instances of "
        f"{len(kinds)} ranked classes (every ranked lock rank-checked, "
        f"{len(loops)} serving loops, none crashed or restarted), no "
        f"violation; the fleet alone {ntok} tokens from {C} "
        f"clients {tps:.1f} tok/s instrumented (phase 9a's, one thread, "
        f"{fleet_tps if fleet_tps is None else round(fleet_tps, 1)}), "
        f"streams bitwise phase 9's; then {len(items)} "
        f"mixed requests in {mixed_wall:.2f} s: {len(reqs)} fleet streams "
        f"bitwise, {ANALYSIS['rag']} RAG turns (half over /rag) equal "
        f"phase 10's route, {ANALYSIS['knn']} k-NN answers (half over "
        f"/knnVector) the serial ones by the tie rule (bitwise "
        f"{knn_rule['bitwise']}, top-1 "
        f"{top1:.3f}), {ANALYSIS['pi_rows']} coalesced rows within "
        f"{pi_err:.2e} (max|y| {scale:.3g}), {STREAM['batches']} broker "
        f"frames bitwise; [{card}]")
    return dict(instances=len(built), classes=kinds,
                serving_loops=len(loops), fleet_tokens=ntok,
                fleet_wall_s=wall, tokens_per_s=tps,
                phase9_tokens_per_s=fleet_tps, mixed_items=len(items),
                mixed_wall_s=mixed_wall, knn_top1=top1, knn=knn_rule,
                pi_max_abs_err=pi_err,
                broker_frames=STREAM["batches"]), static, (net, reqs, want)


def bite(card):
    """20c, still installed: a serving loop's tick holds a rank-70
    ``CircuitBreaker._lock`` and takes its own rank-25 ``_cond``; the
    violation must surface on the loop's ``crashed``, naming both."""
    from deeplearning4j_torch.analysis import instrument
    from deeplearning4j_torch.analysis.instrument import LockOrderViolation
    from deeplearning4j_torch.parallel.resilience import CircuitBreaker
    from deeplearning4j_torch.parallel.runtime import ServingLoop

    del instrument.violations[:]
    cb = CircuitBreaker()
    box = []

    def tick():
        with cb._lock:
            with box[0]._cond:
                pass
        return False

    box.append(ServingLoop("graftcheck-bite", tick=tick))
    box[0].start()
    box[0].close(timeout=10.0)
    crash = box[0].crashed
    check(isinstance(crash, LockOrderViolation)
          and "CircuitBreaker._lock" in str(crash)
          and "ServingLoop._cond" in str(crash),
          f"20c: the seeded inversion was not caught: {crash!r}")
    check(len(instrument.violations) == 1,
          f"20c: {len(instrument.violations)} violations recorded")
    del instrument.violations[:]
    log(f"  20c the seeded inversion (rank 70 held, rank 25 taken on a "
        f"loop thread) crashed the loop with: {crash}; [{card}]")
    return str(crash)


def phase_analysis(card, greedy=None, sampled=None, fleet_tps=None,
                   rag_want=None):
    """Phase 20: graftcheck on the card machine (20a-20c). ``greedy``/
    ``sampled`` are phase 5's and 5b's streams (phase 9's fleet
    references), ``fleet_tps`` phase 9a's clean tokens/s, ``rag_want``
    phase 10's /rag answer."""
    from deeplearning4j_torch.analysis import instrument

    t0 = time.perf_counter()
    child = start_static_gate()
    try:
        instrument.install()
        try:
            serve_r, static, (net, reqs, want) = lock_checked_serve(
                card, greedy, sampled, fleet_tps, rag_want, child)
            bite_r = bite(card)
        finally:
            instrument.uninstall()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    plain = plain_fleet_tps(net, reqs, want)
    serve_r["plain_tokens_per_s"] = plain
    wall = time.perf_counter() - t0
    log(f"  20b control: the same eight-client fleet serve uninstrumented "
        f"{plain:.1f} tok/s, instrumented {serve_r['tokens_per_s']:.1f} "
        f"({serve_r['tokens_per_s'] / plain:.3f}x); [{card}]")
    log(f"  phase 20: {wall:.1f} s; [{card}]")
    return dict(static=static, serve=serve_r, bite=bite_r, wall_s=wall)


# ---------------------------------------------------------------- phase 21
#: phase 21: the zoo TransformerLM at GPT-J-6B's attention and FFN widths,
#: from EleutherAI's published config.json for GPT-J-6B (n_embd 4096,
#: n_head 16, n_inner null, so 4·n_embd): d_model 4,096 in 16 heads of
#: d = 256, FFN 16,384; numpy-seeded weights, nothing downloaded
GPTJ = dict(num_labels=256, max_length=512, d_model=4096, n_heads=16,
            n_blocks=2, max_cache=512)
GPTJ_D = GPTJ["d_model"] // GPTJ["n_heads"]
#: what phase 21 cuts from GPT-J-6B (its report lists them)
GPTJ_REDUCED = ["depth 28 -> 2 blocks", "vocab 50,400 -> the zoo's 256",
                "rotary positions -> the zoo's sinusoidal positions",
                "parallel attention/FFN block -> the zoo's sequential block",
                "weights numpy-seeded (gain 2, as numpy_params)"]
#: 21c: fit's batch (rows, tokens) and steps, and the cut batch of the
#: first step's comparison with the CPU in f64
GPTJ_TRAIN = dict(batch=4, T=512, steps=3, cut_batch=1, cut_T=128)


def gptj_params(seed, gain=2.0):
    """``GPTJ``'s parameters drawn as numpy_params draws them (W ~
    N(0, 1)·gain/√fan_in, gamma 1 + 0.1·N, the rest 0.1·N) from a numpy
    Generator in f32 (the legacy RandomState draws f64 at a third of the
    rate: 400M values at this width), their shapes from each owner's draw
    on the meta device (a net's own draw of 400M values on the host would
    be thrown away)."""
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.nn.graph import ComputationGraph

    owners = ComputationGraph(TransformerLM(**GPTJ).conf())._param_owners()
    gen = torch.Generator(device="cpu")
    rng = np.random.default_rng(seed)
    out = {}
    for v, o in owners.items():
        out[v] = {}
        for k, t in o.init_params(gen, torch.float32, "meta").items():
            shp = tuple(t.shape)
            a = rng.standard_normal(shp, dtype=np.float32)
            if k.startswith("W"):
                a *= np.float32(gain / np.sqrt(shp[0]))
            elif k == "gamma":
                a = np.float32(1.0) + np.float32(0.1) * a
            else:
                a *= np.float32(0.1)
            out[v][k] = a
    return out


def tensors_of(params, dtype):
    return {v: {k: torch.from_numpy(a).to(dtype) for k, a in p.items()}
            for v, p in params.items()}


@contextlib.contextmanager
def plain_guard():
    """Counts, in ``PLAIN_ON_CARD``, the calls of the plain attention
    functions (K1's, K3/K4's and K2's plain versions, the stock dense
    attention) on CUDA tensors outside a comparison run (``uncounted``):
    the main path must make none."""
    from deeplearning4j_torch.nn.conf.layers import attention as patt
    from deeplearning4j_torch.nn.conf.layers import paged_attention as ppa
    from deeplearning4j_torch.ops import flash_attention as fa

    targets = [(fa, "flash_attention_plain"),
               (fa, "flash_attention_backward_plain"),
               (ppa, "paged_attention_plain"),
               (patt, "scaled_dot_attention")]
    saved = [(m, n, getattr(m, n)) for m, n in targets]
    PLAIN_ON_CARD.clear()

    def counted(name, fn):
        def run(*a, **k):
            if not COMPARING[0] and a and torch.is_tensor(a[0]) \
                    and a[0].is_cuda:
                PLAIN_ON_CARD[name] = PLAIN_ON_CARD.get(name, 0) + 1
            return fn(*a, **k)
        return run

    for m, n, fn in saved:
        setattr(m, n, counted(n, fn))
    try:
        yield PLAIN_ON_CARD
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


#: plain attention calls on the card outside comparisons (``plain_guard``)
PLAIN_ON_CARD: dict = {}


def near_tie_rule(tag, model, reqs, outs, ref, spread=None):
    """Phase 5c's rule: each stream equals the reference's or leaves it at
    a position whose top-2 logit gap is within ``spread`` (default: the gap
    spread of two right reads of the model, ``gap_spread``, at most
    ``NEAR_TIE_CAP``). Returns (divergences, spread)."""
    near = []
    for i, (got, want) in enumerate(zip(outs, ref)):
        k = first_divergence(got, want)
        if k is None:
            continue
        gap = uncounted(top2_gap, model, reqs[i][0], want[:k])
        near.append(dict(request=i, position=k, gap=gap,
                         tokens=[got[k], want[k]]))
    if near and spread is None:
        spread = uncounted(gap_spread, model, [
            np.concatenate([p, w]) for (p, _), w in zip(reqs, ref)])
        check(spread <= NEAR_TIE_CAP, f"{tag}: two reads of the model move "
                                      f"the top-2 gap by {spread:.4f} > "
                                      f"{NEAR_TIE_CAP}")
    for d in near:
        check(d["gap"] <= spread,
              f"{tag}: request {d['request']} leaves the plain-read stream "
              f"at token {d['position']} at a top-2 logit gap of "
              f"{d['gap']:.6f}, over the spread {spread:.6f}")
    return near, spread


def gptj_serve(tag, model, reqs, kv, ref_backend, exact, card):
    """21b: ``reqs`` served greedy by ``model`` through K2 (``kv`` KV),
    against the plain-read server (``paged_attention=ref_backend``) on the
    same weights: token for token (``exact``) or within the near-tie rule.
    Returns measurements."""
    from deeplearning4j_torch import kernels

    nb = GPTJ["n_blocks"]
    before = dict(kernels.LAUNCHES)
    outs, wall, st = serve(model, reqs, kv_dtype=kv)
    k2 = kernels.LAUNCHES["paged_attn"] - before["paged_attn"]
    chunk = kernels.LAUNCHES["paged_attn_chunk"] - before["paged_attn_chunk"]
    check(k2 == nb * (st["prefill_rounds"] + SERVER["steps_per_dispatch"]
                      * st["decode_steps"])
          and chunk == nb * st["prefill_rounds"] and chunk > 0,
          f"21b {tag}: K2 launched {k2} times ({chunk} chunk route) for "
          f"{st['prefill_rounds']} prefill rounds and {st['decode_steps']} "
          f"decode dispatches")
    ref, ref_wall, _ = uncounted(serve, model, reqs, kv_dtype=kv,
                                 paged_attention=ref_backend)
    check(all(len(o) == 32 for o in outs), f"21b {tag}: short output")
    check(len({t for o in outs for t in o}) > 4,
          f"21b {tag}: degenerate greedy streams")
    if exact:
        check(outs == ref, f"21b {tag}: streams leave the plain-read "
                           f"server's: {[first_divergence(a, b) for a, b in zip(outs, ref)]}")
        near, spread = [], None
    else:
        near, spread = near_tie_rule(f"21b {tag}", model, reqs, outs, ref)
    ntok = sum(len(o) for o in outs)
    log(f"  21b {tag}: {len(reqs)} greedy requests, {ntok / wall:.1f} tok/s "
        f"(plain read {ntok / ref_wall:.1f}); K2 {k2} launches ({chunk} "
        f"chunk route); {len(reqs) - len(near)}/{len(reqs)} identical to the "
        f"plain-read server; divergences (request, token, top-2 gap): "
        f"{[(d['request'], d['position'], round(d['gap'], 6)) for d in near]}"
        f"; [{card}]")
    return dict(tokens=ntok, wall_s=wall, tokens_per_s=ntok / wall,
                plain_tokens_per_s=ntok / ref_wall, k2_launches=k2,
                k2_chunk_launches=chunk, prefill_rounds=st["prefill_rounds"],
                decode_steps=st["decode_steps"],
                identical_requests=len(reqs) - len(near), divergences=near,
                gap_spread=spread, streams=outs)


def gptj_batch(rows, T, seed=8):
    """One-hot tokens and next-token labels [rows, T, V] (numpy)."""
    rs = np.random.RandomState(seed)
    V = GPTJ["num_labels"]
    tok = rs.randint(0, V, (rows, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[tok[:, :-1]], eye[tok[:, 1:]]


def phase_wide_heads(card):
    """Phase 21: the zoo ``TransformerLM`` at GPT-J-6B's attention and FFN
    widths (``GPTJ``; cuts in ``GPTJ_REDUCED``), every attention on the
    card through the kernels at d = 256, no plain attention function on
    the card outside the comparisons (``plain_guard``).

    21a: ``output()`` of 2 rows x 128 tokens against a CPU run of the
    port's plain path (phase 5f's 1e-4), and the model through a zip,
    reloaded bitwise. 21b: phase 5's 16 requests served greedy with f32 KV
    (token for token the plain-read server's), int8 KV and a bf16 model
    (near-tie rule), tokens/s. 21c: ``GPTJ_TRAIN["steps"]`` Adam steps of
    ``fit`` at 4 x 512, the first step's loss and gradients at a cut batch
    against the CPU in f64 (phase 7's 1e-4 of each leaf's max|g|), ms a
    step."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.datasets.dataset import DataSet
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.utils.model_serializer import (load_model,
                                                             save_model)

    t_phase = time.perf_counter()
    parts = {}
    t0 = time.perf_counter()
    params = gptj_params(seed=25)
    net = TransformerLM(**GPTJ).init(tensors_of(params, torch.float32),
                                     device="cuda")
    cpu = TransformerLM(**GPTJ).init(tensors_of(params, torch.float32),
                                     device="cpu")
    nb, V = GPTJ["n_blocks"], GPTJ["num_labels"]
    results = dict(config=dict(GPTJ, head_dim=GPTJ_D, ffn=4 * GPTJ["d_model"],
                               source="EleutherAI GPT-J-6B config.json: "
                                      "n_embd 4096, n_head 16, n_inner "
                                      "null (4 x n_embd)"),
                   reduced=GPTJ_REDUCED, param_bytes=param_bytes(net))
    parts["build"] = time.perf_counter() - t0
    with plain_guard() as plain_on_card:
        # 21a: output() and the zip
        t0 = time.perf_counter()
        rs = np.random.RandomState(3)
        x = np.eye(V, dtype=np.float32)[rs.randint(0, V, (2, 128))]
        before = kernels.LAUNCHES_BY_D.get(("flash_fwd", GPTJ_D), 0)
        out = net.output(x)
        torch.cuda.synchronize()
        k1 = kernels.LAUNCHES_BY_D.get(("flash_fwd", GPTJ_D), 0) - before
        err = (out.cpu() - cpu.output(x)).abs().max().item()
        check(out.shape == (2, 128, V) and torch.isfinite(out).all().item(),
              "21a: output shape or non-finite values")
        check(err <= 1e-4, f"21a: output() vs CPU plain path max |err| "
                           f"{err:.3g} > 1e-4")
        check(k1 == nb, f"21a: K1 launched {k1} times at d={GPTJ_D} in one "
                        f"output(), expected {nb}")
        del cpu
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "gptj_width.zip")
            ts = time.perf_counter()
            save_model(net, path, save_updater=False)
            save_s = time.perf_counter() - ts
            zip_bytes = os.path.getsize(path)
            ts = time.perf_counter()
            loaded = load_model(path, device="cuda")
            load_s = time.perf_counter() - ts
        again = loaded.output(x)
        same = torch.equal(again, out)
        flat_same = np.array_equal(loaded.params_flat(), net.params_flat())
        del loaded, again
        torch.cuda.empty_cache()
        check(same and flat_same, "21a: the reloaded zip's output() or "
                                  "parameters differ from the net's")
        results["21a"] = dict(output_max_abs_err=err, k1_launches=k1,
                              zip_bytes=zip_bytes, save_s=save_s,
                              load_s=load_s, reload_bitwise=True)
        log(f"  21a output() [2, 128, {V}] at d_model {GPTJ['d_model']}, "
            f"{GPTJ['n_heads']} heads of d={GPTJ_D}: max |err| vs CPU "
            f"{err:.2e} (atol 1e-4), K1 launches {k1}; zip {zip_bytes} "
            f"bytes saved in {save_s:.1f} s, loaded on the card in "
            f"{load_s:.1f} s, output() and parameters bitwise; "
            f"{param_bytes(net)} parameter bytes; [{card}]")
        parts["21a"] = time.perf_counter() - t0

        # 21b: the phase-5 requests served greedy
        t0 = time.perf_counter()
        reqs = serve_requests()
        uncounted(serve, net, reqs[:2])                   # warm-up
        results["21b"] = {
            "f32kv": gptj_serve("f32 KV", net, reqs, None, "stock", True,
                                card),
            "int8kv": gptj_serve("int8 KV", net, reqs, "int8", "stock",
                                 False, card)}
        bf = TransformerLM(dtype="bfloat16", **GPTJ).init(
            tensors_of(params, torch.bfloat16), device="cuda")
        uncounted(serve, bf, reqs[:2])                    # warm-up
        results["21b"]["bf16"] = gptj_serve("bf16 model, bf16 KV", bf, reqs,
                                            None, "xla", False, card)
        del bf
        torch.cuda.empty_cache()
        parts["21b"] = time.perf_counter() - t0

        # 21c: fit, and its first step against the CPU in f64
        t0 = time.perf_counter()
        tr = GPTJ_TRAIN
        xb, yb = gptj_batch(tr["batch"], tr["T"])
        xc, yc = xb[:tr["cut_batch"], :tr["cut_T"]], \
            yb[:tr["cut_batch"], :tr["cut_T"]]
        ld, gd = step_grads(net, xc, yc)
        ref = TransformerLM(dtype="float64", **GPTJ).init(
            tensors_of(params, torch.float64), device="cpu")
        for v in ref.conf.vertices.values():      # f64 attention throughout
            if getattr(getattr(v, "layer", None), "helper", None):
                v.layer.helper = "stock"
        lc, gc = step_grads(ref, xc, yc)
        rule, leaf = worst_leaf(gd, gc, rule_1e4(ref, gc))
        loss_rel = abs(ld - lc) / abs(lc)
        del ref, gc
        check(rule <= 1.0 and loss_rel <= 1e-4,
              f"21c: first-step gradients vs the CPU in f64, worst leaf "
              f"{leaf} at {rule:.3g} of phase 7's 1e-4 of its max|g|; loss "
              f"rel {loss_rel:.3g}")
        names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        before = {k: kernels.LAUNCHES_BY_D.get((k, GPTJ_D), 0) for k in names}
        batches = [DataSet(xb, yb) for _ in range(tr["steps"])]
        torch.cuda.synchronize()
        ts = time.perf_counter()
        net.fit(batches)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - ts) / tr["steps"] * 1e3
        per_step = {k: (kernels.LAUNCHES_BY_D.get((k, GPTJ_D), 0)
                        - before[k]) / tr["steps"] for k in names}
        loss = net.score()
        check(np.isfinite(loss), f"21c: non-finite loss after fit: {loss}")
        check(all(n == nb for n in per_step.values()),
              f"21c: launches per step at d={GPTJ_D} {per_step}, expected "
              f"{nb} each")
        tokens = tr["batch"] * tr["T"]
        results["21c"] = dict(grad_rule=rule, worst_leaf=leaf,
                              loss_rel_err=loss_rel, first_loss=ld,
                              cpu_f64_loss=lc, last_loss=loss,
                              launches_per_step=per_step, step_ms=step_ms,
                              tokens_per_s=tokens / step_ms * 1e3,
                              peak_bytes=torch.cuda.max_memory_allocated())
        log(f"  21c fit [{tr['batch']}, {tr['T']}] Adam, {tr['steps']} "
            f"steps: first step at [{tr['cut_batch']}, {tr['cut_T']}] vs the "
            f"CPU in f64: worst leaf {leaf} at {rule:.3g} of 1e-4·max|g|, "
            f"loss rel {loss_rel:.2e} ({ld:.4f}); launches per step at "
            f"d={GPTJ_D} {per_step}; {step_ms:.1f} ms a step (first "
            f"included) = {tokens / step_ms * 1e3:.0f} tokens/s; loss after "
            f"{loss:.4f}; [{card}]")
        parts["21c"] = time.perf_counter() - t0
    check(not plain_on_card, f"phase 21: plain attention ran on the card "
                             f"outside the comparisons: {plain_on_card}")
    del net
    torch.cuda.empty_cache()
    results["plain_on_card"] = dict(plain_on_card)
    results["seconds"] = dict(parts, total=time.perf_counter() - t_phase)
    log(f"  phase 21: {results['seconds']['total']:.1f} s "
        f"{json.dumps({k: round(v, 1) for k, v in parts.items()})}; cuts "
        f"{GPTJ_REDUCED}; [{card}]")
    return results


def wide_fields(cases, d256, part=None, grads=None, at256=0,
                launches_wide=0, pattern="d{}_f32_causal_mask",
                prefix=""):
    """Kernels-line fields of the head dims of ``WIDE_DIMS`` (the timed f32
    case ``pattern.format(d)`` of each of ``WIDE_TIMED_DIMS``, as
    ``pad_fields``, and the worst error over every case at each head dim)
    and of phase 21's d = 256 shape (case ``d256``: times beside the bound, the plain
    version's and the library's; ``part``: the backward's dq or dkv), with
    the phase-21 window's launches (``launches_wide``; ``at256``: those at
    d = 256)."""
    r = cases[d256]
    t = r[part] if part else r
    err = r["max_abs_err"]
    def worst(c):
        e = c["max_abs_err"]
        return max(e.values()) if isinstance(e, dict) else e

    def d_of(c):
        return c.get("d", (c.get("shape") or [0] * 4)[3])

    return {f"{prefix}wide_dims": pad_fields(cases, WIDE_TIMED_DIMS,
                                             pattern, part),
            f"{prefix}wide_dims_max_abs_err": {
                str(d): max(worst(c) for c in cases.values() if d_of(c) == d)
                for d in WIDE_DIMS},
            f"{prefix}d256_shape": r.get("shape") or [r.get("B"), r.get("H"),
                                                      r.get("T"), r.get("d")],
            f"{prefix}d256_ms": t["ms"],
            f"{prefix}d256_device_ms": t["device_ms"],
            f"{prefix}d256_bound_ms": t["bound_ms"],
            f"{prefix}d256_bound_by": t["bound_by"],
            f"{prefix}d256_plain_device_ms": r["plain_device_ms"],
            f"{prefix}d256_library_device_ms": r.get("library_device_ms"),
            f"{prefix}d256_smem_bytes": r.get("smem_bytes"),
            f"{prefix}d256_max_abs_err": (max(err[g] for g in grads)
                                          if grads else err),
            f"{prefix}launches_wide_heads": launches_wide,
            f"{prefix}launches_wide_heads_at_d256": at256}


def kernel_line(flash, paged, bwd, launches, launches_d96,
                launches_recurrent, launches_graphs, launches_pretrain,
                launches_nlp, launches_ingest, launches_mesh,
                launches_sharding, federation, groups, launches_analysis,
                launches_wide, at256):
    k1 = flash["slice_f32_causal"]
    k2 = paged["f32_T1_Tmax512"]
    k2c = paged["f32_T256_Tmax512"]          # the serve's first prefill round
    k2s = paged["f32_T48_Tmax512"]           # ... and a second, split
    kb16 = paged["bf16_T1_Tmax512"]          # a bf16 model's decode step
    kb16c = paged["bf16_T256_Tmax512"]       # ... and its prefill round
    kb = bwd["slice_f32_causal"]
    slice_bwd = [r for n, r in bwd.items() if n.startswith("slice_f32")]
    line = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "deeplearning4j_torch/kernels/flash_fwd.cu",
         "replaces": "deeplearning4j_tpu/ops/pallas_attention.py:135",
         "launches": launches["flash_fwd"],
         "launches_recurrent": launches_recurrent["flash_fwd"],
         "launches_graphs": launches_graphs["flash_fwd"],
         "launches_pretrain": launches_pretrain["flash_fwd"],
         "launches_nlp": launches_nlp["flash_fwd"],
         "launches_ingest": launches_ingest["flash_fwd"],
         "launches_mesh": launches_mesh["flash_fwd"],
         "launches_sharding": launches_sharding["flash_fwd"],
         "launches_analysis": launches_analysis["flash_fwd"],
         **federation_fields(federation, "flash_fwd"),
         **group_fields(groups, "flash_fwd"),
         "max_abs_err": max(r["max_abs_err"] for n, r in flash.items()
                            if n.startswith("slice_f32")),
         "ms": k1["ms"], "device_ms": k1["device_ms"],
         "plain_ms": k1["plain_ms"],
         "plain_device_ms": k1["plain_device_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"],
         "library_device_ms": k1["library_device_ms"],
         # head dims 8 and 16 (f32, bf16, f16) and f16 at 32/64/128
         **small_d_fields(flash, "d8_f32_causal", "d16_f32_causal",
                          "slice_f16_causal"),
         "launches_d96": launches_d96["flash_fwd"],
         **bench_fields(flash["bench_bf16_causal"]),
         "head_dims": pad_fields(flash, PAD_DIMS, "d{}_f32_causal"),
         **wide_fields(flash, "gptj_f32_causal",
                       at256=at256["flash_fwd"],
                       launches_wide=launches_wide["flash_fwd"])},
        {"name": "paged_attn", "route": "cuda",
         "source": "deeplearning4j_torch/kernels/paged_attn.cuh",
         "replaces": ("deeplearning4j_tpu/nn/conf/layers/"
                      "paged_attention.py:226"),
         "launches": launches["paged_attn"],
         "launches_recurrent": launches_recurrent["paged_attn"],
         "launches_graphs": launches_graphs["paged_attn"],
         "launches_pretrain": launches_pretrain["paged_attn"],
         "launches_nlp": launches_nlp["paged_attn"],
         "launches_ingest": launches_ingest["paged_attn"],
         "launches_mesh": launches_mesh["paged_attn"],
         "launches_sharding": launches_sharding["paged_attn"],
         "launches_analysis": launches_analysis["paged_attn"],
         **federation_fields(federation, "paged_attn"),
         **group_fields(groups, "paged_attn"),
         "max_abs_err": max(r["max_abs_err"] for n, r in paged.items()
                            if n.startswith("f32_") and "Tmax512" in n),
         "ms": k2["ms"], "device_ms": k2["device_ms"],
         "plain_ms": k2["plain_ms"],
         "plain_device_ms": k2["plain_device_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None, "library_device_ms": None,
         # the chunk route (T > 4), at the serve's T=256 and T=48 rounds
         "chunk_launches": launches["paged_attn_chunk"],
         "chunk_launches_mesh": launches_mesh["paged_attn_chunk"],
         "chunk_launches_federation": federation["total"]["paged_attn_chunk"],
         "chunk_launches_analysis": launches_analysis["paged_attn_chunk"],
         "chunk_merge_launches": launches["paged_attn_merge"],
         "chunk_max_abs_err": max(r["max_abs_err"] for r in paged.values()
                                  if r["route"] == "chunk"
                                  and r["pool_dtype"] == "f32"),
         "chunk_int8_max_abs_err": max(r["max_abs_err"]
                                       for r in paged.values()
                                       if r["route"] == "chunk"
                                       and r["quant"]
                                       and r["dtype"] == "f32"),
         "chunk_ms": k2c["ms"], "chunk_device_ms": k2c["device_ms"],
         "chunk_plain_ms": k2c["plain_ms"],
         "chunk_plain_device_ms": k2c["plain_device_ms"],
         "chunk_bound_ms": k2c["bound_ms"], "chunk_bound_by": k2c["bound_by"],
         "chunk_T48_device_ms": k2s["device_ms"],
         "chunk_T48_splits": k2s["splits"],
         "chunk_T48_bound_ms": k2s["bound_ms"],
         # bf16 q and pools: decode T=1 and the chunk route at
         # T=256; errors relative to max|o| against the plain version on
         # f32-widened inputs
         "bf16_max_rel_err": max(r["max_rel_err"] for r in paged.values()
                                 if r["dtype"] == "bf16"),
         "bf16_ms": kb16["ms"], "bf16_device_ms": kb16["device_ms"],
         "bf16_plain_ms": kb16["plain_ms"],
         "bf16_bound_ms": kb16["bound_ms"], "bf16_bound_by": kb16["bound_by"],
         "bf16_chunk_ms": kb16c["ms"],
         "bf16_chunk_device_ms": kb16c["device_ms"],
         "bf16_chunk_plain_ms": kb16c["plain_ms"],
         "bf16_chunk_bound_ms": kb16c["bound_ms"],
         "bf16_chunk_bound_by": kb16c["bound_by"],
         **small_d_fields(paged, "f32_T1_Tmax512_d8", "f32_T1_Tmax512_d16",
                          "f16_T1_Tmax512", "decode_"),
         **small_d_fields(paged, "f32_T256_Tmax512_d8",
                          "f32_T256_Tmax512_d16", "f16_T256_Tmax512",
                          "chunk_"),
         "launches_d96": launches_d96["paged_attn"],
         "chunk_launches_d96": launches_d96["paged_attn_chunk"],
         "head_dims": pad_fields(paged, PAGED_PAD_DIMS, "f32_T1_Tmax512_d{}"),
         "chunk_head_dims": pad_fields(paged, PAGED_PAD_DIMS,
                                       "f32_T256_Tmax512_d{}"),
         **wide_fields(paged, "gptj_f32_T1_Tmax512_d256",
                       at256=at256["paged_attn"] - at256["paged_attn_chunk"],
                       launches_wide=launches_wide["paged_attn"]
                       - launches_wide["paged_attn_chunk"],
                       pattern="f32_T1_Tmax256_d{}"),
         **wide_fields(paged, "gptj_f32_T256_Tmax512_d256",
                       at256=at256["paged_attn_chunk"],
                       launches_wide=launches_wide["paged_attn_chunk"],
                       pattern="f32_T256_Tmax256_d{}", prefix="chunk_")}]
    # the plain time is the whole plain backward, the library time the
    # whole SDPA backward (dq, dk and dv together), for both kernels
    for name, part, grads, line_no in (("flash_bwd_dq", "dq", ("dq",), 289),
                                       ("flash_bwd_dkv", "dkv", ("dk", "dv"),
                                        305)):
        line.append(
            {"name": name, "route": "cuda",
             "source": "deeplearning4j_torch/kernels/flash_bwd.cu",
             "replaces": f"deeplearning4j_tpu/ops/pallas_attention.py:"
                         f"{line_no}",
             "launches": launches[name],
             "launches_recurrent": launches_recurrent[name],
             "launches_graphs": launches_graphs[name],
             "launches_pretrain": launches_pretrain[name],
             "launches_nlp": launches_nlp[name],
             "launches_ingest": launches_ingest[name],
             "launches_mesh": launches_mesh[name],
             "launches_sharding": launches_sharding[name],
             "launches_analysis": launches_analysis[name],
             **federation_fields(federation, name),
             **group_fields(groups, name),
             "max_abs_err": max(r["max_abs_err"][g] for r in slice_bwd
                                for g in grads),
             "ms": kb[part]["ms"], "device_ms": kb[part]["device_ms"],
             "plain_ms": kb["plain_ms"],
             "plain_device_ms": kb["plain_device_ms"],
             "bound_ms": kb[part]["bound_ms"],
             "bound_by": kb[part]["bound_by"],
             "library_ms": kb["library_ms"],
             "library_device_ms": kb["library_device_ms"],
             **{f"{tag}_{k}": (bwd[case][part][k] if k != "max_abs_err" else
                               max(bwd[case]["max_abs_err"][g]
                                   for g in grads))
                for tag, case in (("d8", "d8_f32_causal"),
                                  ("d16", "d16_f32_causal"),
                                  ("f16", "slice_f16_causal"))
                for k in ("device_ms", "bound_ms", "max_abs_err")},
             "launches_d96": launches_d96[name],
             **bench_fields(bwd["bench_bf16_causal"], part, grads),
             "head_dims": pad_fields(bwd, PAD_DIMS, "d{}_f32_causal", part),
             **wide_fields(bwd, "gptj_train_f32_causal", part, grads,
                           at256=at256[name],
                           launches_wide=launches_wide[name])})
    return {"kernels": line}


def federation_fields(federation, name):
    """Kernels-line fields of phase 18, whose launches happen in child
    processes: the window's total (this process's and every child's) and
    each child's own count (18a's runs; 18b's and 18c's hosts, K2 by
    route)."""
    by = federation["children"]
    if name == "paged_attn":
        per = {k: host_k2(v) for k, v in by.items() if k.startswith("18")}
    else:
        per = {k: v[name] for k, v in by.items() if v[name]}
    return {"launches_federation": federation["total"][name],
            "launches_federation_by_process": per}


def group_fields(groups, name):
    """Kernels-line fields of phase 19, whose launches happen in its rank
    processes: the window's total (this process's and every rank's) and
    each rank's own count, by leg and role."""
    return {"launches_process_groups": groups["total"][name],
            "launches_process_groups_by_process": {
                k: v[name] for k, v in groups["children"].items()}}


def bench_fields(r, part=None, grads=None):
    """Kernels-line fields of the JAX bench leg's bf16 training shape
    [32, 8, 512, 32] causal: the kernel's times (``part``: the backward's
    dq or dkv) beside its bound, the plain version's and SDPA's device
    times, and the error against the plain version."""
    t = r[part] if part else r
    err = r["max_abs_err"]
    return {"bench_bf16_ms": t["ms"], "bench_bf16_device_ms": t["device_ms"],
            "bench_bf16_bound_ms": t["bound_ms"],
            "bench_bf16_bound_by": t["bound_by"],
            "bench_bf16_plain_device_ms": r["plain_device_ms"],
            "bench_bf16_library_device_ms": r["library_device_ms"],
            "bench_bf16_max_abs_err": (max(err[g] for g in grads)
                                       if grads else err)}


def pad_fields(cases, dims, pattern, part=None):
    """Kernels-line fields of the padded head dims: per d, the width it runs
    at and D_pad/d, the f32 case ``pattern.format(d)``'s times (``part``:
    the backward's dq or dkv) and bound, and the worst error over every
    case at that d."""
    out = {}
    for d in dims:
        r = cases[pattern.format(d)]
        t = r[part] if part else r
        at_d = [c for c in cases.values()
                if c.get("d", (c.get("shape") or [0] * 4)[3]) == d]
        worst = [c["max_abs_err"] for c in at_d]
        worst = [max(w.values()) if isinstance(w, dict) else w
                 for w in worst]
        out[str(d)] = dict(width=r["width"], pad_ratio=r["pad_ratio"],
                           ms=t["ms"], device_ms=t["device_ms"],
                           plain_device_ms=r["plain_device_ms"],
                           bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                           library_device_ms=r.get("library_device_ms"),
                           smem_bytes=r.get("smem_bytes"),
                           max_abs_err=max(worst), cases=len(at_d))
    return out


def small_d_fields(cases, d8, d16, f16, prefix=""):
    """Kernels-line fields of the head-dim-8/16 and f16 instantiations:
    each named case's device time, bound and error, and the worst error
    over every case at those head dims."""
    out = {}
    for tag, name in (("d8", d8), ("d16", d16), ("f16", f16)):
        r = cases[name]
        out.update({f"{prefix}{tag}_device_ms": r["device_ms"],
                    f"{prefix}{tag}_bound_ms": r["bound_ms"],
                    f"{prefix}{tag}_max_abs_err": r["max_abs_err"]})
    small = [r["max_abs_err"] for r in cases.values()
             if r.get("d", (r.get("shape") or [0] * 4)[3]) in (8, 16)]
    out[f"{prefix}small_d_max_abs_err"] = max(small)
    return out


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="directory for chip_smoke.json and the "
                    "profile tables")
    ap.add_argument("--verbose-build", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    from deeplearning4j_torch import kernels

    t_start = time.perf_counter()
    # the wall seconds of each launch window (and of what ran between two)
    window_s = {}
    last = [t_start]

    def lap():
        now = time.perf_counter()
        spent, last[0] = now - last[0], now
        return spent

    card = card_line()
    log(card)
    dev = torch.device("cuda")
    REPORT["card"] = card
    REPORT["torch"] = torch.__version__

    log("phase 1: build the kernels")
    t0 = time.perf_counter()
    kernels.load(verbose=args.verbose_build)
    REPORT["build_s"] = time.perf_counter() - t0
    log(f"  built in {REPORT['build_s']:.1f} s")

    log("phase 2: K1 flash forward vs its plain version")
    flash = REPORT["flash_fwd"] = phase_flash(dev)
    log("phase 3: K2 paged attention vs its plain version")
    paged = REPORT["paged_attn"] = phase_paged(dev)

    net, cpu = build_nets()
    kernels.reset_launch_counts()         # the serving path starts here
    log("phase 4: the slice model's output() on the card")
    REPORT["model"] = phase_model(net, cpu)
    log("phase 5: serving, f32 then int8 KV pages")
    REPORT["serve"] = phase_serve(net, card)
    serving = dict(kernels.LAUNCHES)      # ... and ends here
    window_s["serving"] = lap()
    check(all(serving[k] > 0 for k in ("flash_fwd", "paged_attn",
                                       "paged_attn_chunk",
                                       "paged_attn_merge")),
          f"a kernel of the serving path never launched: {serving}")

    greedy = REPORT["serve"]["f32"]["streams"]
    kernels.reset_launch_counts()         # the zip-and-sample path starts
    log("phase 4b: the model zip at full width, saved and loaded on the "
        "card")
    loaded, REPORT["zip"] = phase_zip(net, greedy, card)
    log("phase 5b: a mixed greedy and sampled serve of the loaded net")
    REPORT["sampled"] = phase_sampled(
        loaded, greedy, REPORT["serve"]["f32"]["tokens_per_s"], card)
    log("phase 5c: a bf16 TransformerLM served through K2")
    REPORT["bf16_serve"] = phase_bf16(numpy_params(net, seed=0), card)
    loading = dict(kernels.LAUNCHES)      # ... and ends here
    window_s["loading"] = lap()
    check(all(loading[k] > 0 for k in ("flash_fwd", "paged_attn",
                                       "paged_attn_chunk",
                                       "paged_attn_merge")),
          f"a kernel of the zip-and-sample path never launched: {loading}")

    kernels.reset_launch_counts()         # the fixture path starts here
    log("phase 4c: the committed d=8 fixture on the card")
    REPORT["fixture"] = phase_fixture(card)
    fixture = dict(kernels.LAUNCHES)      # ... and ends here
    window_s["fixture"] = lap()
    check(all(fixture[k] > 0 for k in ("flash_fwd", "paged_attn",
                                       "paged_attn_chunk", "flash_bwd_dq",
                                       "flash_bwd_dkv")),
          f"a kernel of the fixture path never launched: {fixture}")

    kernels.reset_launch_counts()         # the prefix-sharing path starts
    log("phase 5d: shared-prefix, preemption and handoff serves at full "
        "width")
    REPORT["prefix"] = phase_prefix(net, card)
    prefix = dict(kernels.LAUNCHES)       # ... and ends here
    window_s["prefix"] = lap()
    check(all(prefix[k] > 0 for k in ("paged_attn", "paged_attn_chunk")),
          f"a kernel of the prefix-sharing path never launched: {prefix}")

    kernels.reset_launch_counts()         # the speculative path starts here
    log("phase 5e: speculative, role-split, migrating and chaos serves at "
        "full width")
    REPORT["spec"] = phase_spec(net, greedy, card)
    spec = dict(kernels.LAUNCHES)         # ... and ends here
    window_s["spec"] = lap()
    check(all(spec[k] > 0 for k in ("paged_attn", "paged_attn_chunk")),
          f"a kernel of the speculative path never launched: {spec}")

    net96, cpu96 = build_d96_nets()
    kernels.reset_launch_counts()         # the d=96 serving path starts
    log(f"phase 5f: a TransformerLM of head dim {D96} (f32 and int8 "
        f"weights) served through K1 and K2")
    REPORT["d96_serve"] = phase_d96(net96, cpu96, card)
    d96_serving = dict(kernels.LAUNCHES)  # ... and ends here
    window_s["d96_serving"] = lap()
    at96 = {k: kernels.LAUNCHES_BY_D.get((k, D96), 0) for k in
            ("flash_fwd", "paged_attn", "paged_attn_chunk")}
    check(all(n > 0 for n in at96.values())
          and at96["paged_attn"] > at96["paged_attn_chunk"],
          f"a kernel of the d={D96} serving path never launched at "
          f"d={D96} (K2's decode route: paged_attn beyond paged_attn_chunk): "
          f"{at96}")
    REPORT["d96_serve"]["launches_at_d96"] = at96

    log("phase 6: K3/K4 flash backward vs its plain version")
    bwd = REPORT["flash_bwd"] = phase_flash_bwd(dev)

    kernels.reset_launch_counts()         # the training path starts here
    log("phase 7: training the slice model with Adam on the card")
    REPORT["train"] = phase_train(net, cpu, card)
    training = dict(kernels.LAUNCHES)     # ... and ends here
    window_s["training"] = lap()
    check(all(training[k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv")),
          f"a kernel of the training path never launched: {training}")

    kernels.reset_launch_counts()         # the d=96 training path starts
    log(f"phase 7b: three Adam steps of the head-dim-{D96} model on the "
        f"card")
    REPORT["d96_train"] = phase_train_d96(net96, cpu96, card)
    d96_training = dict(kernels.LAUNCHES)  # ... and ends here
    window_s["d96_training"] = lap()
    check(all(kernels.LAUNCHES_BY_D.get((k, D96), 0) > 0
              for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
          f"a kernel of the d={D96} training path never launched at "
          f"d={D96}: {kernels.LAUNCHES_BY_D}")
    del net96, cpu96

    kernels.reset_launch_counts()         # the fit path starts here
    log("phase 7c: the JAX bench leg's bf16 TransformerLM through fit at "
        "its defaults, then the training fields")
    bench, REPORT["bench_train"] = phase_bench_train(card)
    REPORT["train_fields"] = phase_train_fields(numpy_params(net, seed=0),
                                                card)
    fitting = dict(kernels.LAUNCHES)      # ... and ends here
    window_s["fitting"] = lap()
    check(all(fitting[k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv", "paged_attn",
                                       "paged_attn_chunk")),
          f"a kernel of the fit path never launched: {fitting}")
    kernels.reset_launch_counts()         # the MultiLayerNetwork path
    log("phase 8: the MultiLayerNetwork substrate (LeNet, the conv-net "
        "fixture, int8 LeNet, SimpleCNN/AlexNet/VGG16)")
    REPORT["multilayer"] = phase_multilayer(card, args.profile)
    multilayer = dict(kernels.LAUNCHES)   # ... and ends here
    window_s["multilayer"] = lap()
    check(not any(multilayer.values()),
          f"the MultiLayerNetwork path launched an attention kernel: "
          f"{multilayer}")
    kernels.reset_launch_counts()         # the serving fabric starts here
    log("phase 9: the serving fabric (fleets, ParallelInference, HTTP, "
        "load and autoscaling)")
    REPORT["fabric"] = phase_fabric(card, greedy,
                                    REPORT["sampled"]["streams"])
    fabric = dict(kernels.LAUNCHES)       # ... and ends here
    window_s["fabric"] = lap()
    check(all(fabric[k] > 0 for k in ("flash_fwd", "paged_attn",
                                      "paged_attn_chunk", "flash_bwd_dq",
                                      "flash_bwd_dkv")),
          f"a kernel of the serving fabric never launched: {fabric}")
    kernels.reset_launch_counts()         # retrieval and RAG start here
    log("phase 10: retrieval and RAG (the f32, int8 and IVF stores, the "
        "k-NN HTTP server, RagPipeline, t-SNE)")
    REPORT["retrieval"] = phase_retrieval(card)
    retrieval = dict(kernels.LAUNCHES)    # ... and end here
    window_s["retrieval"] = lap()
    check(all(retrieval[k] > 0 for k in ("paged_attn", "paged_attn_chunk")),
          f"a kernel of the RAG generate tier never launched: {retrieval}")
    kernels.reset_launch_counts()         # the recurrent path starts here
    log("phase 11: recurrent nets (TextGenerationLSTM by TBPTT, streaming "
        "and generation, masked sequence classifiers, early stopping)")
    REPORT["recurrent"] = phase_recurrent(card)
    recurrent = dict(kernels.LAUNCHES)    # ... and ends here
    window_s["recurrent"] = lap()
    check(not any(recurrent.values()),
          f"the recurrent path launched an attention kernel: {recurrent}")
    kernels.reset_launch_counts()         # the graph path starts here
    log("phase 12: graphs and fine-tuning (the graph zoo, transfer "
        "learning, a mixture of experts, the solvers, every vertex)")
    REPORT["graphs"] = phase_graphs(card)
    graphs = dict(kernels.LAUNCHES)       # ... and ends here
    window_s["graphs"] = lap()
    check(not any(graphs.values()),
          f"the graph path launched an attention kernel: {graphs}")
    kernels.reset_launch_counts()         # the pretraining path starts here
    log("phase 13: layer-wise pretraining (a deep belief stack, the VAE, a "
        "stacked denoising AutoEncoder), the data pipeline and listeners")
    REPORT["pretrain"] = phase_pretrain(card, args.out)
    pretrain = dict(kernels.LAUNCHES)     # ... and ends here
    window_s["pretrain"] = lap()
    check(not any(pretrain.values()),
          f"the pretraining path launched an attention kernel: {pretrain}")
    kernels.reset_launch_counts()         # the NLP path starts here
    log("phase 14: the NLP embedding stack (Word2Vec, ParagraphVectors, "
        "GloVe), DeepWalk and Keras import")
    REPORT["nlp"] = phase_nlp(card)
    nlp = dict(kernels.LAUNCHES)          # ... and ends here
    window_s["nlp"] = lap()
    check(not any(nlp.values()),
          f"the NLP path launched an attention kernel: {nlp}")
    kernels.reset_launch_counts()         # the ingest path starts here
    log("phase 15: the data-ingest and telemetry stack (DataVec into fit, "
        "the streaming broker and route, the UI stats pipeline)")
    REPORT["ingest"] = phase_ingest(card)
    ingest = dict(kernels.LAUNCHES)       # ... and ends here
    window_s["ingest"] = lap()
    check(all(ingest[k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv"))
          and not any(v for k, v in ingest.items()
                      if k.startswith("paged_attn")),
          f"the ingest path: K1, K3 and K4 must launch and K2 must not: "
          f"{ingest}")
    kernels.reset_launch_counts()         # the mesh path starts here
    log("phase 16: several devices of one process (tensor-parallel "
        "serving, cross-tp handoff, replica groups, data-parallel "
        "inference, evaluation and training)")
    REPORT["mesh"] = phase_mesh(card, greedy,
                                REPORT["serve"]["int8"]["streams"],
                                REPORT["sampled"]["streams"])
    mesh = dict(kernels.LAUNCHES)         # ... and ends here
    window_s["mesh"] = lap()
    check(all(mesh[k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv", "paged_attn",
                                    "paged_attn_chunk")),
          f"a kernel of the mesh path never launched: {mesh}")
    kernels.reset_launch_counts()         # the model-parallel path starts
    log("phase 17: sharded stores and one-process model parallelism "
        "(sharded retrieval, dp x tp ShardedTrainer, tensor/sequence/"
        "pipeline parallelism, Spark averaging, sharded embeddings, the "
        "parameter server)")
    REPORT["model_parallel"] = phase_model_parallelism(card)
    sharding = dict(kernels.LAUNCHES)     # ... and ends here
    window_s["sharding"] = lap()
    check(all(sharding[k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv")),
          f"a kernel of the model-parallel path never launched (K1, K3 and "
          f"K4 must): {sharding}")
    kernels.reset_launch_counts()         # the federation path starts here
    log("phase 18: processes on one host (a FaultTolerantTrainer child "
        "killed and resumed, host processes behind a FleetFederation "
        "router, a host SIGKILLed mid-stream)")
    REPORT["federation"], children = phase_federation(
        card, greedy, REPORT["sampled"]["streams"],
        REPORT["fabric"]["fleet"]["tokens_per_s"])
    # its kernels run in the child processes, which count their own
    federation = {k: kernels.LAUNCHES[k] + children[k] for k in serving}
    window_s["federation"] = lap()
    check(all(federation[k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                          "flash_bwd_dkv", "paged_attn",
                                          "paged_attn_chunk")),
          f"a kernel of the federation path never launched: {federation}")
    kernels.reset_launch_counts()         # the process-group path starts
    log("phase 19: process groups (two ranks train the slice model on "
        "their rows of one batch, save a sharded checkpoint, and a fresh "
        "pair resumes from it)")
    REPORT["process_groups"], group_children = phase_process_groups(card)
    # its kernels run in the rank processes, which count their own
    groups = {k: kernels.LAUNCHES[k] + group_children[k] for k in serving}
    window_s["process_groups"] = lap()
    check(all(groups[k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv")),
          f"a kernel of the process-group path never launched (K1, K3 and "
          f"K4 must): {groups}")
    kernels.reset_launch_counts()         # the analysis path starts here
    log("phase 20: graftcheck (the static gate without JAX, phase 9's "
        "fleet with phase 10's RAG route, a k-NN server, a coalescer and "
        "a broker under the lock-order instrument, the seeded inversion)")
    REPORT["analysis"] = phase_analysis(
        card, greedy, REPORT["sampled"]["streams"],
        REPORT["fabric"]["fleet"]["tokens_per_s"],
        REPORT["retrieval"]["rag"]["route"])
    analysis = dict(kernels.LAUNCHES)     # ... and ends here
    window_s["analysis"] = lap()
    check(all(analysis[k] > 0 for k in ("flash_fwd", "paged_attn",
                                        "paged_attn_chunk")),
          f"a kernel of the lock-checked serve never launched (K1 and both "
          f"routes of K2 must): {analysis}")
    kernels.reset_launch_counts()         # the wide-head path starts here
    log(f"phase 21: GPT-J-6B's attention width ({GPTJ['n_heads']} heads of "
        f"d = {GPTJ_D}, d_model {GPTJ['d_model']}, FFN "
        f"{4 * GPTJ['d_model']}, {GPTJ['n_blocks']} blocks): output() and "
        f"the zip, f32/int8-KV and bf16 serves, fit")
    REPORT["wide_heads"] = phase_wide_heads(card)
    wide = dict(kernels.LAUNCHES)         # ... and ends here
    window_s["wide_heads"] = lap()
    at256 = {k: kernels.LAUNCHES_BY_D.get((k, GPTJ_D), 0) for k in
             ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_attn",
              "paged_attn_chunk")}
    check(all(n > 0 for n in at256.values())
          and at256["paged_attn"] > at256["paged_attn_chunk"],
          f"a kernel of the wide-head path never launched at d={GPTJ_D} "
          f"(K1, K3, K4 and both routes of K2 must): {at256}")
    REPORT["wide_heads"]["launches_at_d256"] = at256
    windows = dict(serving=serving, loading=loading, fixture=fixture,
                   prefix=prefix, spec=spec, d96_serving=d96_serving,
                   training=training, d96_training=d96_training,
                   fitting=fitting, multilayer=multilayer, fabric=fabric,
                   retrieval=retrieval, recurrent=recurrent, graphs=graphs,
                   pretrain=pretrain, nlp=nlp, ingest=ingest, mesh=mesh,
                   sharding=sharding, federation=federation,
                   process_groups=groups, analysis=analysis,
                   wide_heads=wide)
    launches = {k: sum(w[k] for w in windows.values()) for k in serving}
    REPORT["main_path_launches"] = dict(windows, total=launches)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path never launched: {launches}")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.profile:
        log("profile: one f32 serve, one mixed greedy/sampled serve, "
            "five training steps and one fused bench block under "
            "torch.profiler")
        REPORT["profile"] = profile_serve(net, card, args.out)
        REPORT["sampled_profile"] = profile_serve(
            loaded, card, args.out, sampled_requests(), "sampled")
        REPORT["train_profile"] = profile_train(net, card, args.out)
        REPORT["bench_fit_profile"] = profile_bench_fit(bench, card,
                                                        args.out)

    REPORT["profiler_windows"] = WINDOW_LOG
    log(f"profiler windows: {WINDOW_LOG['timings']} timings, "
        f"{len(WINDOW_LOG['retried'])} needed more than one window: "
        f"{WINDOW_LOG['retried']}")
    line = kernel_line(flash, paged, bwd, launches,
                       {k: d96_serving[k] + d96_training[k]
                        for k in d96_serving}, recurrent, graphs, pretrain,
                       nlp, ingest, mesh, sharding,
                       dict(total=federation,
                            children=REPORT["federation"][
                                "children_launches"]),
                       dict(total=groups,
                            children=REPORT["process_groups"][
                                "children_launches"]), analysis, wide,
                       at256)
    REPORT["total_s"] = time.perf_counter() - t_start
    REPORT["window_s"] = window_s
    log(f"build {REPORT['build_s']:.1f} s, total {REPORT['total_s']:.1f} s; "
        f"seconds to the end of each window (from the previous one's end: "
        f"the build and phases 2-3 fall in serving's, phase 6 in "
        f"training's) "
        f"{json.dumps({k: round(v, 1) for k, v in window_s.items()})}")
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(REPORT, kernels=line["kernels"]), f, indent=1)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
