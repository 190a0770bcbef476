#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py            # one card
    python3 chip_smoke.py --nccl     # 2+ cards: the reference job over NCCL
    python3 chip_smoke.py --fsdp     # one card: train_fsdp alone

Phases, one JSON line each on stdout:

1. ``env``: the card (``nvidia-smi`` name and power limit), torch, CUDA.
2. ``build``: the hand-written CUDA kernels, compiled from ``csrc/``,
   with ``-Xptxas -v``'s registers, spills and static shared memory of
   the K1/K2/K6/K7 bf16 (wgmma) kernels and of K4/K5's quantize pass and
   int8 GEMM, beside the dynamic shared memory their launchers request.
3. ``kernels``: each kernel against its plain PyTorch version on the card,
   in bf16 at the shapes each path gives it (K1 and K3 at the serving
   path's and the train step's, K3 also at the decode step's 8 rows, K2a
   and K2b at the train step's, K1, K2a and K2b also at head_dim 64 and
   32, K4 and K5 at the int8 MLP's four call sites of the int8 train
   step, every epilogue and prologue variant, and one small non-square
   case (and, beside tensor parallelism, each tp2 shard's sites: the
   column ones at N / 2, the split-K ones at K / 2 with fp32 partials,
   also at gpt_mini's width, whose K-blocks span both shards and take
   kernel A twice, the second time with the block's scales given, held
   bit for bit to its plain version), each also as its two kernels apart (the quantize pass and the
   block-scaled GEMM, each held bit for bit to its plain version, the
   GEMM's gelu output within one ulp; K4's weight transpose too); K6, K7a
   and K7b at the ring train step's per-hop shape, q/k/v
   shards [8, 256, 16, 128], for a chunk wholly visible, on the diagonal
   and wholly in the future, a padding mask with fully masked rows, a
   window, non-causal, D = 64 and D = 32, K6 in the in-place form the
   ring calls (held bit for bit to its out-of-place form, and a chunk in
   the future must leave the carries untouched), K7a and K7b adding into
   fp32 sums as the ring calls them (held bit for bit to the out-of-place
   partial + ``add_``, a chunk in the future leaving the sums untouched,
   two calls bit-equal), then the 4-shard ring
   over them against K1/K2 on the whole sequence; K1, K2a and K2b also at
   the train_parallel arms' per-shard shapes (8 and 4 heads of the train
   step; the parallel CLI's gpt_mini, 1 head a seq device) and at a
   pipeline stage's micro-batch (the train step's [1, 1024, 16, 128],
   the pipeline CLI's [8, 512, 4, 32]; K3 at their rows) and at the
   config ladder's (BERT-tiny's [100, 128, 2, 64] non-causal under a
   ragged key-padding mask, ViT-tiny's [100, 64, 4, 32]; K3 on 128-wide
   fp32 and bf16 rows), K6, K7a and
   K7b at the tp2 x ring2 step's hops ([8, 512, 8, 128]: visible,
   diagonal, future); K8, on no path, at the
   int8 MLP's mlp_in dgrad shape, with and without g, also as its three
   launches apart, as K4's; K3 also at the chunked prefill's dispatch
   and the speculative verify's rows; K1 at the generate phase's prefill
   and K3 at its decode step's rows), with the tolerance stated below, its
   time, the plain version's time, one library call's time (used only
   here, never by the port; K4/K5/K8 have two labelled yardsticks) and
   the least time the card could take; K1, K2, K3 and K6 rows also carry
   ``ratio_to_library`` (kernel over library time; K2's and K7's library
   call computes dq, dk and dv, so their rows give ``pair_ratio_to_library``
   for K2a + K2b, K7a + K7b), K1/K2 ``tflops`` (the useful operations the bound counts,
   over the kernel's time); K1 and K3 rows add ``host_ms`` and
   ``library_host_ms``, the host time per call of each (at the serving
   shapes it exceeds the kernel's device time; K6/K7 ``host_ms`` too),
   K3, K6 and K7 rows ``device_ms`` (K3 also ``library_device_ms``), the
   device's time per call apart from the host's (calls captured in a
   CUDA graph and replayed, ``utils/cuda_timing.py``).
4. ``serve``: a GPT at the widths of the repo's GPT-406M (hidden 2048,
   8 layers, 16 heads, MLP 8192, vocab 256, bf16, random weights from a
   seeded generator) behind ``ServingServer``; 8 concurrent HTTP requests
   from two tenants (prompts of 100-777 tokens, 64 new tokens each, greedy
   and seeded-sampled) through ``ServeClient``.  The kernels' launch
   counters are set to 0 just before and read just after.  Before it, the
   ``profile`` line: ``torch.profiler`` over one more request, the card's
   busy share of it and the kernels that took its device time.
5. ``serve_chunked``: the same model and requests through an engine with
   ``prefill_chunk=128``.  Gate: in fp32 at the full width and 2 layers,
   every prompt's greedy tokens equal the whole-bucket engine's.  Then
   each prompt's first-token logits within
   ``MODEL_LOGIT_TOL`` of the whole-bucket engine's, each request's tokens
   against the serve phase's (the first divergence printed, not gated: a
   bf16 near-tie may flip an argmax), K3's launches exact (2 a layer a
   chunk dispatch, 2 a layer + 1 a decode step, no K1), and tokens/s,
   TTFT and TPOT beside the serve phase's.
6. ``serve_spec``: the speculative arm (``spec_k=4``, ``spec_ngram=3``)
   on greedy ``speculative=True`` requests whose prompts repeat a seeded
   24-token phrase to the serve phase's lengths.  Gate: in fp32 at the
   full width and 2 layers, every request's tokens equal the plain
   engine's.  Then the bf16 model over HTTP, the plain engine and the
   speculative one: the accepted share of the drafts, spec rounds,
   tokens/s and TPOT, K1 and K3 launches exact.
7. ``generate``: the library decode family on the same model
   (``generate``, ``generate_cached``, ``beam_search_cached``,
   ``generate_cached_speculative`` and ``..._device``) at B=4 prompts of
   384 tokens.  Gates, in fp32 at the full width and 2 layers: every
   greedy arm gives ``generate_cached``'s tokens, and with
   ``attention_window=256`` the ring cache gives the uncached loop's
   (K1's window band).  Then the bf16 model: ``generate_cached``'s
   tokens/s, ms a step, prefill ms and peak memory (128 new tokens), a
   width-4 beam's ms a token, both speculative loops on repeated-phrase
   prompts beside ``generate_cached``, the int8-weight / float8-cache
   arm's first divergence from bf16 (not gated), and the
   ``generate_profile`` line over 16 tokens; every arm's K1 and K3
   launches exact (the fp32 host loop's fallback finish aside).
8. ``checkpoint``: from a checkpoint on disk to tokens, on the same
   model.  ``save_raw`` writes it as the JAX trainer saves (fp32 arrays,
   ``{params, global_step}``, step 1) under a ``tempfile`` directory
   (removed afterwards); the serving CLI (``tools/serve.py --hot_swap``)
   serves it as a process and gets the serve phase's 8 requests (gate:
   the greedy ones' tokens are the serve phase's in-process engine's);
   step 2 (seed-1 weights) is saved while a 900-token request streams
   (gates: the stream runs to its budget, ``/statz`` shows the swap, a
   later request gets the tokens of an engine on the step-2 weights in
   memory); in this process, an engine on the restored tree gives the
   in-memory engine's tokens with K1 8 a prefill and K3 17 a prefill or
   step; ``train.py --mode=generate`` greedy, beam 4 and speculative 8,
   three processes side by side, give the in-process decode family's
   tokens.  It
   prints the write and restore GB/s, the CLI's startup seconds, the
   time from step 2's rename into place to its adoption, and tokens/s.
9. ``fleet``: the serving fleet tier on the same model, saved as the
   ``checkpoint`` phase saves it.  ``tools/serve_fleet.py`` spawns two
   replicas (``tools/serve.py`` processes on the card, ``ENGINE``'s pool,
   tenants ``search:2,ads:1``) behind its router, with ``--respawn`` and
   an autoscaler armed up to three.  ``fleet_serve``: the serve phase's 8
   prompts greedy through the router (gate: each request's tokens are the
   in-process engine's; ``watch_serve --fleet --once --json`` shows 2
   healthy members).  ``fleet_kill``: 16 concurrent requests, ``r1``
   SIGKILLed once half have completed (gates: no failed request, every
   response the in-process tokens, ``r1`` dead, a respawned member
   healthy, the survivor serving both tenants).  ``fleet_autoscale``:
   requests of a tenant whose objective every request breaks until a
   third member is healthy (gate: one ``scale_up``), then the 8 prompts
   again, a tenant each, spread over the three live members (gate: the
   in-process engine's tokens).  The router's stream passes
   ``summarize_run --check`` with ``replica_dead`` and ``failed == 0``.
   ``cells_drill``: two one-replica ``tools/serve_cell.py`` cells
   (each a coordination shard, its standby, a fleet and a replica) behind
   a global router; ``tools/loadgen.py``'s ``cell_kill`` schedule (14 s,
   2 qps, seed 7, 128-token prompts, 16 new) SIGKILLs cell a at 4 s
   (gates: no failed request, no objective ever burning, ``cell_dead``
   and ``tenant_rehome`` on the global stream, ``summarize_run --check``
   green).  Every process is stopped with SIGTERM; each replica that
   served a request printed its launches on exit (gate: K1 a positive
   multiple of 8, K3 of 17, no other kernel).  It prints each replica's
   spawn-to-healthy seconds, the router's added ms a request (p50, p95),
   the fleet's tokens/s over the 8-request and the 16-request bursts
   beside the serve phase's, the kill's and the autoscaler's seconds,
   and the drill's failover gap, re-homes and 429s.
10. ``train``: the flagship GPT train step (``bench.py``'s: the same
   widths, fp32 master weights, bf16 compute, ``attention_backend=
   "pallas"``, plus ``fused_ln=True``; Adam 3e-4, B=8, S=1024, the
   synthetic LM stream) through ``TrainState`` and
   ``build_sync_train_step``.  First one step's loss and gradients through
   the kernels against the plain path with the same weights and batch;
   then 30 steps with the launch counters set to 0 just before and read
   just after (the loss must stay finite and fall); then the
   ``train_profile`` line, ``torch.profiler`` over one more step.
11. ``train_int8``: the same step with ``matmul_int8=True`` (bench.py's
   int8 arm, :2271): each block's gelu MLP through K4 and K5.  The same
   kernel-vs-plain check (the plain path also takes the plain versions of
   K4/K5), 30 steps with exact launch counts (K4 and K5 twice per layer,
   each call one quantize pass and one GEMM, K4's one weight transpose),
   the loss held to the bf16 phase's, the ``train_int8_profile`` line,
   then a short arm with ``attn_int8=True`` as well (bench.py :2287).
12. ``train_ring``: the same step with ``attention_backend="ring"``
    (``train.py --sequence_parallel=4 --attention_backend=ring``) on a
    mesh of four sequence shards of 256 on the card: each block's
    attention is a 4-hop ring through K6 forward and K7a/K7b backward.
    One step's loss and gradients against the same ring through the
    plain chunk versions and against the pallas step (K1/K2), then 30
    steps with exact launch counts (K6, K7a, K7b each 4 shards x 4 hops x
    8 layers = 128 per step, K3 17, K1/K2 none), a falling loss, and the
    ``train_ring_profile`` line.
13. ``train_parallel`` (beside 15-16's processes, holding the busy
    lock): the same step with its mesh positions on the
    card (``ParallelConfig.place_state``: ``gpt_sharding_rules`` over the
    model axis, Megatron's split), five arms: ``tp2`` (pallas, seq=1 x
    model=2), ``ulysses4`` (seq=4), ``tp2_ring2`` (each model column its
    own ring over its 8 heads), ``tp2_ulysses2`` and ``tp2_int8`` (tp2
    with the int8 MLP: K4/K5 a shard, held to the unsharded int8 step
    under the TRAIN_INT8_* tolerances).  Each arm: one step (the shards'
    gradients gathered) against the unsharded pallas step under the
    TRAIN_* tolerances, ``PARALLEL["steps"]`` steps with exact launches
    per shard (K1/K2a/K2b once a layer per (model column, seq device);
    K6/K7a/K7b once a hop per (model column, seq shard); K3 2L + 1,
    replicated; K4/K5 twice a layer per shard) and a falling loss; it
    prints step ms, its ratio to the ``train`` phase's, MFU and peak
    memory, and a ``train_parallel_profile`` line (one profiled step).
14. ``train_pipeline`` (run beside 18's MNIST jobs, holding the busy
    lock): the same step (Adam, seed-0 weights) with its
    decoder blocks as pipeline stages on the card
    (``models/registry.build_gpt_pipeline``), three arms of 8
    micro-batches: ``gpipe`` and ``1f1b`` over pipe=4, ``interleaved``
    over pipe=2 with 2 virtual stages.  Each: its first step against the
    unpipelined pallas step (TRAIN_*), ``PIPELINE["steps"]`` steps with
    launches exactly the schedule's count (:func:`pipeline_launches`:
    1F1B and interleaved recompute each chunk's forward but the last's)
    and a falling loss; it prints step ms, its ratio to the bf16 step's,
    peak memory (against the bf16 step's: the stash bound), the most
    stage inputs stashed at once, and the busy share.
15. ``train_fsdp``, beside the two CLIs of 16: ZeRO-3 over two sync
    workers on the one card (two gloo ranks as processes, B=8 each),
    ``FSDP["steps"]`` steps of the FSDP state (parameters and Adam slots
    split by ``fsdp_state``, gathered for the step, reduce-scattered after
    it) and of the replicated two-rank step; the first step's loss and
    gradients under TRAIN_* (bit-equality stated); it prints each rank's
    persistent parameter and slot bytes (gate: under 0.55 of replicated),
    peak memory (gate: under replicated's), step ms and the all-gather
    and reduce-scatter ms a step, contended by the CLIs beside it
    (``--fsdp`` times it alone).
16. Two gpt_mini trainer CLIs beside ``train_fsdp`` (B=32, S=512,
    each with ``--mode=eval`` (its test accuracy) and ``--mode=generate``
    (an in-process decode's tokens) on its logdir, its launches exact):
    ``train_parallel_cli`` (``--tensor_parallel=2 --sequence_parallel=2
    --attention_backend=ulysses --fused_layer_norm --log_sharding``:
    four positions on the one card, as its layout line says, 15 steps)
    and ``train_pipeline_cli`` (``--pipeline_parallel=2
    --pipeline_schedule=1f1b --pipeline_microbatches=4``, pallas and
    fused LN, 11 steps; generate from the stage-stacked checkpoint of
    namespace ``gpt_mini_pp2``).
17. ``trainer``: the port's trainer CLI (``train.py``) as processes.
    ``trainer_reference``: the reference job with
    ``examples/launch_local_cluster.sh``'s flags (one PS and two sync
    workers, MNIST MLP 784-100-10, global batch 100, 200 steps, lr 0.01,
    synthetic MNIST), both workers on the one card with a gloo all-reduce
    a step.  Gates: both workers exit 0 with the reference's lines (the
    chief's ``Initailizing session``, worker 1's ``Waiting for
    session``), the PS alive until stopped, the two workers' parameter
    digests equal (bit-equal parameters), the test accuracy within
    ``TRAINER["accuracy_tol"]`` of the JAX CLI's with the same flags.  It
    prints step ms, steps/s, the all-reduce's share of a step and each
    worker's busy share (``--profile_dir``).  Beside it,
    ``trainer_reference_fsdp``: the same job with ``--fsdp=true`` (the
    MLP's hid/kernel split over the two workers), under the same gates
    and its test accuracy within the tolerance of the replicated job's,
    and ``trainer_gpt`` and ``async_gpt`` (of 18; the four run side by
    side): gpt_mini
    at ``mini()``'s width through ``--attention_backend=pallas
    --fused_layer_norm`` (B=32, S=512, 19 steps, a checkpoint every 10),
    one worker and no PS; gates: its K1, K2a, K2b and K3 launches exactly
    as its steps and eval forwards predict, a falling loss, ``--mode=eval``
    on its logdir reproducing its test accuracy, ``--mode=generate``'s
    greedy tokens equal to an in-process decode of the restored tree
    (eval and generate side by side).
    It prints step ms, tokens/s and peak memory, and
    ``trainer_gpt_profile`` the busy share of the same bundle's step in
    this process.  The K1/K2a/K2b/K3 rows' ``trainer`` paths hold the
    kernels at this run's shapes (the ``kernels`` phase's ``trainer``
    cases) with its launches.
18. ``async_trainer``: the trainer in async mode (``--sync_replicas=
    false``, one replica a worker on one card, the workers averaging through the
    coordination service), processes on the one card.
    ``async_reference``: the reference job with ``--async_sync_period=4``,
    steps paced and worker 1 started once worker 0 has published, worker
    0 leading by ``ASYNC["lead_steps"]`` steps (as
    ``tests/test_multiprocess.py:240`` does); gates: both exit 0 with a
    test accuracy within ``TRAINER["accuracy_tol"]`` of the JAX CLI's with
    the same flags on a CPU, ``averaged parameters with 1 peer(s)`` and
    ``(kv publish`` printed, worker 1 adopting the published parameters.
    ``async_overlap``: the same job with ``--async_compress=int8
    --async_overlap_exchange=true``; gates: the compressed exchange on,
    overlapped averages applied in the background, no foreground average,
    the accuracy gate; it prints the wire bytes of a round beside the
    full state's.  Both print step ms (paced), the exchange's ms a period
    and its share of the training time, and publish MB/s.  These two jobs
    run side by side, alone; ``async_gpt`` runs beside the ``trainer``
    phase's jobs (one in-process busy profile at a time) and
    ``async_exchange``, with the config ladder's CLIs, beside 8
    (``checkpoint``).
    ``async_gpt``: gpt_mini at ``mini()``'s width through the kernels, two
    workers and no PS, a merge every 10 local steps; gates: each worker's
    K1, K2a, K2b and K3 launches exactly as its local steps and eval
    forwards predict, a falling loss, an average with the peer.  It prints
    the exchange ms a period and peak memory, and the async step's ms,
    tokens/s and busy share in this process.  ``async_exchange``: two
    ``ParamAverager``s on one in-process coordination service exchange a
    GPT-406M-width bf16 tree through the logdir side-channel (gate: the
    consensus adopted onto the card is bit-equal to the fp32 mean cast to
    bf16 on the card), then two int8 ``CompressedShardedAverager``s over
    an eighth of the tree cut by depth (the embeddings and the first of
    the eight blocks, widths unchanged; the codec is host numpy and
    zlib) (gates: a round's wire bytes at least 4x below that part's full
    state, the consensus within the codec's error bound of the exact
    mean); it prints each leg's ms and GB/s.  The K1/K2a/K2b/K3 rows carry ``async_trainer_launches``
    (both workers of ``async_gpt``).
19. The config ladder (slice 7b), its parts beside earlier ones:
    ``train_models`` beside 15-16 (its counted steps under the busy
    lock), the ResNet-20 rung beside 9 (``fleet``), the other rungs
    beside ``async_exchange`` (beside 8).  ``train_models``, in this process at the
    published widths and the
    CLI's batch of 100: BERT-tiny (S=128, 2 heads of 64) and ViT-tiny (64
    patches, 4 heads of 32) through ``registry.build`` with
    ``attention_backend="pallas"`` and ``fused_ln=True``: one step's loss
    and gradients through the kernels against the plain versions' step
    (TRAIN_*), then ``MODELS["steps"]`` Adam steps with launches exactly
    K1/K2a/K2b once a layer and K3 6 (BERT: ln_emb, two a layer, mlm_ln)
    or 9 (ViT: two a layer, ln_final) a step, the loss finite and
    falling; ResNet-20 (its stateful step; gate: the running statistics
    move) and LeNet-5, SGD on the card, no kernel launched.  ``ladder``:
    the same four through the trainer CLI, processes side by side:
    LeNet-5 async with two workers (gate: they average), ResNet-20 sync
    with two gloo workers on the one card (gates: equal parameter and
    model-state digests, then ``--mode=eval`` restoring the step and the
    trained test accuracy), BERT-tiny and ViT-tiny
    (``--data_augmentation=true``) with ``--attention_backend=pallas
    --fused_layer_norm`` (gates: launches exactly as their steps and eval
    forwards predict, a finite loss).  The K1/K2a/K2b/K3 rows'
    ``train_models_<bert|vit>`` and ``ladder_<bert|vit>`` paths hold the
    ``kernels`` phase's ladder cases (BERT's ragged ``kv_mask`` at
    [100, 128, 2, 64] non-causal, ViT's [100, 64, 4, 32]; K3 on BERT's
    12800 fp32 rows and ViT's 6400 bf16 rows of 128) with those launches.
20. Items 7a and 7c, their parts beside earlier ones.
    ``train_models_bert_moe`` (in ``train_models``): BERT-tiny with 4
    experts (top-2, capacity factor 2) at BERT's shapes on the kernels:
    the kernel-vs-plain step (TRAIN_*), ``MODELS["steps"]`` steps with
    launches exactly K1/K2a/K2b once a layer and K3 6 a step, the loss
    falling, the aux loss printed; then the same model over ``expert=2``
    and ``expert=4`` positions on the one card, each arm's first step
    within TRAIN_* of the unsharded one and its step ms beside the
    unsharded one's.  ``ladder_bert_moe`` (beside ``async_exchange``):
    the CLI with ``--model=bert_moe --expert_parallel=2 --optimizer=lamb``
    on the kernels (exact launches), then ``--mode=eval`` restoring the
    trained accuracy.  ``lm_bpe`` (beside ``fleet``): gpt_mini through
    the CLI on a corpus made of this checkout's ``*.md`` and ``*.py``
    files, streamed (``--gpt_stream_corpus_mb=1``), BPE-encoded
    (``--gpt_tokenizer=bpe --gpt_bpe_vocab=512``, the native core's train
    and encode MB/s on this host and its bytes a token) and trained with
    ``--optimizer=adafactor`` on the kernels (exact launches); a second
    run resumes from the checkpoint and the saved cursor; then
    ``--mode=generate --gen_prompt_text --gen_stop_text`` decodes text
    through K1 and K3, the text the saved tokenizer's decode of the
    tokens.  ``train_optimizers`` (after 12): the train phase's
    GPT-406M-width step with adam, lamb, adagrad, rmsprop and adafactor,
    each step's ms and the optimizer update's alone, the slot bytes and
    the peak; gate: adafactor's slots under 1% of adam's on the factored
    matrices.  K1-K3's ``train_models_bert_moe[_ep2|_ep4]`` and
    ``ladder_bert_moe`` paths hold BERT's cases, ``lm_bpe`` the trainer
    CLI's and ``train_optimizers`` the train step's, with their launches.
21. Slice 8d, the data axis inside a worker.  ``train_data`` (beside
    17's processes, holding the busy lock): the train step's global
    batch (B=8, S=1024) at GPT-406M width over local data rows on the
    one card, a copy of the model a row, each arm of ``DATA["arms"]``
    (dp2, dp2 x tp2, dp2 x ring2, dp4 replicated, FSDP over dp4) placed
    by ``ParallelConfig.place_state``: the rows' mean first step within
    TRAIN_* of the unsharded pallas step, ``DATA["steps"]`` steps with
    launches exactly the rows times a row's, the rows bit-equal after
    them (FSDP's replicated leaves), the step ms over 10's, the busy
    share and peak memory; gates: FSDP's gathered parameters within 1e-5
    of dp4's and its peak under dp4's.  Then the async arm: two replicas
    (one a local position) merged every ``DATA["async_period"]`` local
    steps, each replica's first gradient against the pallas step, exact
    launches, the replicas bit-equal after the last merge.
    ``train_data_cli`` (beside 15-16): two gpt_mini workers (gloo, the
    one card) with ``--dcn_data_parallel=2``, ``--sharded_feed=false``
    and ``=true`` side by side; gates: each pair's losses and digests
    bit-equal, the sharded feed's line where it is on and nowhere else,
    the loss falls, exact launches.  The K1/K2/K3 and K6/K7 rows'
    ``train_data_*`` paths hold the ``kernels`` phase's data-row cases.
22. Slice 8e, the mesh across worker processes.  ``train_mesh`` (after
    21, nothing beside it): in process at GPT-406M width and the train
    step's batch, data=2 x pipe=2 (1F1B, a pipelined copy of the model a
    row) and FSDP over data=2 beside model=2; and, beside 15-16's
    processes, two ranks as processes sharing the card over gloo
    (``_MESH_RANK``, each its part of ``parallel/mesh.global_mesh``)
    with pipe=2 across them (1F1B) and with seq=2 and the ring across
    them.  Gates: each arm's first step
    (a rank's part of the gradient summed over the pipe group) within
    TRAIN_* of the unsharded pallas step, the ranks' losses and norms
    identical, the rows bit-equal, every rank's launches exactly its
    schedule's; each arm's step ms, busy share and peak memory.
    ``train_mesh_cli`` (beside 15-16): gpt_mini as two workers on cuda:0
    (gloo) with pipe=2 and then the ring's seq=2 across them; gates: the
    layout and hop lines, bit-equal losses, the loss falls, exact
    launches (K6/K7 from the trainer's ``kernel launches`` line).  The
    K1/K2/K3 and K6/K7 rows' ``train_mesh_*`` paths hold the ``kernels``
    phase's cases of a rank's shapes (K6/K7 at [8, 512, 16, 128] and
    [32, 256, 4, 32] a hop).

With ``--nccl`` the script runs ``env`` and the reference job alone,
with one worker on each visible card (the backend rule of
``cluster/server.py`` then picks NCCL), under the same gates; then
``train_data_nccl`` on four cards: gpt_mini through the CLI with one
worker whose data axis spans the four cards, and with two workers of
two cards each under ``--dcn_data_parallel=2`` over NCCL (gates: the
layout and backend lines, equal losses and digests, exact launches); then
``train_mesh_nccl``: the ranks of 22, a card each over NCCL, with pipe=4,
seq=4 and data=2 x pipe=2, and gpt_mini as four one-card workers at
B=32, S=512 (the same gates).  With
``--fsdp`` it runs ``env``, ``build`` and ``train_fsdp`` alone, under the
same gates: its step, gather and reduce-scatter ms without the CLIs
beside it.

Then the card's name and power limit, the kernels' summary object, and
last ``{"ok": true, "device": {...}}``.  A summary row's numbers and
launches are those of its main path (``main``: the train step for
K1/K2/K3, the int8 train step for K4/K5, the ring train step for K6/K7,
whose numbers are the mean per launch over a step's hops, and the
``kernels`` phase itself for K8, which no path launches); its ``paths``
hold each path's own shape, numbers and launches (K1's and K3's
``generate``: the prefill of B=4 x 384 and the decode step's 4 rows,
with the bf16 ``generate_cached`` arm's launches; their ``checkpoint``:
the serve prefill's case, with the restored engine's launches; their
``fleet``: the serve prefill's case, with the replicas' summed launches;
K1-K3's
``trainer``: the gpt_mini trainer CLI's shapes and launches; K1-K3's
and K6/K7's ``train_parallel_<arm>``: each arm's per-shard shape, K1/K2
[8, 1024, 8, 128] for tp2 and [8, 1024, 4, 128] for the ulysses arms,
K6/K7 the tp2 x ring2 hop mean at [8, 512, 8, 128], with the arm's
launches; K1-K3's ``train_parallel_cli``: K1/K2 at [32, 512, 1, 32] and
K3 at the trainer's rows, with the parallel CLI's launches; K1-K3's
``train_pipeline_<arm>``: a stage's micro-batch, K1/K2 [1, 1024, 16,
128] and K3 1024 x 2048, and ``train_pipeline_cli`` [8, 512, 4, 32] and
4096 x 128, with each arm's launches; K1-K3's ``train_fsdp``: the train
shapes, with rank 0's FSDP launches; K4/K5's ``train_parallel_tp2_int8``:
the column site's shard, with the arm's launches), K4/K5/K8 rows list
their call sites or variants under ``sites``, and K6's ``hop_kinds``
hold its visible and diagonal hops' own times and ratios to SDPA, K7a's
and K7b's every hop kind's, with the pair's ratio to SDPA's backward.
Any failing phase raises: the script exits non-zero and prints no
result.  Without CUDA it exits 2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import glob
import json
import math
import os
import queue
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

# Tolerances, kernel against its plain version on the same inputs.
# K1 output, bf16: both accumulate in fp32, but the kernel feeds the V
# product unnormalised probabilities rounded to bf16 and divides at the
# end, where the plain version rounds normalised weights; outputs of
# magnitude ~1 then differ by a few bf16 ulps (2^-8 each).
K1_OUT_TOL = 2e-2
# K1 logsumexp: fp32 on both sides from the same bf16 inputs; only the
# order of the fp32 sums differs.
K1_LSE_TOL = 1e-3
# K3: fp32 statistics and output on both sides; only summation order
# differs (~1e-6 relative on values of magnitude <= ~5).
K3_TOL = 1e-4
# K2a, K2b (bf16), max abs error over the largest gradient magnitude:
# the kernels round P and dS to bf16 as tensor-core operands and each
# gradient to bf16 once; the plain version computes in fp32 and rounds
# once, so the two land within about one bf16 ulp (2^-8) of the largest
# gradient.
K2_REL_TOL = 1e-2
# Whole model, bf16: prefill logits through both kernels against the
# plain path (dense attention, plain LayerNorm) with the same weights.
# Per-layer differences of a bf16 ulp in the attention output carry
# through 8 residual layers to logits of magnitude ~1.
MODEL_LOGIT_TOL = 0.1
# One train step, kernel path against plain path (same fp32 masters and
# batch, bf16 compute): the attention output differs by a bf16 ulp per
# layer (as for the logits above), which the loss, a mean over ~8000
# next-token terms, averages down; the gradients go through 8 layers of
# bf16 matmuls on both sides, so they agree in direction and norm closely
# but not bit for bit.  (Measured on an H100 at B=8: loss 8.5e-5 apart,
# norms 2.3e-4 relative, cosine 0.999996; the limits leave ~9x room.)
TRAIN_LOSS_TOL = 1e-3          # absolute, on a loss of ~6
TRAIN_GRAD_NORM_RTOL = 2e-3    # relative difference of the global norms
TRAIN_GRAD_MIN_COS = 0.999     # cosine of the flattened gradients
# K4 and K5 against their plain versions (same inputs, bf16): both
# quantize with the same IEEE division and round half to even, add the
# exact int32 K-block products into fp32 in the same order with every
# step rounded, and take tanh from the same tanhf, so the int8 codes are
# the same unless an ulp of tanh or of an FMA moves a value across a
# rounding boundary.  K4: every output within one bf16 ulp of the
# largest magnitude.  K5: max abs error over the largest magnitude at
# most 1e-2 (one flipped code moves one product by ~1/127 of a row's
# range); its g output (elementwise, no quantizer) within one bf16 ulp of
# each element.
K5_REL_TOL = 1e-2
# One int8 train step, kernel path against plain path (plain attention,
# LayerNorm and K4/K5 versions, same fp32 masters and batch): on top of
# the bf16 step's differences (see above), a bf16 ulp of difference in an
# activation can flip one int8 code, which moves a product by ~1/127 of a
# row's range; the loss averages ~8000 next-token terms and the
# gradients 406M entries, so flips stay far inside these limits.
TRAIN_INT8_LOSS_TOL = 1e-2
TRAIN_INT8_GRAD_NORM_RTOL = 2e-2
TRAIN_INT8_GRAD_MIN_COS = 0.99
# tests/test_int8_train.py:366: the int8 loss within 10% (+0.1) of bf16.
INT8_LOSS_RATIO, INT8_LOSS_SLACK = 1.10, 0.1
# K6, K7a and K7b against their plain versions (fp32 math) at the ring
# path's per-hop shape, bf16: the kernels round P (and dS) to bf16 as
# tensor-core operands, as K1/K2 do, so the acc carry and the gradient
# partials land within about one bf16 ulp (2^-8) of their largest
# magnitude (max abs error over the largest magnitude); m and l sum
# unrounded fp32 probabilities and differ only in where the 1/sqrt(D)
# scale is applied (after the product in the kernel, before it in the
# plain version).
K67_REL_TOL = 1e-2
K6_M_ATOL = 1e-4               # on running maxima of magnitude ~3
K6_L_REL_TOL = 1e-4
# The 4-shard ring over K6/K7 against K1/K2 on the whole sequence (same q,
# k, v, dO) is held to K1's output and K2's gradient tolerances: both
# round P and dS to bf16, grouped per hop in the ring.  One ring train
# step, against the plain chunk versions and against the pallas step, is
# held to the TRAIN_* tolerances above, for the reason given there.

# Published H100 SXM peaks (dense): bf16 tensor cores and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

WIDTH = dict(vocab_size=256, hidden_size=2048, num_layers=8, num_heads=16,
             intermediate_size=8192, max_position=1024, dtype="bfloat16",
             attention_backend="pallas", fused_ln=True)
ENGINE = dict(num_slots=8, page_size=16, num_pages=512,
              max_pages_per_seq=64)
PROMPT_LENS = (100, 777, 250, 512, 640, 333, 700, 128)
NEW_TOKENS = 64
# The serve_chunked and serve_spec phases' engine arms.
PREFILL_CHUNK = 128
SPEC_K = 4
SEED = 0
# The generate phase: B prompts of `prompt` tokens; `new` tokens in the
# fp32 gates (`uncached` for the O(S^2) loop), `bf16_new` at full depth;
# a width-4 beam over `beam_new`; spec_k 8; the window gate's window
# (total length above it).
GEN = dict(batch=4, prompt=384, new=64, uncached=16, bf16_new=128,
           beam=4, beam_new=64, spec_k=8, window=256, window_prompt=300,
           window_new=24)
# The flagship train step (bench.py:456-531, :694): B=8, S=1024, Adam 3e-4.
TRAIN = dict(batch=8, seq_len=1024, lr=3e-4, steps=30)
ATTN_INT8_STEPS = 5
# The ring train step's mesh: four sequence shards of 256 on the one card
# (data=1, seq=4).
RING_SEQ = 4
# The train_parallel phase: each arm (name, seq, model, attention) on
# [cuda0] * (seq x model) at GPT-406M width for `steps` steps; then the
# trainer CLI with tp2 x ulysses2 at mini()'s width (B=32, S=512).
# (8 steps an arm and 16 CLI steps, cut from 10 and 30 to make room for
# train_pipeline and train_fsdp; 6 failed `falls`, Adam's first steps
# raising the loss.)  tp2_int8: the int8 MLP (K4/K5 per shard) beside
# tp2.
PARALLEL = dict(steps=8, arms=(("tp2", 1, 2, "pallas", False),
                               ("ulysses4", 4, 1, "ulysses", False),
                               ("tp2_ring2", 2, 2, "ring", False),
                               ("tp2_ulysses2", 2, 2, "ulysses", False),
                               ("tp2_int8", 1, 2, "pallas", True)),
                cli_batch=32, cli_seq=512, cli_steps=16, gen_tokens=16)
# The train_pipeline phase: each arm (name, pipe, virtual stages) of the
# flagship step at GPT-406M width with `micro` micro-batches of the B=8
# batch, its stages on [cuda0] * pipe, for `steps` steps; then the trainer
# CLI with --pipeline_parallel=2 --pipeline_schedule=1f1b at mini()'s
# width (B=32, S=512, `cli_micro` micro-batches).
PIPELINE = dict(steps=5, micro=8, arms=(("gpipe", 4, 1), ("1f1b", 4, 1),
                                        ("interleaved", 2, 2)),
                cli_batch=32, cli_seq=512, cli_micro=4, cli_steps=12,
                gen_tokens=16)
# The train_fsdp phase: two sync workers (gloo ranks) on cuda0 at GPT-406M
# width, B=8 a rank (the train step's shapes), `steps` steps of the FSDP
# state against as many of the replicated state on the same batches.
FSDP = dict(ranks=2, steps=3, timeout_s=300, min_size=65536)
# The trainer phase.  The reference job: examples/launch_local_cluster.sh's
# flags (200 steps, global batch 100, hidden 100, lr 0.01, synthetic MNIST).
# The JAX CLI with the same flags on a CPU (one worker, the same global
# batch) reaches a test accuracy of 1; the port's two workers draw other
# shuffles of the same data, so the tolerance allows two hundredths (100
# of the 10000 test examples).  gpt_mini: mini()'s width (hidden 128, 4
# layers, 4 heads, head_dim 32) at S=512, B=32; generate 32 tokens.
TRAINER = dict(steps=200, batch=100, hidden=100, lr=0.01,
               jax_cpu_test_accuracy=1.0, accuracy_tol=0.02,
               # gpt_mini's 12 steps (a checkpoint every 6) cut from 60
               # (every 20) to make room for the pipeline and FSDP phases,
               # then from 30 for items 7a and 7c's, then from 20 for
               # slice 8d's train_data.
               gpt_batch=32, gpt_seq=512, gpt_steps=12, gpt_save=6,
               gen_tokens=32)


# The config ladder (slice 7b).  train_models: BERT-tiny at
# --bert_seq_len=128 and ViT-tiny (64 patches) with attention_backend=
# "pallas" and fused_ln=True, ResNet-20 and LeNet-5, each at the CLI's
# default --batch_size=100 and its published widths, `steps` steps in
# this process (the transformers' Adam at 1e-3, the CNNs' SGD at
# `cnn_lr`); then the same four through the trainer CLI, `cli_steps`
# global steps each: LeNet-5 async with two workers, ResNet-20 sync with
# two gloo workers on the one card (and --mode=eval), BERT-tiny and
# ViT-tiny (--data_augmentation=true) on the kernels.
MODELS = dict(batch=100, bert_seq=128, vit_patches=64, steps=40,
              cnn_lr=0.1, lenet_lr=0.2, cli_steps=12, async_period=4,
              experts=4, expert_arms=(2, 4), arm_steps=10)
# Items 7a and 7c.  lm_bpe: gpt_mini at the trainer CLI's shape (B=32,
# S=512) on `corpus_mb` MB of this checkout's text files (repeated if
# shorter), streamed past `stream_mb`, BPE to `vocab`,
# adafactor; `steps` global steps, a checkpoint (and cursor) every
# `save`, then as many again from the restored cursor.
# train_optimizers: the train phase's model and batch, `steps` steps an
# optimizer.
LM_BPE = dict(corpus_mb=2, stream_mb=1, vocab=512, batch=32, seq=512,
              steps=8, save=4, lr=0.01, gen_tokens=32,
              prompt="def train", stop="\n\n")
# Each train_data path's K1/K2 case (``check_kernels``): the shape of a
# data row's part of the batch (the ring arm runs K6/K7 instead).
DATA_PATHS = {"dp2": "dp2", "dp2_tp2": "dp2_tp2", "dp4": "dp4",
              "fsdp_dp4": "dp4", "async_r2": "dp2", "cli": "cli"}
# The train_data phase (slice 8d): the train step's global batch (B=8,
# S=1024) over local data rows on the one card at GPT-406M width, each
# arm (name, data, seq, model, attention, fsdp) `steps` steps: data=2;
# data=2 beside tp2 and beside ring2 (seq); data=4 replicated (the
# memory FSDP is held under) and FSDP over the four positions; then the
# async arm, `async_replicas` replicas merged every `async_period` local
# steps.  The CLI: two gpt_mini workers (gloo on the one card) with
# --dcn_data_parallel=2 at B=`cli_batch`, S=`cli_seq`, with
# --sharded_feed=false and =true.
DATA = dict(steps=4, arms=(("dp2", 2, 1, 1, "pallas", False),
                           ("dp2_tp2", 2, 1, 2, "pallas", False),
                           ("dp2_ring2", 2, 2, 1, "ring", False),
                           ("dp4", 4, 1, 1, "pallas", False),
                           ("fsdp_dp4", 4, 1, 1, "pallas", True)),
            fsdp_min_size=65536, async_replicas=2, async_period=2,
            cli_batch=16, cli_seq=512, cli_steps=12)
# The train_mesh phase (slice 8e: the mesh across worker processes).  In
# process at GPT-406M width, the train step's B=8, S=1024, on [cuda0] * 4:
# data=2 x pipe=2 (1F1B, `micro` micro-batches a row) and FSDP over
# data=2 x model=2, `steps` steps each.  Two ranks sharing cuda0 over gloo
# (`_MESH_RANK`, one process a rank), the same width and batch: pipe=2
# across them (1F1B, `rank_micro` micro-batches) and seq=2 with the ring
# across them, `rank_steps` timed steps each.  The trainer CLI at mini()'s
# width (B=`cli_batch`, S=`cli_seq`): two workers on cuda:0 (gloo) with
# pipe=2 across them (1F1B, `cli_micro` micro-batches), then seq=2 with
# the ring across them.  `--nccl` (four cards, a rank each): pipe=4,
# seq=4 and data=2 x pipe=2 at GPT-406M width, then gpt_mini as four
# one-card workers at B=32, S=512.
MESH = dict(steps=4, micro=4, rank_micro=8, rank_steps=3, rank_timeout_s=420,
            fsdp_min_size=65536, cli_batch=32, cli_seq=512, cli_micro=4,
            cli_steps=12,
            rank_arms=(("pipe2", {"pipe": 2}), ("seq2", {"seq": 2})),
            nccl_arms=(("pipe4", {"pipe": 4}), ("seq4", {"seq": 4}),
                       ("dp2_pp2", {"pipe": 2})))
OPTIMIZERS = dict(names=("adam", "lamb", "adagrad", "rmsprop",
                         "adafactor"), steps=3, lr=3e-4)


_EMIT_LOCK = threading.Lock()


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line on stdout, whole (parts run side by side, each
    emitting its own lines: :func:`side_by_side`), with ``t``, the
    script's seconds when it was written."""
    line = json.dumps({"phase": phase, **fields,
                       "t": round(time.perf_counter() - _T0, 1)}) + "\n"
    with _EMIT_LOCK:
        sys.stdout.write(line)
        sys.stdout.flush()


# One in-process profile at a time: a part's busy share profiles this
# process's own step, so no other part may run steps in this process
# meanwhile (the parts that run side by side otherwise only drive their
# own processes, or decode outside any profile).
_BUSY_LOCK = threading.Lock()


def side_by_side(*calls) -> list:
    """Independent parts that drive CLI processes (``(fn, *args)`` each),
    run at once on threads: the card is nearly idle under them and the
    host has cores to spare, so together they take the longest one's
    time, not the sum.  Their results in order; the first failure is
    raised once every part has ended."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(calls)) as pool:
        futures = [pool.submit(fn, *args) for fn, *args in calls]
        return [f.result() for f in futures]


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, min_ms: float = 25.0) -> float:
    """Mean milliseconds per call over back-to-back calls, with enough
    calls (20 to 2000) that the timed window spans ``min_ms``: a short
    window would time the card before its clocks come up."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def window(reps):
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    est = window(5) / 5                      # warm-up and first estimate
    reps = int(min(2000, max(20, min_ms / max(est, 1e-3))))
    return window(reps) / reps


def host_ms(fn, reps: int = 500) -> float:
    """Host milliseconds per call of back-to-back calls (the wrapper's
    Python and launch cost; the card is left to catch up afterwards).
    Where it exceeds the device time, ``cuda_ms`` times the host."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return dt


def warm_up(dev, seconds: float = 1.0) -> None:
    """Bring the card's clocks up before the first timing (the kernels
    phase times K1 at the serving shape first): back-to-back bf16 GEMMs
    for about ``seconds``."""
    import torch
    a = torch.randn(4096, 4096, device=dev).to(torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def bound(bytes_moved: float, flops: float,
          peak_ops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_build_report(kernels, lib) -> list[dict]:
    """ptxas's registers, spills and static shared memory (``-Xptxas
    -v``) of the K1/K2/K6/K7 bf16 kernels, with the dynamic shared memory
    their launchers request."""
    import re
    rows = []
    for kind, entry in (("flash_fwd_wgmma", lib.dtt_flash_attention_fwd_smem),
                        ("flash_bwd_dq_wgmma",
                         lib.dtt_flash_attention_bwd_smem),
                        ("flash_bwd_dkv_wgmma",
                         lib.dtt_flash_attention_bwd_smem),
                        ("chunk_fwd_wgmma",
                         lib.dtt_flash_attention_chunk_smem),
                        ("chunk_dq_wgmma", lambda d: (
                            lib.dtt_flash_attention_chunk_bwd_smem(d, 0))),
                        ("chunk_dkv_wgmma", lambda d: (
                            lib.dtt_flash_attention_chunk_bwd_smem(d, 1)))):
        for r in kernels.ptxas_report(kind):
            d = int(re.search(kind + r"ILi(\d+)E", r["kernel"]).group(1))
            rows.append(dict(kernel=f"{kind}<{d}>", registers=r.get(
                "registers"), spill_stores=r["spill_stores"],
                spill_loads=r["spill_loads"], stack_bytes=r["stack_bytes"],
                smem_static=r["smem_static"], smem_dynamic=entry(d)))
    return rows


def quant_build_report(kernels, lib) -> list[dict]:
    """ptxas's registers and spills of K4/K5's kernel A (quantize_blocks,
    per dtype and K-block) and kernel B (qgemm_wgmma, per dtype, with the
    dynamic shared memory its launcher requests)."""
    import re
    rows = []
    for kind in ("quantize_blocks", "qgemm_wgmma"):
        for r in kernels.ptxas_report(kind):
            # <T, bk> or <T, BN, stages>, as the mangled name gives them.
            m = re.search(kind + r"I(13__nv_bfloat16|f)(.*?)EEEv",
                          r["kernel"])
            targs = ["bf16" if "bfloat" in m.group(1) else "f32"] + \
                re.findall(r"Li(\d+)E", m.group(2) + "E")
            rows.append(dict(
                kernel=f"{kind}<{', '.join(targs)}>",
                registers=r.get("registers"),
                spill_stores=r["spill_stores"], spill_loads=r["spill_loads"],
                stack_bytes=r["stack_bytes"],
                smem_dynamic=(lib.dtt_quant_gemm_smem()
                              if kind == "qgemm_wgmma" else 0)))
    return rows


def check_k1(name, q, k, v, mask, out, lse, *, causal, window):
    """K1's output and logsumexp against the plain version on the same
    inputs; returns (max_abs_err of the output, of the live lse rows)."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    ref, ref_lse = fa.flash_attention_reference(q, k, v, mask, causal=causal,
                                                window=window)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    live = ref_lse > -1e29
    lse_err = (lse - ref_lse)[live].abs().max().item()
    if not (torch.isfinite(out).all() and err <= K1_OUT_TOL
            and lse_err <= K1_LSE_TOL
            and bool(((lse > -1e29) == live).all())):
        raise AssertionError(f"K1 {name}: max_abs_err {err} (tol "
                             f"{K1_OUT_TOL}), lse err {lse_err} (tol "
                             f"{K1_LSE_TOL})")
    if name == "masked_rows" and out[0, :10].abs().max().item() != 0:
        raise AssertionError("K1: fully masked rows must be 0")
    return err, lse_err


def k1_timings(q, k, v, mask, valid, *, causal, window) -> dict:
    """K1's time, the plain version's, SDPA's and the bound, on [B, S, H,
    D] bf16 inputs whose query/key pairs ``valid`` allows."""
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    B, S, H, D = q.shape
    pairs = valid.sum().item() * H
    bytes_moved = 4 * B * S * H * D * 2 + B * H * S * 4 + (
        0 if mask is None else B * S * 4)
    b_ms, b_by = bound(bytes_moved, 4 * D * pairs)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if mask is None and not window:
        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)
    else:
        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=valid)
    kw = dict(causal=causal, window=window)

    def kernel():
        return fa.flash_attention(q, k, v, mask, **kw)
    ms, library_ms = cuda_ms(kernel), cuda_ms(lib)
    return dict(ms=ms, plain_ms=cuda_ms(lambda: fa.flash_attention_reference(
                    q, k, v, mask, **kw)),
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                ratio_to_library=ms / library_ms,
                tflops=4 * D * pairs / (ms * 1e-3) / 1e12,
                host_ms=host_ms(kernel), library_host_ms=host_ms(lib))


def check_k3(name, x, scale, bias) -> dict:
    """K3 against the plain version on [rows, H] ``x``, with its times."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import layer_norm as ln
    from distributed_tensorflow_tpu_torch.utils.cuda_timing import graph_ms
    rows, Hd = x.shape
    out = ln.layer_norm(x, scale, bias)
    ref = ln.layer_norm_reference(x, scale, bias)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not (out.dtype == torch.float32 and err <= K3_TOL):
        raise AssertionError(f"K3 {name}: max_abs_err {err} (tol "
                             f"{K3_TOL}), dtype {out.dtype}")
    # Weights in x's dtype: F.layer_norm's one-call form writes x's dtype
    # (for bf16 rows 2 bytes an element where K3 writes 4: the yardstick
    # moves fewer bytes).
    s16, b16 = scale.to(x.dtype), bias.to(x.dtype)
    b_ms, b_by = bound(rows * Hd * (x.element_size() + 4) + 2 * Hd * 4,
                       8 * rows * Hd)

    def kernel():
        return ln.layer_norm(x, scale, bias)

    def lib():
        return F.layer_norm(x, (Hd,), s16, b16, 1e-6)
    ms, library_ms = cuda_ms(kernel), cuda_ms(lib)
    return dict(
        case=name, rows=rows, H=Hd, max_abs_err=err, tol=K3_TOL, ms=ms,
        plain_ms=cuda_ms(lambda: ln.layer_norm_reference(x, scale, bias)),
        library_ms=library_ms, ratio_to_library=ms / library_ms,
        library=f"F.layer_norm, {str(x.dtype)[6:]} weights and out",
        dtype=str(x.dtype)[6:], bound_ms=b_ms,
        bound_by=b_by, host_ms=host_ms(kernel), library_host_ms=host_ms(lib),
        device_ms=graph_ms(kernel), library_device_ms=graph_ms(lib))


def check_kernels(dev):
    """Phase 3: each kernel against its plain version at the paths'
    shapes; returns the summary rows (launches filled in later)."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.flash_attention import (
        attention_valid)

    g = torch.Generator(device=dev).manual_seed(SEED)
    H, D = WIDTH["num_heads"], WIDTH["hidden_size"] // WIDTH["num_heads"]
    S = 784                       # the longest prompt's prefill bucket
    warm_up(dev)

    def qkv(B, d=D, s=S):
        # Views into one fused [B, S, 3, H, D] projection, as on the path.
        t = torch.randn(B, s, 3, H, d, generator=g, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
        return t[:, :, 0], t[:, :, 1], t[:, :, 2]

    masked_tail = torch.ones(2, S, dtype=torch.int32, device=dev)
    masked_tail[1, S - 300:] = 0
    masked_head = torch.ones(1, S, dtype=torch.int32, device=dev)
    masked_head[0, :10] = 0        # causal rows 0..9 see no valid key
    # (name, B, kv_mask, window, head_dim, S); head_dim 32 is the JAX
    # GptConfig's default width (hidden 128, 4 heads); the generate
    # phase's prefill is B=4 prompts of 384 tokens.
    cases = [("causal", 1, None, 0, D, S),
             ("kv_mask", 2, masked_tail, 0, D, S),
             ("window", 1, None, 256, D, S),
             ("masked_rows", 1, masked_head, 0, D, S),
             ("head_dim_32", 1, None, 0, 32, S),
             ("generate_prefill", GEN["batch"], None, 0, D, GEN["prompt"])]
    k1_cases = []
    for name, B, mask, window, d, s in cases:
        q, k, v = qkv(B, d, s)
        out, lse = fa.flash_attention(q, k, v, mask, causal=True,
                                      window=window)
        err, lse_err = check_k1(name, q, k, v, mask, out, lse, causal=True,
                                window=window)
        valid = attention_valid(B, s, mask, causal=True, window=window,
                                device=dev)
        k1_cases.append(dict(
            case=name, B=B, S=s, H=H, D=d, window=window, max_abs_err=err,
            tol=K1_OUT_TOL, lse_err=lse_err, lse_tol=K1_LSE_TOL,
            **k1_timings(q, k, v, mask, valid, causal=True, window=window)))

    k3_cases = []
    Hd = WIDTH["hidden_size"]
    # The serving path's prefill and decode rows, and the train step's
    # B*S rows of the bf16 residual stream.
    # The chunked prefill's dispatch (every slot's chunk) and the
    # speculative verify (every slot's spec_k tokens) too, and the generate
    # phase's decode step (its B rows).
    # The trainer CLI's gpt_mini: B*S rows of its 128-wide stream.
    mini = dict(hidden=128, heads=4, head_dim=32)
    for name, rows, h in (
            ("prefill", S, Hd), ("decode", ENGINE["num_slots"], Hd),
            ("train", TRAIN["batch"] * TRAIN["seq_len"], Hd),
            ("chunk_prefill", ENGINE["num_slots"] * PREFILL_CHUNK, Hd),
            ("verify", ENGINE["num_slots"] * SPEC_K, Hd),
            ("generate_decode", GEN["batch"], Hd),
            ("trainer", TRAINER["gpt_batch"] * TRAINER["gpt_seq"],
             mini["hidden"]),
            # A pipeline stage's rows: one micro-batch of the train step,
            # and of the pipeline CLI's gpt_mini.
            ("pipeline_micro", TRAIN["seq_len"] * TRAIN["batch"]
             // PIPELINE["micro"], Hd),
            ("pipeline_cli_micro", PIPELINE["cli_seq"] * PIPELINE[
                "cli_batch"] // PIPELINE["cli_micro"], mini["hidden"])):
        x = torch.randn(rows, h, generator=g, device=dev).to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn(h, generator=g, device=dev)
        bias = 0.1 * torch.randn(h, generator=g, device=dev)
        k3_cases.append(check_k3(name, x, scale, bias))
    k2 = check_backward_kernels(dev, g, H, D)
    k2t = check_backward_kernels(
        dev, g, mini["heads"], mini["head_dim"], S=TRAINER["gpt_seq"],
        cases=[("trainer", TRAINER["gpt_batch"], None, True, 0,
                mini["head_dim"])])
    # The train_parallel arms' per-shard shapes: tp2's 8 heads a model
    # column, ulysses' 4 heads a seq device (ulysses4, and tp2 x ulysses2's
    # 8 heads a column over 2 seq devices).
    k2p = {arm: check_backward_kernels(
        dev, g, h, D, cases=[(arm, TRAIN["batch"], None, True, 0, D)])
        for arm, h in (("tp2", H // 2), ("ulysses", H // 4))}
    # The parallel CLI's gpt_mini at tp2 x ulysses2: its 4 heads, 2 a model
    # column, give each seq device 1 head of the whole sequence.
    k2p["cli"] = check_backward_kernels(
        dev, g, mini["heads"] // 4, mini["head_dim"], S=PARALLEL["cli_seq"],
        cases=[("train_parallel_cli", PARALLEL["cli_batch"], None, True, 0,
                mini["head_dim"])])
    # The train_pipeline arms' stages: one micro-batch of the train step.
    k2pp = check_backward_kernels(
        dev, g, H, D, cases=[("train_pipeline", TRAIN["batch"]
                              // PIPELINE["micro"], None, True, 0, D)])
    k2pc = check_backward_kernels(
        dev, g, mini["heads"], mini["head_dim"], S=PIPELINE["cli_seq"],
        cases=[("train_pipeline_cli", PIPELINE["cli_batch"]
                // PIPELINE["cli_micro"], None, True, 0, mini["head_dim"])])
    # The config ladder (slice 7b): BERT-tiny's attention (B=100, S=128,
    # 2 heads of 64, non-causal) under a ragged key-padding mask (per-row
    # valid lengths from the seed, the first row half padded: the
    # synthetic batches' all-ones mask would hide a mask fault) and
    # ViT-tiny's (B=100, 64 patches, 4 heads of 32, no mask: the sequence
    # is shorter than one 128-row tile); K3 on BERT's fp32 rows (ln_emb,
    # mlm_ln and the fp32 residual sums) and bf16 rows (layer 0's
    # ln_attn) and on ViT's bf16 rows, all 128 wide.
    M = MODELS
    Bm, Sb, Sv = M["batch"], M["bert_seq"], M["vit_patches"]
    lengths = torch.randint(Sb // 4, Sb + 1, (Bm,), generator=g, device=dev)
    lengths[0] = Sb // 2
    ragged = (torch.arange(Sb, device=dev)[None, :]
              < lengths[:, None]).to(torch.int32)
    k2bert = check_backward_kernels(dev, g, 2, 64, S=Sb, cases=[
        ("bert_ragged_kv_mask", Bm, ragged, False, 0, 64)])
    k2vit = check_backward_kernels(dev, g, 4, 32, S=Sv, cases=[
        ("vit", Bm, None, False, 0, 32)])
    for name, rows, dtype in (("bert_fp32", Bm * Sb, torch.float32),
                              ("bert_bf16", Bm * Sb, torch.bfloat16),
                              ("vit_bf16", Bm * Sv, torch.bfloat16)):
        x = torch.randn(rows, 128, generator=g, device=dev).to(dtype)
        scale = 1 + 0.1 * torch.randn(128, generator=g, device=dev)
        bias = 0.1 * torch.randn(128, generator=g, device=dev)
        k3_cases.append(check_k3(name, x, scale, bias))
    # The train_data arms (slice 8d): a data row's part of the train
    # step's batch, 4 rows at data=2 (dp2, beside tp2 its 8 heads a
    # model column; beside ring2 a 2-shard ring over [4, 512, 16, 128]
    # hops) and 2 at data=4; the data CLI's gpt_mini, a worker's half of
    # its batch.  K3 at a row's residual rows.
    Bt, St = TRAIN["batch"], TRAIN["seq_len"]
    k2d = {arm: check_backward_kernels(
        dev, g, h, D, cases=[(f"train_data_{arm}", b, None, True, 0, D)])
        for arm, h, b in (("dp2", H, Bt // 2), ("dp2_tp2", H // 2, Bt // 2),
                          ("dp4", H, Bt // 4))}
    k2d["cli"] = check_backward_kernels(
        dev, g, mini["heads"], mini["head_dim"], S=DATA["cli_seq"],
        cases=[("train_data_cli", DATA["cli_batch"] // 2, None, True, 0,
                mini["head_dim"])])
    k3d = {}
    for name, rows, h in (("data_row_dp2", Bt // 2 * St, Hd),
                          ("data_row_dp4", Bt // 4 * St, Hd),
                          ("data_cli", DATA["cli_batch"] // 2
                           * DATA["cli_seq"], mini["hidden"])):
        x = torch.randn(rows, h, generator=g, device=dev).to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn(h, generator=g, device=dev)
        bias = 0.1 * torch.randn(h, generator=g, device=dev)
        k3d[name] = check_k3(name, x, scale, bias)
        k3_cases.append(k3d[name])
    k45 = check_int8_kernels(dev, g)
    k67 = check_ring_kernels(dev, g)
    k67p = check_parallel_ring_kernels(dev, g)
    k67d = check_parallel_ring_kernels(dev, g, B=Bt // 2, H=H,
                                       label="train_data_dp2_ring2")
    # The train_mesh arms (slice 8e): the ring over two ranks, each rank's
    # sequence block a hop at the train step's batch ([8, 512, 16, 128])
    # and at the mesh CLI's gpt_mini ([32, 256, 4, 32]); K3 on that CLI
    # rank's rows (32 x 256 of hidden 128).
    k67m = check_parallel_ring_kernels(dev, g, B=Bt, H=H,
                                       label="train_mesh_ranks_seq2")
    k67mc = check_parallel_ring_kernels(
        dev, g, B=MESH["cli_batch"], H=mini["heads"],
        label="train_mesh_cli_seq2", S=MESH["cli_seq"], D=mini["head_dim"])
    x = torch.randn(MESH["cli_batch"] * MESH["cli_seq"] // 2, mini["hidden"],
                    generator=g, device=dev).to(torch.bfloat16)
    k3d["mesh_cli_seq2"] = check_k3(
        "mesh_cli_seq2", x, 1 + 0.1 * torch.randn(
            mini["hidden"], generator=g, device=dev),
        0.1 * torch.randn(mini["hidden"], generator=g, device=dev))
    k3_cases.append(k3d["mesh_cli_seq2"])
    del x
    k1_all = k1_cases + [k2["fwd"], k2t["fwd"], k2pp["fwd"],
                         k2pc["fwd"]] + [r["fwd"] for r in k2p.values()] + [
        k2bert["fwd"], k2vit["fwd"]] + [r["fwd"] for r in k2d.values()]
    k2_dq = (k2["dq"] + k2t["dq"] + k2pp["dq"] + k2pc["dq"]
             + [r["dq"][0] for r in k2p.values()] + k2bert["dq"]
             + k2vit["dq"] + [r["dq"][0] for r in k2d.values()])
    k2_dkv = (k2["dkv"] + k2t["dkv"] + k2pp["dkv"] + k2pc["dkv"]
              + [r["dkv"][0] for r in k2p.values()] + k2bert["dkv"]
              + k2vit["dkv"] + [r["dkv"][0] for r in k2d.values()])
    emit("kernels", flash_attention_fwd=k1_all,
         layer_norm_fwd=k3_cases, flash_attention_bwd_dq=k2_dq,
         flash_attention_bwd_dkv=k2_dkv,
         quant_matmul=k45["k4"] + k45["tp"]["k4"],
         quant_matmul_nt=k45["k5"] + k45["tp"]["k5"],
         flash_attention_chunk=(k67["k6"] + k67p["k6"] + k67d["k6"]
                                + k67m["k6"] + k67mc["k6"]),
         flash_attention_chunk_dq=(k67["k7a"] + k67p["k7a"] + k67d["k7a"]
                                   + k67m["k7a"] + k67mc["k7a"]),
         flash_attention_chunk_dkv=(k67["k7b"] + k67p["k7b"] + k67d["k7b"]
                                    + k67m["k7b"] + k67mc["k7b"]),
         ring_vs_flash=k67["ring_vs_flash"],
         quant_matmul_dgelu=k45["k8"])

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # K1, K2, K3 and K6 also carry their time over the library call's, K1
    # and K2 the useful TFLOP/s they reach (the valid pairs the bound
    # counts), K1 and K3 their host time per call.
    extra = ("ratio_to_library", "tflops", "pair_ms",
             "pair_ratio_to_library", "host_ms", "library_host_ms",
             "device_ms", "library_device_ms", "out_of_place_ms")
    # K4/K5's two kernels (A, the quantize pass; B, the GEMM) and K4's
    # weight transpose, per call site.
    stage_keys = ("a_ms", "a_bound_ms", "a_bound_by", "b_ms", "b_bound_ms",
                  "b_bound_by", "b_tops", "b_ratio_to_library",
                  "transpose_ms", "transpose_plain_ms", "stages_bit_equal",
                  "bit_equal")

    def summary(name, file, replaces, main, by_path, cases, sites=()):
        """One row per kernel.  Its numbers are those of its main path's
        case, the path whose launches it reports; ``paths`` holds each
        path's own case (launches filled in after the paths ran) and
        ``sites`` a path's other call sites."""
        row = dict(
            name=name, route="cuda",
            source=f"distributed_tensorflow_tpu_torch/csrc/{file}",
            replaces=f"distributed_tensorflow_tpu/ops/pallas/{replaces}",
            main=main, launches=0,
            max_abs_err=max(c["max_abs_err"] for c in cases),
            **{k: by_path[main][k] for k in keys},
            **{k: by_path[main][k] for k in extra if k in by_path[main]},
            paths={path: dict(case=c["case"], launches=0,
                              max_abs_err=c["max_abs_err"],
                              **{k: c[k] for k in keys},
                              **{k: c[k] for k in extra if k in c})
                   for path, c in by_path.items()})
        if sites:
            row["library_bf16_ms"] = by_path[main]["library_bf16_ms"]
            row["sites"] = [dict(case=c["case"], variant=c["variant"],
                                 M=c["M"], K=c["K"], N=c["N"],
                                 max_abs_err=c["max_abs_err"],
                                 library_bf16_ms=c["library_bf16_ms"],
                                 **{k: c[k] for k in keys},
                                 **{k: c[k] for k in stage_keys if k in c})
                            for c in sites]
            # K4/K5: kernel A's and kernel B's own numbers at the main site.
            row.update({k: by_path[main][k] for k in stage_keys
                        if k in by_path[main]})
        return row
    k4, k5, k8 = k45["k4"], k45["k5"], k45["k8"]
    # K6's hop mean counts the future hops, a bare launch in place against
    # SDPA's full masked attention: its visible and diagonal hops carry
    # their own time over SDPA's.
    k6 = summary("flash_attention_chunk", "flash_attention_chunk.cu",
                 "flash_attention.py:624", "train_ring",
                 {"train_ring": k67["k6"][0],
                  "train_parallel_tp2_ring2": k67p["k6"][0],
                  "train_data_dp2_ring2": k67d["k6"][0],
                  "train_mesh_ranks_seq2": k67m["k6"][0],
                  "train_mesh_cli_seq2": k67mc["k6"][0]},
                 k67["k6"] + k67p["k6"] + k67d["k6"] + k67m["k6"]
                 + k67mc["k6"])
    k6["hop_kinds"] = {c["case"]: {k: c[k] for k in (
        "ms", "device_ms", "library_ms", "ratio_to_library")}
        for c in k67["k6"] if c["case"] in ("visible", "diagonal")}
    # K7a and K7b: each hop kind's own times, in place and out of place,
    # and the pair's over SDPA's backward.
    k7 = {}
    for key, name, line in (("k7a", "flash_attention_chunk_dq", 767),
                            ("k7b", "flash_attention_chunk_dkv", 796)):
        k7[key] = summary(name, "flash_attention_chunk.cu",
                          f"flash_attention.py:{line}", "train_ring",
                          {"train_ring": k67[key][0],
                           "train_parallel_tp2_ring2": k67p[key][0],
                           "train_data_dp2_ring2": k67d[key][0],
                           "train_mesh_ranks_seq2": k67m[key][0],
                           "train_mesh_cli_seq2": k67mc[key][0]},
                          k67[key] + k67p[key] + k67d[key] + k67m[key]
                          + k67mc[key])
        k7[key]["hop_kinds"] = {c["case"]: {k: c[k] for k in (
            "ms", "device_ms", "out_of_place_ms", "library_ms",
            "pair_ratio_to_library")}
            for c in k67[key] if c["case"] in ("visible", "diagonal",
                                               "future")}
    # The train_parallel arms' paths, each with the per-shard case of its
    # kernels' shape; the CLI's K3 rows are the trainer's (16384 x 128).
    flash_arms = {"train_parallel_tp2": "tp2",
                  "train_parallel_ulysses4": "ulysses",
                  "train_parallel_tp2_ulysses2": "ulysses",
                  "train_parallel_cli": "cli"}

    def arms(kind):
        return {path: k2p[arm][kind] if kind == "fwd" else k2p[arm][kind][0]
                for path, arm in flash_arms.items()}
    k3_arms = {path: k3_cases[2] for path in (
        *flash_arms, "train_parallel_tp2_ring2", "train_parallel_tp2_int8",
        "train_fsdp")}
    k3_arms["train_parallel_cli"] = k3_cases[6]
    # The pipeline's stages run K1/K2/K3 a micro-batch (its CLI: gpt_mini's
    # micro-batch of 8 rows of 512).
    pipe_paths = ("train_pipeline_gpipe", "train_pipeline_1f1b",
                  "train_pipeline_interleaved")
    k3_arms.update({p: k3_cases[7] for p in pipe_paths})
    k3_arms["train_pipeline_cli"] = k3_cases[8]

    def pipeline(kind):
        row = k2pp[kind] if kind == "fwd" else k2pp[kind][0]
        out = {p: row for p in pipe_paths}
        out["train_pipeline_cli"] = (k2pc[kind] if kind == "fwd"
                                     else k2pc[kind][0])
        return out

    # tp2_int8 runs the tp2 arm's attention shapes; the FSDP ranks the
    # train step's; the train_data arms a data row's (the async replicas
    # a dp2 row's).
    def parallel_more(kind):
        row = k2p["tp2"][kind] if kind == "fwd" else k2p["tp2"][kind][0]
        train_row = k2[kind] if kind == "fwd" else k2[kind][0]
        data = {f"train_data_{arm}": (
            k2d[case][kind] if kind == "fwd" else k2d[case][kind][0])
            for arm, case in DATA_PATHS.items()}
        # train_mesh: the pipelines run a 1-row micro-batch of the train
        # step (train_pipeline's shape), FSDP beside tp2 a dp2 x tp2 row's,
        # the mesh CLI's pipe an 8-row micro-batch of gpt_mini
        # (train_pipeline_cli's).
        mesh = {"train_mesh_dp2_pp2": pipeline(kind)["train_pipeline_1f1b"],
                "train_mesh_ranks_pipe2":
                    pipeline(kind)["train_pipeline_1f1b"],
                "train_mesh_fsdp_dp2_tp2": data["train_data_dp2_tp2"],
                "train_mesh_cli_pipe2": pipeline(kind)["train_pipeline_cli"]}
        return {"train_parallel_tp2_int8": row, "train_fsdp": train_row,
                **ladder(kind), **data, **mesh}

    # The config ladder: BERT-tiny's and ViT-tiny's shapes, in process
    # (train_models) and through the trainer CLI (ladder).
    # BERT-MoE (items 7a, 7c) runs BERT's attention and LayerNorms, in
    # process unsharded and over its expert arms, and through the CLI;
    # lm_bpe the trainer CLI's shapes, train_optimizers the train step's.
    moe_paths = ("train_models_bert_moe", "ladder_bert_moe", *(
        f"train_models_bert_moe_ep{ep}" for ep in MODELS["expert_arms"]))

    def ladder(kind):
        out = {}
        for model, rows in (("bert", k2bert), ("vit", k2vit)):
            row = rows[kind] if kind == "fwd" else rows[kind][0]
            out[f"train_models_{model}"] = out[f"ladder_{model}"] = row
        out.update({p: out["train_models_bert"] for p in moe_paths})
        out["lm_bpe"] = k2t[kind] if kind == "fwd" else k2t[kind][0]
        out["train_optimizers"] = k2[kind] if kind == "fwd" else k2[kind][0]
        return out
    for model, case in (("bert", k3_cases[9]), ("vit", k3_cases[11])):
        k3_arms[f"train_models_{model}"] = k3_arms[f"ladder_{model}"] = case
    k3_arms.update({p: k3_cases[9] for p in moe_paths})
    k3_arms["lm_bpe"] = k3_cases[6]
    k3_arms["train_optimizers"] = k3_cases[2]
    k3_arms.update({f"train_data_{arm}": k3d[{
        "dp2": "data_row_dp2", "dp2_tp2": "data_row_dp2",
        "dp4": "data_row_dp4", "cli": "data_cli"}[case]]
        for arm, case in DATA_PATHS.items()})
    k3_arms["train_data_dp2_ring2"] = k3d["data_row_dp2"]
    k3_arms.update({"train_mesh_dp2_pp2": k3_cases[7],
                    "train_mesh_ranks_pipe2": k3_cases[7],
                    "train_mesh_fsdp_dp2_tp2": k3d["data_row_dp2"],
                    "train_mesh_ranks_seq2": k3d["data_row_dp2"],
                    "train_mesh_cli_pipe2": k3_cases[8],
                    "train_mesh_cli_seq2": k3d["mesh_cli_seq2"]})
    return [
        summary("flash_attention_fwd", "flash_attention.cu",
                "flash_attention.py:119", "train",
                {"serve": k1_cases[0], "train": k2["fwd"],
                 "generate": k1_cases[5], "checkpoint": k1_cases[0],
                 "fleet": k1_cases[0], "trainer": k2t["fwd"],
                 **arms("fwd"), **pipeline("fwd"),
                 **parallel_more("fwd")},
                k1_all),
        # Serving launches K3 at its prefill and its decode rows: both
        # rows carry the serving run's launches (one counter).
        summary("layer_norm_fwd", "layer_norm.cu", "layer_norm.py:38",
                "train", {"serve": k3_cases[0], "serve_decode": k3_cases[1],
                          "train": k3_cases[2], "train_ring": k3_cases[2],
                          "serve_chunked": k3_cases[3],
                          "serve_spec": k3_cases[4],
                          "generate": k3_cases[5],
                          "checkpoint": k3_cases[0],
                          "fleet": k3_cases[0],
                          "trainer": k3_cases[6], **k3_arms},
                k3_cases),
        summary("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
                "flash_attention.py:425", "train",
                {"train": k2["dkv"][0], "trainer": k2t["dkv"][0],
                 **arms("dkv"), **pipeline("dkv"), **parallel_more("dkv")},
                k2_dkv),
        summary("flash_attention_bwd_dq", "flash_attention_bwd.cu",
                "flash_attention.py:465", "train",
                {"train": k2["dq"][0], "trainer": k2t["dq"][0],
                 **arms("dq"), **pipeline("dq"), **parallel_more("dq")},
                k2_dq),
        # Each runs at two call sites per layer of the int8 step: the
        # row's numbers are the mlp_in site's (K4 its forward, K5 its
        # dgrad with g), ``sites`` has both.
        # tp2_int8: each shard's K4/K5 at the column site (mlp_in's N / 2,
        # the mlp_out dgrad's N / 2) and the split-K site (mlp_out's K / 2
        # writing fp32 partials, the mlp_in dgrad's K / 2); its path row
        # is the column site's.
        summary("quant_matmul", "quant_gemm.cu", "quant_matmul.py:93",
                "train_int8", {"train_int8": k4[0],
                               "train_parallel_tp2_int8": k45["tp"]["k4"][0]},
                k4 + k45["tp"]["k4"],
                sites=k4[:2] + k45["tp"]["k4"]),
        summary("quant_matmul_nt", "quant_gemm.cu", "quant_matmul.py:185",
                "train_int8", {"train_int8": k5[1],
                               "train_parallel_tp2_int8": k45["tp"]["k5"][0]},
                k5 + k45["tp"]["k5"],
                sites=k5[:2] + k45["tp"]["k5"]),
        # The ring's per-hop kernels: the row's numbers are the mean per
        # launch over one train step's hops (visible, diagonal, future).
        k6, k7["k7a"], k7["k7b"],
        # On no path of the port (nor of the JAX package): its main is this
        # phase, and its launches are this phase's.
        summary("quant_matmul_dgelu", "quant_gemm.cu",
                "quant_matmul.py:146", "kernels", {"kernels": k8[0]}, k8,
                sites=k8),
    ]


def check_backward_kernels(dev, g, H, D, S=None, cases=None):
    """K2b (dq, with delta) and K2a (dk, dv) against the plain backward at
    the train step's shape (S=1024, H=16, D=128, bf16; B=8 for the causal
    case the step runs, B=2 for the others), on the forward kernel's own
    output and logsumexp, which are first held against the plain forward
    (K1 at the train shape; its times in the first case are the ``fwd``
    row).  ``S`` and ``cases`` give another path's shape (the trainer
    CLI's gpt_mini).  The library time is ``torch.autograd.grad`` through
    ``F.scaled_dot_product_attention``, which computes dq, dk and dv in one
    call: the same number stands in both rows."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.flash_attention import (
        attention_valid)

    S = S or TRAIN["seq_len"]
    tail = torch.ones(2, S, dtype=torch.int32, device=dev)
    tail[1, S - 300:] = 0
    head = torch.ones(2, S, dtype=torch.int32, device=dev)
    head[0, :10] = 0               # causal rows 0..9 see no valid key
    # (name, B, kv_mask, causal, window, head_dim)
    cases = cases or [("causal", TRAIN["batch"], None, True, 0, D),
                      ("kv_mask", 2, tail, True, 0, D),
                      ("window", 2, None, True, 256, D),
                      ("masked_rows", 2, head, True, 0, D),
                      ("non_causal", 2, tail, False, 0, D),
                      ("head_dim_64", 2, None, True, 0, 64),
                      ("head_dim_32", 2, None, True, 0, 32)]
    rows = {"dq": [], "dkv": [], "fwd": None}
    for name, B, mask, causal, window, d in cases:
        t = torch.randn(B, S, 3, H, d, generator=g, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
        q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]
        with torch.no_grad():
            out, lse = fa.flash_attention(q, k, v, mask, causal=causal,
                                          window=window)
        fwd_err, fwd_lse_err = check_k1(name, q, k, v, mask, out, lse,
                                        causal=causal, window=window)
        dout = torch.randn(B, S, H, d, generator=g, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)
        kw = dict(causal=causal, window=window)

        def run_dq():
            return fa.flash_attention_backward_dq(q, k, v, mask, out, lse,
                                                  dout, **kw)
        dq, delta = run_dq()

        def run_dkv():
            return fa.flash_attention_backward_dkv(q, k, v, mask, lse,
                                                   delta, dout, **kw)
        dk, dv = run_dkv()

        def plain():
            return fa.flash_attention_backward_reference(
                q, k, v, mask, out, lse, dout, **kw)
        ref = plain()
        torch.cuda.synchronize()
        errs = {}
        for gname, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            abs_err = (got.float() - want.float()).abs().max().item()
            rel = abs_err / max(want.float().abs().max().item(), 1e-6)
            if not (torch.isfinite(got).all() and rel <= K2_REL_TOL):
                raise AssertionError(f"K2 {name} {gname}: max_abs_err "
                                     f"{abs_err}, relative {rel} (tol "
                                     f"{K2_REL_TOL})")
            errs[gname] = (abs_err, rel)
        if name == "masked_rows" and dq[0, :10].abs().max().item() != 0:
            raise AssertionError("K2: dq of fully masked rows must be 0")

        valid = attention_valid(B, S, mask, causal=causal, window=window,
                                device=dev)
        if rows["fwd"] is None:
            rows["fwd"] = dict(
                case="train" if name == "causal" else name, B=B, S=S, H=H,
                D=d, window=window,
                max_abs_err=fwd_err, tol=K1_OUT_TOL, lse_err=fwd_lse_err,
                lse_tol=K1_LSE_TOL, **k1_timings(q, k, v, mask, valid,
                                                 causal=causal,
                                                 window=window))
        pairs = valid.sum().item() * H
        one = B * S * H * d * 2                  # one bf16 [B, S, H, D]
        stats = B * H * S * 4                    # lse or delta, fp32
        extra = 0 if mask is None else B * S * 4
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        if mask is None and not window:
            lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=causal)
        else:
            lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     attn_mask=valid)
        lib_dout = dout.transpose(1, 2)

        def lib():
            return torch.autograd.grad(lib_out, (qt, kt, vt), lib_dout,
                                       retain_graph=True)
        plain_ms, lib_ms = cuda_ms(plain), cuda_ms(lib)
        base = dict(case=name, B=B, S=S, H=H, D=d, causal=causal,
                    window=window, tol_rel=K2_REL_TOL, plain_ms=plain_ms,
                    library_ms=lib_ms)
        # dq: reads q, k, v, o, dO and lse, writes dq and delta; S, dP, dQ.
        # dkv: reads q, k, v, dO, lse and delta, writes dk and dv; S, dP,
        # dV, dK.  Each row's ratio is its own time over the library's
        # (which computes all three gradients); the pair's is their sum's.
        dq_ms, dkv_ms = cuda_ms(run_dq), cuda_ms(run_dkv)
        pair = dict(pair_ms=dq_ms + dkv_ms,
                    pair_ratio_to_library=(dq_ms + dkv_ms) / lib_ms)
        b_ms, b_by = bound(6 * one + 2 * stats + extra, 3 * 2 * pairs * d)
        rows["dq"].append(dict(base, max_abs_err=errs["dq"][0],
                               rel_err=errs["dq"][1], ms=dq_ms,
                               bound_ms=b_ms, bound_by=b_by,
                               ratio_to_library=dq_ms / lib_ms,
                               tflops=3 * 2 * pairs * d / (dq_ms * 1e-3)
                               / 1e12, **pair))
        b_ms, b_by = bound(6 * one + 2 * stats + extra, 4 * 2 * pairs * d)
        rows["dkv"].append(dict(
            base, max_abs_err=max(errs["dk"][0], errs["dv"][0]),
            rel_err=max(errs["dk"][1], errs["dv"][1]), ms=dkv_ms,
            bound_ms=b_ms, bound_by=b_by, ratio_to_library=dkv_ms / lib_ms,
            tflops=4 * 2 * pairs * d / (dkv_ms * 1e-3) / 1e12, **pair))
        del t, ref, lib_out, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def ring_chunk_case(dev, g, fused, name, q_off, k_off, *, causal=True,
                    window=0, masked=False, shards=RING_SEQ) -> dict:
    """K6, K7a and K7b on one (query shard, key chunk) pair of the ring
    path against their plain versions: q the shard of ``fused`` [B, S, 3,
    H, D] at ``q_off``, k and v the chunk at ``k_off`` (views, as the ring
    hands them over), an fp32 carry in flight.  Returns the three rows
    with times, the library yardsticks and the bounds."""
    import torch
    import torch.nn.functional as F
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.utils.cuda_timing import graph_ms
    B, S, _, H, D = fused.shape
    n = S // shards
    q = fused[:, q_off:q_off + n, 0]
    k, v = fused[:, k_off:k_off + n, 1], fused[:, k_off:k_off + n, 2]
    mask = None
    m = torch.randn(B, H, n, generator=g, device=dev)
    l = 1 + torch.rand(B, H, n, generator=g, device=dev)
    acc = torch.randn(B, H, n, D, generator=g, device=dev)
    # Keys 0..9 of batch 0 masked: on the causal diagonal its rows 0..9
    # then see no key; their carries say that none was seen before.
    dead = masked and causal and q_off == k_off
    if masked:
        mask = torch.ones(B, n, dtype=torch.int32, device=dev)
        mask[0, :10] = 0
        m[0, :, :10], l[0, :, :10], acc[0, :, :10] = -1e30, 0.0, 0.0
    kw = dict(q_offset=q_off, k_offset=k_off, causal=causal, window=window)
    valid = fa.chunk_valid(B, n, n, mask, device=dev, **kw)
    pairs = valid.sum().item() * H
    one = B * n * H * D * 2                  # one bf16 [B, n, H, D]
    stats = B * H * n * 4                    # m, l, lse or delta, fp32
    carry = 2 * stats + stats * D            # m, l and acc
    extra = 0 if mask is None else B * n * 4
    base = dict(case=name, B=B, S_local=n, H=H, D=D, q_offset=q_off,
                k_offset=k_off, causal=causal, window=window,
                masked=masked, pairs=pairs)

    def rel(got, want):
        err = (got - want).abs().max().item()
        return err, err / max(want.abs().max().item(), 1e-6)

    # K6, in the in-place form the ring calls (on copies of the carries),
    # held bit for bit to the out-of-place form and to the plain version.
    def run_fwd():
        return fa.flash_attention_chunk(q, k, v, mask, m, l, acc, **kw)

    carries = [t.clone() for t in (m, l, acc)]

    def run_in_place():
        return fa.flash_attention_chunk(q, k, v, mask, *carries, **kw,
                                        in_place=True)

    def plain_fwd():
        return fa.flash_attention_chunk_reference(q, k, v, mask, m, l, acc,
                                                  **kw)
    got, want = run_fwd(), plain_fwd()
    in_place = run_in_place()
    torch.cuda.synchronize()
    if not all(a is b for a, b in zip(in_place, carries)) or not all(
            torch.equal(a, b) for a, b in zip(in_place, got)):
        raise AssertionError(f"K6 {name}: in place differs from out of "
                             "place")
    if not pairs and not all(torch.equal(a, b)
                             for a, b in zip(carries, (m, l, acc))):
        raise AssertionError(f"K6 {name}: a chunk in the future must leave "
                             "the carries untouched in place")
    m_err = (got[0] - want[0]).abs().max().item()
    l_err, l_rel = rel(got[1], want[1])
    acc_err, acc_rel = rel(got[2], want[2])
    if not (all(torch.isfinite(t).all() for t in got)
            and m_err <= K6_M_ATOL and l_rel <= K6_L_REL_TOL
            and acc_rel <= K67_REL_TOL):
        raise AssertionError(f"K6 {name}: m err {m_err}, l rel {l_rel}, "
                             f"acc rel {acc_rel}")
    if not pairs and not all(torch.equal(a, b)
                             for a, b in zip(got, (m, l, acc))):
        raise AssertionError(f"K6 {name}: a skipped chunk must write its "
                             "carries unchanged")
    if dead and not (torch.equal(got[0][0, :, :10], m[0, :, :10])
                       and not got[2][0, :, :10].any()):
        raise AssertionError(f"K6 {name}: fully masked rows moved")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_mask = None if (mask is None and not causal) else valid
    # In place, operands and carries move only where some pair is visible:
    # a chunk in the future needs no byte moved.
    b_ms, b_by = bound(3 * one + extra + 2 * carry if pairs else 0,
                       2 * 2 * pairs * D)
    ms = cuda_ms(run_in_place)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=lib_mask))
    k6 = dict(base, max_abs_err=max(m_err, l_err, acc_err), m_err=m_err,
              l_rel_err=l_rel, acc_rel_err=acc_rel, tol_rel=K67_REL_TOL,
              ms=ms, device_ms=graph_ms(run_in_place),
              host_ms=host_ms(run_in_place),
              out_of_place_ms=cuda_ms(run_fwd),
              plain_ms=cuda_ms(plain_fwd), library_ms=library_ms,
              ratio_to_library=ms / library_ms,
              library="SDPA forward on the chunk pair, same boolean mask "
                      "(returns no carry)",
              bound_ms=b_ms, bound_by=b_by)

    # K7a and K7b from the finished state's lse; timed in the form the
    # ring calls, adding into fp32 sums in flight (copies), held bit for
    # bit to the out-of-place partial + add_.
    lse = want[0] + torch.log(want[1].clamp_min(1e-30))
    do = torch.randn(q.shape, generator=g, device=dev).to(q.dtype)
    delta = torch.randn(B, H, n, generator=g, device=dev)
    args = (q, k, v, mask, do, lse, delta)
    bufs = [torch.randn(B, H, n, D, generator=g, device=dev)
            for _ in range(3)]                   # dq, dk, dv sums
    sums = [t.clone() for t in bufs]

    def run_dq():
        return fa.flash_attention_chunk_dq(*args, **kw)

    def run_dkv():
        return fa.flash_attention_chunk_dkv(*args, **kw)

    def add_dq(out=sums[0]):
        return fa.flash_attention_chunk_dq(*args, **kw, out=out)

    def add_dkv(out=(sums[1], sums[2])):
        return fa.flash_attention_chunk_dkv(*args, **kw, out=out)

    def plain_dq():
        return fa.flash_attention_chunk_dq_reference(*args, **kw)

    def plain_dkv():
        return fa.flash_attention_chunk_dkv_reference(*args, **kw)
    errs = {}
    for gname, a, b in zip(("dq", "dk", "dv"), (run_dq(), *run_dkv()),
                           (plain_dq(), *plain_dkv())):
        torch.cuda.synchronize()
        err, r = rel(a, b)
        zero_ok = bool(b.abs().max() > 0) or not a.any()
        if not (torch.isfinite(a).all() and zero_ok
                and (r <= K67_REL_TOL or b.abs().max() == 0)):
            raise AssertionError(f"K7 {name} {gname}: max_abs_err {err}, "
                                 f"relative {r}")
        if dead and gname == "dq" and a[0, :, :10].any():
            raise AssertionError("K7: dq of fully masked rows must be 0")
        errs[gname] = (err, r)
    parts = (run_dq(), *run_dkv())
    added = (add_dq(), *add_dkv())
    again = [t.clone() for t in bufs]
    add_dq(again[0])
    add_dkv(tuple(again[1:]))
    torch.cuda.synchronize()
    if not all(a is t for a, t in zip(added, sums)):
        raise AssertionError(f"K7 {name}: out= must return the buffers")
    if not all(torch.equal(a, b + p) for a, b, p in zip(added, bufs, parts)):
        raise AssertionError(f"K7 {name}: adding in place differs from the "
                             "out-of-place partial + add_")
    if not pairs and not all(torch.equal(a, b) for a, b in zip(added, bufs)):
        raise AssertionError(f"K7 {name}: a chunk in the future must leave "
                             "the sums untouched")
    if not all(torch.equal(a, b) for a, b in zip(again, added)) or not all(
            torch.equal(a, b) for a, b in zip(parts, (run_dq(), *run_dkv()))):
        raise AssertionError(f"K7 {name}: two calls differ")
    ql, kl, vl = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=lib_mask)
    lib_do = do.transpose(1, 2)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), lib_do, retain_graph=True))
    lib = dict(library_ms=lib_ms,
               library="autograd.grad through SDPA on the chunk pair, "
                       "dq, dk and dv in one call (same number both rows)")
    # Added in place, operands and sums move only where some pair is
    # visible: an fp32 sum's rows read and written once (a chunk in the
    # future needs no byte moved).
    ops_bytes = 4 * one + 2 * stats + extra if pairs else 0
    sum_bytes = 2 * stats * D if pairs else 0

    def times(add, run, plain):
        ms = cuda_ms(add)
        return dict(ms=ms, device_ms=graph_ms(add), host_ms=host_ms(add),
                    out_of_place_ms=cuda_ms(run), plain_ms=cuda_ms(plain))
    # dq: S, dP, dQ, into the dq sum.
    b_ms, b_by = bound(ops_bytes + sum_bytes, 3 * 2 * pairs * D)
    k7a = dict(base, max_abs_err=errs["dq"][0], rel_err=errs["dq"][1],
               tol_rel=K67_REL_TOL, **times(add_dq, run_dq, plain_dq),
               bound_ms=b_ms, bound_by=b_by, **lib)
    # dkv: S, dP, dV, dK, into the dk and dv sums.
    b_ms, b_by = bound(ops_bytes + 2 * sum_bytes, 4 * 2 * pairs * D)
    k7b = dict(base, max_abs_err=max(errs["dk"][0], errs["dv"][0]),
               rel_err=max(errs["dk"][1], errs["dv"][1]),
               tol_rel=K67_REL_TOL, **times(add_dkv, run_dkv, plain_dkv),
               bound_ms=b_ms, bound_by=b_by, **lib)
    # The pair against SDPA's backward, which computes dq, dk and dv.
    pair = dict(pair_ms=k7a["ms"] + k7b["ms"],
                pair_ratio_to_library=(k7a["ms"] + k7b["ms"]) / lib_ms)
    k7a.update(pair)
    k7b.update(pair)
    del got, want, in_place, carries, lib_out, ql, kl, vl, bufs, sums, again
    return dict(k6=k6, k7a=k7a, k7b=k7b)


def ring_vs_flash(dev, g) -> dict:
    """The 4-shard ring over K6/K7 against K1/K2 over the whole train
    sequence (B=8, S=1024, H=16, D=128, causal, bf16), same q, k, v, dO:
    output and gradients."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.parallel.mesh import create_mesh
    from distributed_tensorflow_tpu_torch.parallel.ring import (
        make_ring_attention)
    B, S = TRAIN["batch"], TRAIN["seq_len"]
    H, D = WIDTH["num_heads"], WIDTH["hidden_size"] // WIDTH["num_heads"]
    fused = torch.randn(B, S, 3, H, D, generator=g, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
    q, k, v = (fused[:, :, i].detach().requires_grad_() for i in range(3))
    dout = torch.randn(B, S, H, D, generator=g, device=dev).to(q.dtype)
    ring = make_ring_attention(
        create_mesh(data=1, seq=RING_SEQ, devices=[dev] * RING_SEQ),
        causal=True)
    out = ring(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), dout)
    ref = fa.flash_attention(q, k, v, causal=True)[0]
    want = torch.autograd.grad(ref, (q, k, v), dout)
    torch.cuda.synchronize()
    row = dict(B=B, S=S, H=H, D=D, shards=RING_SEQ, causal=True,
               out_max_abs_err=(out.float() - ref.float()).abs().max().item(),
               out_tol=K1_OUT_TOL, grad_tol_rel=K2_REL_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        row[f"{name}_rel_err"] = ((a.float() - b.float()).abs().max()
                                  / b.float().abs().max()).item()
    if not (torch.isfinite(out).all() and row["out_max_abs_err"]
            <= K1_OUT_TOL and all(row[f"{x}_rel_err"] <= K2_REL_TOL
                                  for x in ("dq", "dk", "dv"))):
        raise AssertionError(f"ring over K6/K7 against K1/K2: {row}")
    del fused, q, k, v, out, got, ref, want
    torch.cuda.empty_cache()
    return row


def check_ring_kernels(dev, g) -> dict:
    """K6, K7a and K7b at the ring path's per-hop shape (q, k, v shards
    [8, 256, 16, 128] of the fused projection, bf16, fp32 carries) for
    the three hop kinds of the causal ring (a chunk wholly visible, on the
    diagonal, wholly in the future) and a padding mask with fully masked
    rows, a window, non-causal, D = 64 and D = 32; then the ring against
    K1/K2.  The path's row is the per-launch mean over one step's hops: of
    the 16 (shard, chunk) pairs of a 4-shard causal ring 6 are visible, 4
    diagonal, 6 in the future (K6 timed in place, as the ring calls it)."""
    import torch
    B, S = TRAIN["batch"], TRAIN["seq_len"]
    H, D = WIDTH["num_heads"], WIDTH["hidden_size"] // WIDTH["num_heads"]
    n = S // RING_SEQ
    cases = [("visible", 3 * n, 0, {}), ("diagonal", 2 * n, 2 * n, {}),
             ("future", 0, 3 * n, {}),
             ("masked_rows", 2 * n, 2 * n, dict(masked=True)),
             ("window", 3 * n, 2 * n, dict(window=n)),
             ("non_causal", 0, 3 * n, dict(causal=False, masked=True))]
    rows = {"k6": [], "k7a": [], "k7b": []}
    for d in (D, 64, 32):
        fused = torch.randn(B, S, 3, H, d, generator=g, device=dev,
                            dtype=torch.float32).to(torch.bfloat16)
        for name, q_off, k_off, kw in (cases if d == D else cases[1:2]):
            label = name if d == D else f"head_dim_{d}"
            for key, row in ring_chunk_case(dev, g, fused, label, q_off,
                                            k_off, **kw).items():
                rows[key].append(row)
        del fused
    hop_mean(rows, {"visible": 6, "diagonal": 4, "future": 6},
             "train_ring_hop_mean")
    rows["ring_vs_flash"] = ring_vs_flash(dev, g)
    torch.cuda.empty_cache()
    return rows


def hop_mean(rows: dict, weights: dict, label: str) -> None:
    """Put first in each of ``rows``' K6/K7a/K7b lists the per-launch mean
    over one step's hops, ``weights`` counting each hop kind's (shard,
    chunk) pairs."""
    for key, cs in rows.items():
        mix = [c for c in cs if c["case"] in weights]
        total = sum(weights.values())
        keys = [k for k in ("ms", "device_ms", "host_ms", "out_of_place_ms",
                            "plain_ms", "bound_ms", "library_ms", "pairs")
                if k in mix[0]]
        row = {k: sum(weights[c["case"]] * c[k] for c in mix) / total
               for k in keys}
        if key == "k6":
            row["ratio_to_library"] = row["ms"] / row["library_ms"]
        else:
            row["pair_ms"] = sum(
                sum(weights[c["case"]] * c["ms"] for c in rows[kk]
                    if c["case"] in weights) / total
                for kk in ("k7a", "k7b"))
            row["pair_ratio_to_library"] = row["pair_ms"] / row["library_ms"]
        row.update(case=label, hops=dict(weights),
                   max_abs_err=max(c["max_abs_err"] for c in mix),
                   bound_by=max(mix, key=lambda c: c["bound_ms"])[
                       "bound_by"], library=mix[0]["library"])
        rows[key].insert(0, row)


def check_parallel_ring_kernels(dev, g, B=None, H=None,
                                label="train_parallel_tp2_ring2", S=None,
                                D=None) -> dict:
    """K6, K7a and K7b at a 2-shard ring step's per-hop shape: by default
    the tp2 x ring2 step's, each model column's ring over its 8 heads,
    q/k/v shards [8, 512, 8, 128] of the fused projection (``B`` rows,
    ``H`` heads, sequence ``S`` and head dim ``D`` another step's: a data
    row's of dp2 x ring2, [4, 512, 16, 128]; a rank's of the train step's
    ring over two ranks, [8, 512, 16, 128]; gpt_mini's over two ranks,
    [32, 256, 4, 32]).  Of a 2-shard causal ring's 4 (shard, chunk) pairs
    1 is visible, 2 diagonal, 1 in the future: the row is their
    per-launch mean."""
    import torch
    S = S or TRAIN["seq_len"]
    B = B or TRAIN["batch"]
    H = H or WIDTH["num_heads"] // 2
    D = D or WIDTH["hidden_size"] // WIDTH["num_heads"]
    n = S // 2
    fused = torch.randn(B, S, 3, H, D, generator=g, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
    rows = {"k6": [], "k7a": [], "k7b": []}
    for name, q_off, k_off in (("visible", n, 0), ("diagonal", 0, 0),
                               ("future", 0, n)):
        for key, row in ring_chunk_case(dev, g, fused, name, q_off, k_off,
                                        shards=2).items():
            rows[key].append(row)
    hop_mean(rows, {"visible": 1, "diagonal": 2, "future": 1},
             f"{label}_hop_mean")
    del fused
    torch.cuda.empty_cache()
    return rows


def bf16_ulp(t):
    """One bf16 ulp of each element's magnitude (8 significant bits)."""
    import torch
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def int8_case(dev, g, kind, case, M, K, N, block_k, variant):
    """K4 (``kind`` "k4": x [M, K] @ qw [K, N]), K5 ("k5": da [M, K]
    against qw [N, K]) or K8 ("k8": da * gelu'(pre) [M, K] @ qwt [K, N])
    on bf16 inputs against its plain version, with its times, the two
    yardsticks and the bound."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    bf = torch.bfloat16
    a = torch.randn(M, K, generator=g, device=dev).to(bf)
    if kind == "k4":
        qw, sw = qmm.quantize_cols(
            0.02 * torch.randn(K, N, generator=g, device=dev))
        kw = dict(block_k=block_k)
        args = [a, qw, sw, None, None]
        if variant != "plain":
            args[3] = 0.1 * torch.randn(N, generator=g, device=dev)
        if variant == "bias_gelu_preact":
            kw.update(activation="gelu", want_preact=True)
        if variant == "bias_residual":
            args[4] = torch.randn(M, N, generator=g, device=dev).to(bf)
        kernel, plain = qmm.quantized_matmul, qmm.quantized_matmul_reference
        extra = sum(t.numel() * t.element_size() for t in args[3:]
                    if t is not None)
        outs = 2 if kw.get("want_preact") else 1
        bytes_moved = (a.numel() * 2 + qw.numel() + 4 * N + extra
                       + outs * M * N * 2)
        # [K, N] K-contiguous: the layout the library's int8 GEMM takes
        # fast (row-major it ran ~6x slower on the H100).
        qw_lib = qw.t().contiguous().t()
    elif kind == "k8":
        qw, sw = qmm.quantize_cols(
            0.02 * torch.randn(K, N, generator=g, device=dev))
        kw = dict(block_k=block_k, want_g=variant == "dgelu_want_g")
        pre = (2 * torch.randn(M, K, generator=g, device=dev)).to(bf)
        args = [a, pre, qw, sw]
        kernel = qmm.quantized_matmul_dgelu
        plain = qmm.quantized_matmul_dgelu_reference
        bytes_moved = (2 * a.numel() * 2 + qw.numel() + 4 * N + M * N * 2
                       + (M * K * 2 if kw["want_g"] else 0))
        qw_lib = qw.t().contiguous().t()         # K-contiguous, as for K4
    else:
        qw, sw = qmm.quantize_cols(
            0.02 * torch.randn(N, K, generator=g, device=dev))
        kw = dict(block_k=block_k, want_g=variant == "dgelu_fold_want_g")
        args = [a, qw, sw, None]
        if variant != "fold":
            kw["prologue"] = "dgelu_fold"
            args[3] = (2 * torch.randn(M, K, generator=g, device=dev)).to(bf)
        kernel = qmm.quantized_matmul_nt
        plain = qmm.quantized_matmul_nt_reference
        bytes_moved = (a.numel() * 2 * (1 if args[3] is None else 2)
                       + qw.numel() + 4 * K + M * N * 2
                       + (M * K * 2 if kw["want_g"] else 0))
        qw_lib = qw.t()                          # [K, N], K-contiguous
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = []
    # K4 without gelu and K5's fold variant hold the plain version's bits.
    no_tanh = variant in ("plain", "bias", "bias_residual", "fold")
    for name, x, y in zip(("out", "second"), got, want):
        err = (x.float() - y.float()).abs().max().item()
        peak = y.float().abs().max().item()
        if no_tanh:
            ok, tol = torch.equal(x, y), "bit-equal (no tanh enters)"
        elif kind != "k4" and name == "second":          # g: elementwise
            ok = bool(((x.float() - y.float()).abs()
                       <= bf16_ulp(y)).all())
            tol = "one bf16 ulp of each element"
        elif kind != "k4":
            ok, tol = err <= K5_REL_TOL * peak, f"{K5_REL_TOL} x peak"
        else:
            ulp = bf16_ulp(torch.tensor(peak)).item()
            ok, tol = err <= ulp, f"one bf16 ulp of the peak ({ulp})"
        if not (ok and torch.isfinite(x).all()):
            raise AssertionError(f"{kind} {case} {variant} {name}: "
                                 f"max_abs_err {err} at peak {peak}, tol "
                                 f"{tol}")
        errs.append(dict(output=name, max_abs_err=err, peak=peak, tol=tol))
    b_ms, b_by = bound(bytes_moved, 2 * M * K * N, PEAK_INT8_OPS)
    q_lib = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                          dtype=torch.int8)
    w_bf16 = torch.randn(K, N, generator=g, device=dev).to(bf)
    library_ms = cuda_ms(lambda: torch._int_mm(q_lib, qw_lib))
    row = dict(case=case, variant=variant, M=M, K=K, N=N,
               block_k=qmm._pick(K, block_k),
               max_abs_err=max(e["max_abs_err"] for e in errs), errors=errs,
               ms=cuda_ms(lambda: kernel(*args, **kw)),
               plain_ms=cuda_ms(lambda: plain(*args, **kw)),
               bound_ms=b_ms, bound_by=b_by,
               # Yardsticks, never called by the port: the library's int8
               # GEMM on operands already quantized, and the bf16 GEMM of
               # the same M, K, N.
               library_ms=library_ms,
               library="torch._int_mm on pre-quantized int8 operands",
               library_bf16_ms=cuda_ms(lambda: torch.matmul(a, w_bf16)))
    # Bit for bit or not (every no-tanh variant is held to it above).
    row["bit_equal"] = all(torch.equal(x, y) for x, y in zip(got, want))
    row.update(int8_stages(kind, args, kw, library_ms))
    del args, got, want, q_lib, w_bf16
    return row


def int8_stages(kind, args, kw, library_ms) -> dict:
    """K4's, K5's or K8's two kernels one at a time on the call's inputs:
    kernel A (the quantize pass) and kernel B (the block-scaled GEMM on A's
    codes) each held bit for bit to its plain version (B within one ulp of
    the peak where gelu enters), each timed, with its bound; B's TOP/s and
    its time over ``torch._int_mm``'s (``library_ms``); for K4 and K8 the
    weight transpose kernel, held bit for bit to ``qw.t()`` and timed
    beside ``qw.t().contiguous()``."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    if kind == "k8":
        a, pre, qw, sw = args
    else:
        a, qw, sw = args[:3]
    M, K = a.shape
    bk = qmm._block_k(K, kw["block_k"])
    if kind == "k8":
        # A with gelu' and g but no fold; B with the bare ``* sw``.
        qa = dict(pre=pre, sf=None, want_g=kw["want_g"])
        w = qw.t().contiguous()
        gemm_args = (w, bk, sw)
        gemm_kw = dict(out_dtype=a.dtype)
    elif kind == "k4":
        bias, residual = args[3], args[4]
        qa = dict(pre=None, sf=None, want_g=False)
        w = qw.t().contiguous()
        gemm_args = (w, bk, sw, bias, residual)
        gemm_kw = dict(activation=kw.get("activation"),
                       want_preact=kw.get("want_preact", False),
                       out_dtype=a.dtype)
    else:
        qa = dict(pre=args[3], sf=sw, want_g=kw.get("want_g", False))
        w = qw
        gemm_args = (w, bk)
        gemm_kw = dict(out_dtype=a.dtype)
    N = w.shape[0]

    def stage_a():
        return qmm.quantize_blocks(a, bk, qa["pre"], qa["sf"],
                                   want_g=qa["want_g"])

    got_a = stage_a()
    want_a = qmm.quantize_blocks_reference(a, bk, qa["pre"], qa["sf"],
                                           want_g=qa["want_g"])
    q, sx, _ = want_a

    def stage_b():
        return qmm.blocked_gemm(q, sx, *gemm_args, **gemm_kw)

    got_b = stage_b()
    want_b = qmm.blocked_gemm_reference(q, sx, *gemm_args, **gemm_kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("q", "sx", "g"), got_a, want_a):
        if (x is None) != (y is None) or (x is not None
                                          and not torch.equal(x, y)):
            raise AssertionError(f"{kind} kernel A: {name} differs from "
                                 "its plain version")
    got_b = got_b if isinstance(got_b, tuple) else (got_b,)
    want_b = want_b if isinstance(want_b, tuple) else (want_b,)
    b_err = 0.0
    for i, (x, y) in enumerate(zip(got_b, want_b)):
        if gemm_kw.get("activation") != "gelu" or i == 1:
            if not torch.equal(x, y):
                raise AssertionError(f"{kind} kernel B: output {i} differs "
                                     "from its plain version")
            continue
        b_err = (x.float() - y.float()).abs().max().item()
        peak = y.float().abs().max().item()
        if not b_err <= bf16_ulp(torch.tensor(peak)).item():
            raise AssertionError(f"{kind} kernel B: max_abs_err {b_err} at "
                                 f"peak {peak}")
    esize = a.element_size()
    a_bytes = (a.numel() * esize * (1 if qa["pre"] is None else 2) + M * K
               + (M * K * esize if qa["want_g"] else 0) + 4 * M * (K // bk)
               + (4 * K if qa["sf"] is not None else 0))
    a_ms = cuda_ms(stage_a)
    gemm_ms = cuda_ms(stage_b)
    out = dict(a_ms=a_ms, a_bound_ms=a_bytes / PEAK_BYTES * 1e3,
               a_bound_by="bytes", b_ms=gemm_ms,
               b_bound_ms=2 * M * K * N / PEAK_INT8_OPS * 1e3,
               b_bound_by="operations",
               b_tops=2 * M * K * N / (gemm_ms * 1e-3) / 1e12,
               b_ratio_to_library=gemm_ms / library_ms,
               stages_bit_equal="A; B" + (" (gelu output: max_abs_err "
                                          f"{b_err})" if b_err else ""))
    if kind in ("k4", "k8"):
        wt = qmm.transpose_s8(qw)
        torch.cuda.synchronize()
        if not torch.equal(wt, qw.t()):
            raise AssertionError("transpose_s8 differs from qw.t()")
        out["transpose_ms"] = cuda_ms(lambda: qmm.transpose_s8(qw))
        out["transpose_plain_ms"] = cuda_ms(lambda: qw.t().contiguous())
        del wt
    del got_a, want_a, got_b, want_b, q, sx, w
    return out


@contextlib.contextmanager
def plain_int8_stages():
    """The quantize pass, the GEMM and the transpose of ``quant_matmul``
    through their plain versions, for a comparison only (the wrappers
    launch the kernels on the card)."""
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    saved = qmm.quantize_blocks, qmm.blocked_gemm, qmm.transpose_s8
    qmm.quantize_blocks = qmm.quantize_blocks_reference
    qmm.blocked_gemm = qmm.blocked_gemm_reference
    qmm.transpose_s8 = lambda w: w.t().contiguous()
    try:
        yield
    finally:
        qmm.quantize_blocks, qmm.blocked_gemm, qmm.transpose_s8 = saved


def split_k_case(dev, g, kind, case, M, K, N, n, block_k, variant):
    """K4 (``kind`` "k4": ``quantized_matmul_split_k``, the row-parallel
    mlp_out: x [M, K] split into ``n`` K parts against the weight's row
    shards quantized with the whole K's column scales, fp32 partials out)
    or K5 ("k5": ``quantized_matmul_nt_split_k``, the mlp_in dgrad: da
    [M, K] split into K parts, gelu' with g for ``dgelu_fold_want_g``)
    against the same composition of the plain stages, shard by shard.
    Where the whole K's K-block spans shards (gpt_mini's 512 over shards
    of 256) kernel A runs twice a shard, the second time with the block's
    scales given (the max over its parts): that given-scale pass is also
    held bit for bit to its plain version."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    bf = torch.bfloat16
    a = torch.randn(M, K, generator=g, device=dev).to(bf)
    parts = list(a.chunk(n, dim=1))
    Kj = K // n
    if kind == "k4":
        w = 0.02 * torch.randn(K, N, generator=g, device=dev)
        sw = qmm.col_scales(list(w.chunk(n)))
        qws = [qmm.quantize_cols(p, sw)[0] for p in w.chunk(n)]

        def run():
            return qmm.quantized_matmul_split_k(parts, qws, sw,
                                                block_k=block_k)
        lib_w = [q.t().contiguous().t() for q in qws]
        bytes_moved = M * K * 2 + K * N + 4 * N + n * M * N * 4
    else:
        qw, sw = qmm.quantize_cols(0.02 * torch.randn(N, K, generator=g,
                                                      device=dev))
        qws = [q.contiguous() for q in qw.chunk(n, dim=1)]
        sws = [s.contiguous() for s in sw.chunk(n, dim=1)]
        pres = [p for p in (2 * torch.randn(M, K, generator=g, device=dev)
                            ).to(bf).chunk(n, dim=1)]

        def run():
            parts_out, gs = qmm.quantized_matmul_nt_split_k(
                parts, qws, sws, pres, prologue="dgelu_fold", want_g=True,
                block_k=block_k)
            return parts_out + gs
        lib_w = [q.t() for q in qws]
        bytes_moved = 2 * M * K * 2 + N * K + 4 * K + n * M * N * 4 \
            + M * K * 2
    got = run()
    with plain_int8_stages():
        want = run()
    torch.cuda.synchronize()
    errs = []
    for i, (x, y) in enumerate(zip(got, want)):
        err = (x.float() - y.float()).abs().max().item()
        peak = y.float().abs().max().item()
        if kind == "k4":
            ok, tol = torch.equal(x, y), "bit-equal (no tanh enters)"
        elif i >= n:                                    # g: elementwise
            ok = bool(((x.float() - y.float()).abs() <= bf16_ulp(y)).all())
            tol = "one bf16 ulp of each element"
        else:
            ok, tol = err <= K5_REL_TOL * peak, f"{K5_REL_TOL} x peak"
        if not (ok and torch.isfinite(x).all()):
            raise AssertionError(f"{kind} {case}: output {i} max_abs_err "
                                 f"{err} at peak {peak}, tol {tol}")
        errs.append(dict(output=i, max_abs_err=err, peak=peak, tol=tol))
    bk = qmm._block_k(K, block_k)
    sub = math.gcd(bk, Kj)
    given = None
    if sub < bk:
        # Kernel A with given scales (the straddling block's), bit for bit.
        sx = torch.rand(Kj // sub, M, generator=g, device=dev) * 0.05 + 1e-3
        got_a = qmm.quantize_blocks(parts[0], sub, sx=sx)
        want_a = qmm.quantize_blocks_reference(parts[0], sub, sx=sx)
        torch.cuda.synchronize()
        if not (torch.equal(got_a[0], want_a[0])
                and torch.equal(got_a[1], want_a[1])):
            raise AssertionError(f"{case}: kernel A with given scales "
                                 "differs from its plain version")
        given = dict(sub_block=sub, block=bk, bit_equal=True,
                     a_ms=cuda_ms(lambda: qmm.quantize_blocks(
                         parts[0], sub, sx=sx)))
    q_lib = torch.randint(-127, 128, (M, Kj), generator=g, device=dev,
                          dtype=torch.int8)
    w_bf16 = torch.randn(Kj, N, generator=g, device=dev).to(bf)
    b_ms, b_by = bound(bytes_moved, 2 * M * K * N, PEAK_INT8_OPS)

    def plain():
        with plain_int8_stages():
            return run()
    row = dict(case=case, variant=variant, M=M, K=K, N=N, shards=n,
               block_k=bk, gemm_block=sub, max_abs_err=max(
                   e["max_abs_err"] for e in errs), errors=errs,
               ms=cuda_ms(run), plain_ms=cuda_ms(plain), bound_ms=b_ms,
               bound_by=b_by,
               library_ms=cuda_ms(lambda: [torch._int_mm(q_lib, w)
                                           for w in lib_w]),
               library="torch._int_mm on pre-quantized int8 operands, one "
                       "a shard",
               library_bf16_ms=cuda_ms(lambda: [torch.matmul(
                   a[:, :Kj], w_bf16) for _ in range(n)]),
               bit_equal=all(torch.equal(x, y) for x, y in zip(got, want)))
    if given is not None:
        row["given_scales"] = given
    del a, parts, got, want, q_lib, w_bf16
    return row


def check_int8_kernels(dev, g):
    """K4 and K5 at the int8 train step's four call sites (M = B*S = 8192
    rows of GPT-406M: mlp_in H=2048 -> I=8192, mlp_out I -> H, and their
    dgrads) in the variants those sites use, the other variants at the
    same shapes, and one small non-square case (M=200, K=384 in three
    K-blocks of 128, N=640); K8 at the mlp_in dgrad's shape, with and
    without g."""
    M = TRAIN["batch"] * TRAIN["seq_len"]
    H, I = WIDTH["hidden_size"], WIDTH["intermediate_size"]
    k4 = [("mlp_in", M, H, I, 512, "bias_gelu_preact"),
          ("mlp_out", M, I, H, 1024, "bias"),
          ("mlp_out", M, I, H, 1024, "plain"),
          ("mlp_out", M, I, H, 1024, "bias_residual"),
          ("mini", 200, 384, 640, 512, "bias_gelu_preact")]
    k5 = [("mlp_out_dgrad", M, H, I, 1024, "fold"),
          ("mlp_in_dgrad", M, I, H, 512, "dgelu_fold_want_g"),
          ("mlp_in_dgrad", M, I, H, 512, "dgelu_fold"),
          ("mini", 200, 384, 640, 512, "dgelu_fold_want_g")]
    # K8 (on no path) at the mlp_in dgrad's shape: da, pre [M, I], the
    # re-quantized w_in.T [I, H].
    k8 = [("mlp_in_dgrad", M, I, H, 512, "dgelu_want_g"),
          ("mlp_in_dgrad", M, I, H, 512, "dgelu")]
    rows = {"k4": [int8_case(dev, g, "k4", *c) for c in k4],
            "k5": [int8_case(dev, g, "k5", *c) for c in k5],
            "k8": [int8_case(dev, g, "k8", *c) for c in k8]}
    # int8 beside tensor parallelism (the train_parallel phase's tp2_int8
    # arm): each shard's column sites, mlp_in at N / 2 and the mlp_out
    # dgrad at N / 2, and its split-K sites, mlp_out at K / 2 (fp32
    # partials, the whole K's scales) and the mlp_in dgrad at K / 2; then
    # the same split at gpt_mini's width (B=32, S=512), whose K-blocks of
    # 512 span both shards of 256.
    cli_m = TRAINER["gpt_batch"] * TRAINER["gpt_seq"]
    rows["tp"] = {
        "k4": [int8_case(dev, g, "k4", "tp2_mlp_in", M, H, I // 2, 512,
                         "bias_gelu_preact"),
               split_k_case(dev, g, "k4", "tp2_mlp_out", M, I, H, 2, 1024,
                            "partials"),
               split_k_case(dev, g, "k4", "tp2_cli_mlp_out", cli_m, 512,
                            128, 2, 1024, "partials")],
        "k5": [int8_case(dev, g, "k5", "tp2_mlp_out_dgrad", M, H, I // 2,
                         1024, "fold"),
               split_k_case(dev, g, "k5", "tp2_mlp_in_dgrad", M, I, H, 2,
                            512, "dgelu_fold_want_g"),
               split_k_case(dev, g, "k5", "tp2_cli_mlp_in_dgrad", cli_m,
                            512, 128, 2, 512, "dgelu_fold_want_g")]}
    import torch
    torch.cuda.empty_cache()
    return rows


def check_model(dev, model, gpt):
    """The kernel path against the plain path (dense attention, plain
    LayerNorm) with the same weights, on a 112-token prompt."""
    import torch
    plain = gpt.GptLM(dataclasses.replace(
        model.cfg, attention_backend="xla", fused_ln=False), device=dev)
    plain.load_state_dict(model.state_dict())
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    tokens = torch.randint(0, model.cfg.vocab_size, (1, 112), generator=g,
                           device=dev)
    logits = []
    for m in (model, plain):
        caches = gpt.init_kv_cache(m.cfg, 1, 112, device=dev)
        logits.append(m.prefill(tokens, caches)[0].float())
    err = (logits[0] - logits[1]).abs().max().item()
    if not (logits[0].shape == (1, model.cfg.vocab_size)
            and torch.isfinite(logits[0]).all() and err <= MODEL_LOGIT_TOL):
        raise AssertionError(f"model logits: max_abs_err {err} (tol "
                             f"{MODEL_LOGIT_TOL})")
    del plain
    return err


def profile_window(fn) -> dict:
    """``torch.profiler`` over ``fn()``: the window's wall time, the
    card's busy share of it and the kernels that take most of its device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return dict(window_ms=window_ms, device_busy_ms=busy_ms,
                busy_share=busy_ms / window_ms if rows else None,
                top=[[name[:60], ms, n] for name, ms, n in rows[:8]])


def profile_request(client, prompt) -> dict:
    """One request (512-token prompt, 64 new tokens) through the HTTP
    tier under :func:`profile_window`."""
    return dict(prompt_tokens=len(prompt), new_tokens=NEW_TOKENS,
                **profile_window(lambda: client.generate(
                    prompt, NEW_TOKENS, tenant="profile")))


def burst(client, prompts, kw_for) -> tuple[list, float]:
    """Every prompt as a concurrent HTTP request (``NEW_TOKENS`` each,
    ``kw_for(i)`` its options); the responses and the wall seconds."""
    results: list = [None] * len(prompts)

    def send(i):
        results[i] = client.generate(prompts[i], NEW_TOKENS, **kw_for(i))

    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    burst_s = time.perf_counter() - t0
    done = [r for r in results if r is not None]
    if len(done) != len(prompts):
        raise AssertionError(f"{len(done)}/{len(prompts)} requests done")
    for p, r in zip(prompts, done):
        if r["tokens_out"] != NEW_TOKENS or r["tokens"][:len(p)] != p \
                or len(r["tokens"]) != len(p) + NEW_TOKENS:
            raise AssertionError(f"incomplete response: {r['tokens_out']}")
        if not all(0 <= t < WIDTH["vocab_size"] for t in r["tokens"]):
            raise AssertionError("token outside the vocabulary")
    return done, burst_s


def burst_numbers(results, burst_s) -> dict:
    """The end-to-end serving metrics of one burst."""
    ttft = [r["ttft_ms"] for r in results]
    return dict(tokens_per_s=len(results) * NEW_TOKENS / burst_s,
                burst_s=burst_s, ttft_p50_ms=statistics.median(ttft),
                ttft_ms=ttft,
                tpot_p50_ms=statistics.median(r["tpot_ms"]
                                              for r in results))


def mixed_kw(i) -> dict:
    """The serve phase's request mix: two tenants, the odd requests
    sampled with seeds."""
    kw = dict(tenant=("search", "ads")[i % 2])
    if i % 2:
        kw.update(temperature=0.8, top_k=40, seed=100 + i)
    return kw


class Serving:
    """An engine behind ``ServingServer`` on localhost and a client."""

    def __init__(self, dev, model, **engine_kw):
        from distributed_tensorflow_tpu_torch.serving.client import (
            ServeClient)
        from distributed_tensorflow_tpu_torch.serving.engine import (
            DecodeEngine, EngineConfig)
        from distributed_tensorflow_tpu_torch.serving.scheduler import (
            FairScheduler)
        from distributed_tensorflow_tpu_torch.serving.server import (
            ServingServer)
        from distributed_tensorflow_tpu_torch.utils.telemetry import (
            Telemetry)
        self.telemetry = Telemetry()
        self.engine = DecodeEngine(model, None,
                                   EngineConfig(**{**ENGINE, **engine_kw}),
                                   self.telemetry, device=dev)
        self.server = ServingServer(self.engine, FairScheduler(), port=0,
                                    host="127.0.0.1",
                                    telemetry=self.telemetry)
        self.server.start()
        self.client = ServeClient(f"http://127.0.0.1:{self.server.port}",
                                  timeout_s=600.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.server.shutdown()


def serve(dev) -> tuple[dict, object, dict]:
    """Phase 4: the port's serving path over HTTP.  Returns the launches,
    the model (the later serving phases reuse its weights) and this
    whole-bucket arm's prompts, responses and numbers."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import layer_norm as ln

    t0 = time.perf_counter()
    model = gpt.GptLM(gpt.GptConfig(**WIDTH), device=dev, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    logit_err = check_model(dev, model, gpt)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, WIDTH["vocab_size"], n).tolist()
               for n in PROMPT_LENS]
    with Serving(dev, model) as srv:
        client = srv.client
        client.generate(prompts[0][:16], 4)            # warm-up
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0

        fa.launches = 0
        ln.launches = 0
        done, burst_s = burst(client, prompts, mixed_kw)
        again = client.generate(prompts[0], NEW_TOKENS, tenant="search")
        launches = {"flash_attention_fwd": fa.launches,
                    "layer_norm_fwd": ln.launches}
        stats = client.stats()
        profiled = profile_request(client, prompts[3])

    if again["tokens"] != done[0]["tokens"]:
        raise AssertionError("repeated greedy request gave other tokens")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    numbers = burst_numbers(done, burst_s)
    emit("profile", **profiled)
    emit("serve", model="gpt_406m_width", params=n_params,
         requests=len(done), new_tokens_each=NEW_TOKENS,
         prompt_lens=list(PROMPT_LENS), **numbers,
         engine_steps=stats["engine"]["engine_step"],
         greedy_repeat_identical=True, launches=launches,
         model_logit_err=logit_err, model_logit_tol=MODEL_LOGIT_TOL,
         setup_s=setup_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches, model, dict(prompts=prompts, results=done, **numbers)


def first_token_logits(engine, prompt):
    """Admit ``prompt`` alone (greedy, one new token) and step the engine
    until the lane emits: the fp32 logits row its token was chosen from."""
    from distributed_tensorflow_tpu_torch.serving.scheduler import Request
    seen = []
    sample = engine._sample

    def spy(logits):
        seen.append(logits.float())
        return sample(logits)

    engine._sample = spy
    try:
        req = Request(prompt, 1)
        slot = engine.admit(req)
        while not req.tokens:
            engine.step()
    finally:
        del engine._sample
    return seen[-1][slot]


def first_divergence(a, b):
    """Index of the first token where two streams differ (None: equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def fp32_model(dev):
    """The serving width in fp32 with 2 layers: the setting in which the
    JAX package's tests hold the engine's arms to token parity."""
    from distributed_tensorflow_tpu_torch.models import gpt
    return gpt.GptLM(gpt.GptConfig(**{**WIDTH, "num_layers": 2,
                                      "dtype": "float32"}),
                     device=dev, seed=SEED)


def engine_tokens(dev, model, prompts, **engine_kw):
    """Every prompt's ``NEW_TOKENS`` greedy tokens (and spec rounds) from
    an engine stepped in this thread, all requests admitted at once with
    ``speculative=True`` (honoured where the engine has ``spec_k``)."""
    from distributed_tensorflow_tpu_torch.serving.engine import (
        DecodeEngine, EngineConfig)
    from distributed_tensorflow_tpu_torch.serving.scheduler import Request
    engine = DecodeEngine(model, None,
                          EngineConfig(**{**ENGINE, **engine_kw}),
                          device=dev)
    reqs = [Request(p, NEW_TOKENS, speculative=True) for p in prompts]
    for r in reqs:
        engine.admit(r)
    while engine.active_slots:
        engine.step()
    if not all(len(r.tokens) == NEW_TOKENS for r in reqs):
        raise AssertionError("a request ended early")
    return [r.tokens for r in reqs], [r.spec_rounds for r in reqs]


def fp32_parity(dev, prompts, **engine_kw) -> list:
    """Gate: in fp32 at the full width and 2 layers, the engine arm's
    tokens equal the plain whole-bucket engine's for every prompt.
    Returns the arm's spec rounds per request."""
    f32 = fp32_model(dev)
    arm, rounds = engine_tokens(dev, f32, prompts, **engine_kw)
    plain, _ = engine_tokens(dev, f32, prompts)
    del f32
    divergence = [first_divergence(a, b) for a, b in zip(arm, plain)]
    if any(d is not None for d in divergence):
        raise AssertionError(f"fp32 {engine_kw} tokens differ from the "
                             f"plain engine's at {divergence}")
    return rounds


def serve_chunked(dev, model, whole: dict) -> dict:
    """Phase ``serve_chunked``: the serve phase's model, engine and
    requests with ``prefill_chunk=PREFILL_CHUNK``.  Gate: in fp32 at the
    full width and 2 layers, every prompt's greedy tokens equal the
    whole-bucket engine's.  Then, in bf16, each prompt's first-token
    logits against the whole-bucket engine's; each request's tokens
    against the serve phase's (reported, not gated: a bf16 near-tie may
    flip an argmax); K3's launches exact."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import layer_norm as ln
    from distributed_tensorflow_tpu_torch.serving.engine import (
        DecodeEngine, EngineConfig)

    prompts = whole["prompts"]
    fp32_parity(dev, prompts, prefill_chunk=PREFILL_CHUNK)
    # Engines of their own, stepped in this thread.
    engines = [DecodeEngine(model, None, EngineConfig(**{
        **ENGINE, "prefill_chunk": c}), device=dev) for c in
        (PREFILL_CHUNK, 0)]
    logit_errs = [(first_token_logits(engines[0], p)
                   - first_token_logits(engines[1], p)).abs().max().item()
                  for p in prompts]
    del engines
    with Serving(dev, model, prefill_chunk=PREFILL_CHUNK) as srv:
        srv.client.generate(prompts[0][:40], 4)           # warm-up
        torch.cuda.synchronize()
        fa.launches = ln.launches = 0
        chunk_ms = srv.telemetry.histogram("serve_prefill_chunk_ms")
        steps0, chunks0 = srv.engine.step_index, chunk_ms.count
        done, burst_s = burst(srv.client, prompts, mixed_kw)
        launches = {"flash_attention_fwd": fa.launches,
                    "layer_norm_fwd": ln.launches}
        steps = srv.engine.step_index - steps0
        dispatches = chunk_ms.count - chunks0
        prefill_ms = srv.engine.prefill_ms_total
    L = WIDTH["num_layers"]
    want_ln = 2 * L * dispatches + (2 * L + 1) * steps
    if launches != {"flash_attention_fwd": 0, "layer_norm_fwd": want_ln}:
        raise AssertionError(f"launches {launches}: expected K3 "
                             f"{want_ln} ({dispatches} chunk dispatches, "
                             f"{steps} decode steps) and no K1")
    if not max(logit_errs) <= MODEL_LOGIT_TOL:
        raise AssertionError(f"first-token logits {logit_errs} against the "
                             f"whole-bucket engine's (tol "
                             f"{MODEL_LOGIT_TOL})")
    divergence = [first_divergence(r["tokens"], w["tokens"])
                  for r, w in zip(done, whole["results"])]
    numbers = burst_numbers(done, burst_s)
    emit("serve_chunked", prefill_chunk=PREFILL_CHUNK, requests=len(done),
         fp32_2_layers=dict(tokens_equal_whole_bucket=len(prompts)),
         new_tokens_each=NEW_TOKENS, prompt_lens=list(PROMPT_LENS),
         **numbers, whole_bucket={k: whole[k] for k in (
             "tokens_per_s", "ttft_p50_ms", "tpot_p50_ms")},
         first_token_logit_err=logit_errs, logit_tol=MODEL_LOGIT_TOL,
         tokens_equal_whole_bucket=sum(d is None for d in divergence),
         first_divergence=divergence, chunk_dispatches=dispatches,
         decode_steps=steps, prefill_ms_total=prefill_ms,
         launches=launches)
    return launches


def phrase_prompts() -> list:
    """A seeded 24-token phrase repeated to each of ``PROMPT_LENS``: the
    n-gram drafter finds the phrase's continuation in every prompt."""
    import numpy as np
    phrase = np.random.default_rng(SEED + 2).integers(
        0, WIDTH["vocab_size"], 24)
    return [np.resize(phrase, n).tolist() for n in PROMPT_LENS]


def serve_spec(dev, model) -> dict:
    """Phase ``serve_spec``: the speculative arm (``spec_k=SPEC_K``,
    ``spec_ngram=3``) on greedy ``speculative=True`` requests for the
    repeated-phrase prompts.  Gate: in fp32 at the full width and 2
    layers, each request's tokens equal those of the same engine with
    ``spec_k=0``.  Then the bf16 model of the serve phase over HTTP, the
    plain engine beside it: the accepted share of the drafts, tokens/s,
    TPOT, and K1/K3 launches exact."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import layer_norm as ln

    prompts = phrase_prompts()
    spec_cfg = dict(spec_k=SPEC_K, spec_ngram=3)
    f32_rounds = fp32_parity(dev, prompts, **spec_cfg)

    L = WIDTH["num_layers"]
    arms = {}
    for name, kw in (("plain", {}), ("spec", spec_cfg)):
        with Serving(dev, model, **kw) as srv:
            srv.client.generate(prompts[0][:40], 4, speculative=True)
            torch.cuda.synchronize()
            fa.launches = ln.launches = 0
            steps0 = srv.engine.step_index
            done, burst_s = burst(srv.client, prompts, lambda i: dict(
                speculative=True))
            launches = {"flash_attention_fwd": fa.launches,
                        "layer_norm_fwd": ln.launches}
            steps = srv.engine.step_index - steps0
        # Whole-bucket prefills (K1 once a layer, K3 2 a layer + 1), then
        # one decode or verify dispatch a step (K3 2 a layer + 1).
        n = len(prompts)
        want = {"flash_attention_fwd": L * n,
                "layer_norm_fwd": (2 * L + 1) * (n + steps)}
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"{want} ({steps} steps)")
        arm = dict(burst_numbers(done, burst_s), steps=steps,
                   launches=launches)
        if name == "spec":
            rounds = sum(r.get("spec_rounds", 0) for r in done)
            drafted = (SPEC_K - 1) * rounds
            accepted = sum(r["tokens_out"] for r in done) - rounds
            arm.update(spec_rounds=rounds, drafted=drafted,
                       accepted_drafts=accepted,
                       accepted_share=accepted / drafted if drafted else 0.0)
        arms[name] = arm
    emit("serve_spec", spec_k=SPEC_K, spec_ngram=3, requests=len(prompts),
         new_tokens_each=NEW_TOKENS, prompt_lens=list(PROMPT_LENS),
         fp32_2_layers=dict(tokens_equal_plain=len(prompts),
                            spec_rounds=f32_rounds), **arms)
    return arms["spec"]["launches"]


def generate_prompts(V: int):
    """The generate phase's prompts: ``GEN["batch"]`` random rows, and as
    many rows repeating a seeded 24-token phrase (each from another
    offset), all ``GEN["prompt"]`` tokens long."""
    import numpy as np
    B, P = GEN["batch"], GEN["prompt"]
    rand = np.random.default_rng(SEED + 3).integers(0, V, (B, P))
    phrase = np.random.default_rng(SEED + 2).integers(0, V, 24)
    return rand, np.stack([np.resize(np.roll(phrase, -5 * b), P)
                           for b in range(B)])


class DecodeArm:
    """One arm of the generate phase: the launch counters set to 0 just
    before ``fn()`` runs and read just after, and ``check(result,
    launches)`` (by default: equal to ``want(result)``, the exact counts)
    must hold; ``ms`` is the call's wall time, ending in a synchronise."""

    def __init__(self, name, fn, want=None, check=None):
        import torch
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.result = fn()
        torch.cuda.synchronize()
        self.ms = (time.perf_counter() - t0) * 1e3
        self.launches = {k: v for k, v in launch_counts().items() if v}
        if check is None:
            def check(result, launches):
                return launches == {k: v for k, v in want(result).items()
                                    if v}
        if not check(self.result, self.launches):
            raise AssertionError(f"generate {name}: launches "
                                 f"{self.launches}")


def generate_phase(dev, model) -> dict:
    """Phase ``generate``: the library decode family (``generate``,
    ``generate_cached``, ``beam_search_cached`` and both speculative
    loops) at the serve phase's widths.  Gates, in fp32 at the full width
    and 2 layers: every greedy arm gives ``generate_cached``'s tokens;
    with ``attention_window`` 256, the ring cache gives the uncached
    loop's (K1's window band).  Then the bf16 model of the serve phase at
    full depth: tokens/s, ms a step, prefill ms and peak memory of
    ``generate_cached``, a width-4 beam's ms a token, both speculative
    loops against ``generate_cached`` on repeated-phrase prompts, and the
    int8-weight / float8-cache arm's first divergence from bf16 (not
    gated).  Every arm's launches exact (K1 once a layer a prefill and an
    uncached step, K3 2L + 1 a prefill, step or chunk), but for the fp32
    host loop's fallback finish, whose steps its stats do not count.
    Returns the bf16 ``generate_cached`` arm's launches."""
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt

    t_phase = time.perf_counter()
    V = WIDTH["vocab_size"]
    rand, phrase = generate_prompts(V)
    B, P, N, K = GEN["batch"], GEN["prompt"], GEN["new"], GEN["spec_k"]

    def counts(L, passes, uncached=0):
        """K1 once a layer a prefill or uncached step, K3 2L + 1 each
        pass (the first of ``passes`` a prefill)."""
        return {"flash_attention_fwd": L * (1 if passes else 0)
                + L * uncached,
                "layer_norm_fwd": (2 * L + 1) * (passes + uncached)}

    def equal(name, got, want):
        if not torch.equal(got, want):
            where = [first_divergence(a, b)
                     for a, b in zip(got.tolist(), want.tolist())]
            raise AssertionError(f"generate {name}: tokens differ from "
                                 f"generate_cached's at {where}")

    # Gate 1: fp32, full width, 2 layers.
    f32 = fp32_model(dev)
    L = f32.cfg.num_layers
    cached = DecodeArm("fp32 cached", lambda: gpt.generate_cached(
        f32, None, rand, N), lambda r: counts(L, N)).result
    n = GEN["uncached"]
    uncached = DecodeArm("fp32 uncached", lambda: gpt.generate(
        f32, None, rand, n), lambda r: counts(L, 0, n)).result
    equal("fp32 uncached", uncached, cached[:, :P + n])
    beam1 = DecodeArm("fp32 beam 1", lambda: gpt.beam_search_cached(
        f32, None, rand, N, beam_size=1), lambda r: counts(L, N))
    equal("fp32 beam 1", beam1.result[0], cached)
    plain_phrase = gpt.generate_cached(f32, None, phrase, N)
    f_host = DecodeArm(
        "fp32 spec host", lambda: gpt.generate_cached_speculative(
            f32, None, phrase, N, spec_k=K),
        check=lambda r, got: (
            set(got) == {"flash_attention_fwd", "layer_norm_fwd"}
            and got["flash_attention_fwd"] == L
            and got["layer_norm_fwd"] % (2 * L + 1) == 0
            and got["layer_norm_fwd"] >= (2 * L + 1) * (1 + r[1]["rounds"])))
    equal("fp32 spec host", f_host.result[0], plain_phrase)
    f_dev = DecodeArm(
        "fp32 spec device", lambda: gpt.generate_cached_speculative_device(
            f32, None, phrase, N, spec_k=K),
        lambda r: counts(L, 1 + r[1]["rounds"]))
    equal("fp32 spec device", f_dev.result[0], plain_phrase)
    del f32

    # Gate 2: the window (ring cache against K1's window band).
    wmodel = gpt.GptLM(gpt.GptConfig(**{
        **WIDTH, "num_layers": 2, "dtype": "float32",
        "attention_window": GEN["window"]}), device=dev, seed=SEED)
    wp, wn = rand[:2, :GEN["window_prompt"]], GEN["window_new"]
    ring = DecodeArm("window cached", lambda: gpt.generate_cached(
        wmodel, None, wp, wn), lambda r: counts(2, wn)).result
    band = DecodeArm("window uncached", lambda: gpt.generate(
        wmodel, None, wp, wn), lambda r: counts(2, 0, wn)).result
    equal("window uncached", band, ring)
    del wmodel
    torch.cuda.empty_cache()

    # bf16 at full depth: the serve phase's model.
    L, N = model.cfg.num_layers, GEN["bf16_new"]
    gpt.generate_cached(model, None, rand[:, :32], 4)             # warm-up
    prompt = torch.as_tensor(rand, device=dev)
    caches = gpt.init_kv_cache(model.cfg, B, P + N, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(prompt, caches)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    del caches
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    main = DecodeArm("bf16 cached", lambda: gpt.generate_cached(
        model, None, rand, N), lambda r: counts(L, N))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = main.result
    if not (toks.shape == (B, P + N) and torch.equal(toks[:, :P], prompt)
            and int(toks.min()) >= 0 and int(toks.max()) < V):
        raise AssertionError("bf16 generate_cached: malformed tokens")
    nb = GEN["beam_new"]
    beam = DecodeArm("bf16 beam", lambda: gpt.beam_search_cached(
        model, None, rand[:1], nb, beam_size=GEN["beam"]),
        lambda r: counts(L, nb))
    if not torch.isfinite(beam.result[1]).all():
        raise AssertionError("bf16 beam: non-finite logprob")
    plain = DecodeArm("bf16 cached, phrase", lambda: gpt.generate_cached(
        model, None, phrase, N), lambda r: counts(L, N))
    # The host loop with the fallback off: every pass is the prefill or a
    # round's chunk, so its launches are exact.
    host = DecodeArm("bf16 spec host", lambda: gpt.generate_cached_speculative(
        model, None, phrase, N, spec_k=K, fallback_rounds=0),
        lambda r: counts(L, 1 + r[1]["rounds"]))
    dev_spec = DecodeArm(
        "bf16 spec device", lambda: gpt.generate_cached_speculative_device(
            model, None, phrase, N, spec_k=K),
        lambda r: counts(L, 1 + r[1]["rounds"]))
    spec = {name: dict(
        arm.result[1], ms=arm.ms, tokens_per_s=B * N / (arm.ms / 1e3),
        speedup_over_cached=plain.ms / arm.ms,
        rows_equal_cached=sum(a == b for a, b in zip(
            arm.result[0].tolist(), plain.result.tolist())),
        launches=arm.launches)
        for name, arm in (("host_no_fallback", host), ("device", dev_spec))}
    q8 = DecodeArm("bf16 int8 + float8", lambda: gpt.generate_cached(
        model, None, rand, N, quantize="int8", kv_dtype="float8"),
        lambda r: counts(L, N))
    emit("generate_profile", batch=B, prompt_tokens=P, new_tokens=16,
         **profile_window(lambda: gpt.generate_cached(model, None, rand,
                                                      16)))
    emit("generate", model="gpt_406m_width", batch=B, prompt_tokens=P,
         seconds=time.perf_counter() - t_phase,
         fp32_2_layers=dict(
             new_tokens=GEN["new"], uncached_new_tokens=GEN["uncached"],
             equal_to_generate_cached=[
                 "generate", "beam_search_cached(beam_size=1)",
                 "generate_cached_speculative",
                 "generate_cached_speculative_device"],
             spec_host=f_host.result[1], spec_device=f_dev.result[1]),
         window_gate=dict(attention_window=GEN["window"], batch=2,
                          prompt_tokens=GEN["window_prompt"],
                          new_tokens=wn, ring_cache_equal_to_band=True),
         new_tokens=N, generate_cached=dict(
             tokens_per_s=B * N / (main.ms / 1e3), wall_ms=main.ms,
             prefill_ms=prefill_ms,
             ms_per_step=(main.ms - prefill_ms) / (N - 1),
             peak_mem_gb=peak_gb, resident_before_gb=resident_gb,
             launches=main.launches),
         beam=dict(beam_size=GEN["beam"], batch=1, new_tokens=nb,
                   ms=beam.ms, ms_per_token=beam.ms / nb,
                   logprob=beam.result[1].tolist(), launches=beam.launches),
         phrase_generate_cached=dict(ms=plain.ms, tokens_per_s=B * N / (
             plain.ms / 1e3), launches=plain.launches),
         spec=spec, spec_k=K,
         int8_float8=dict(ms=q8.ms, tokens_per_s=B * N / (q8.ms / 1e3),
                          first_divergence_from_bf16=[
                              first_divergence(a[P:], b[P:]) for a, b in zip(
                                  q8.result.tolist(), toks.tolist())],
                          launches=q8.launches))
    return main.launches


class CliProcess:
    """A port CLI as a process of its own beside this one: its output
    drained by a thread, stopped (SIGTERM, then SIGKILL) on exit.
    ``ended``: the ``perf_counter`` time its output closed (its own end,
    when processes run side by side)."""

    def __init__(self, module: str, *args):
        root = os.path.dirname(os.path.abspath(__file__))
        # Unbuffered: a line reaches ``wait_for`` when the process prints
        # it (through a pipe Python would hold it until a block filled).
        env = dict(os.environ, PYTHONPATH=root, PYTHONUNBUFFERED="1")
        self.lines: queue.Queue = queue.Queue()
        self.seen: list = []
        self.ended = None
        self.proc = subprocess.Popen(
            [sys.executable, "-m", f"distributed_tensorflow_tpu_torch.{module}",
             *map(str, args)], cwd=root, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.ended = time.perf_counter()
        self.lines.put(None)

    def wait_for(self, prefix: str, timeout_s: float) -> str:
        """The first output line starting with ``prefix``."""
        deadline = time.perf_counter() + timeout_s
        while True:
            try:
                line = self.lines.get(
                    timeout=max(deadline - time.perf_counter(), 0.01))
            except queue.Empty:
                line = None
            if line is None:
                raise AssertionError(f"no {prefix!r} line from the CLI: "
                                     + "".join(self.seen[-30:]))
            self.seen.append(line)
            if line.startswith(prefix):
                return line

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def generate_clis(dev, logdir, runs) -> list:
    """``train.py --mode=generate`` as processes, one for each ``(prompt,
    flags)`` of ``runs``, all started together (each restores the same
    checkpoint): each one's generated tokens, wall seconds (from the
    common start to its own end) and output lines."""
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        procs = [stack.enter_context(CliProcess(
            "train", "--mode=generate", "--model=gpt_mini",
            f"--logdir={logdir}", f"--device={dev}",
            f"--gen_tokens={NEW_TOKENS}",
            "--gen_prompt=" + ",".join(map(str, prompt)), *flags))
            for prompt, flags in runs]
        outs = []
        for proc, (_, flags) in zip(procs, runs):
            lines = [x.rstrip("\n") for x in finish(proc, 600)]
            if "Restored global step: 2" not in lines:
                raise AssertionError(f"train --mode=generate {flags}: "
                                     + "\n".join(lines[-40:]))
            gen = line_value(lines, "Generated tokens:")
            outs.append(([int(t) for t in gen.split()], proc.ended - t0,
                         lines))
    return outs


def checkpoint_phase(dev, smi: str, model, whole: dict) -> dict:
    """Phase ``checkpoint``: from a checkpoint on disk to tokens.  The
    serve phase's model is saved as the JAX trainer saves (``save_raw`` of
    ``{params, global_step}``, fp32 arrays, step 1), served by the serving
    CLI as a process (``--hot_swap``), which gets the serve phase's 8
    requests (gate: the greedy ones' tokens equal the serve phase's
    in-process engine's); step 2 (seed-1 weights) is saved while a long
    request streams (gates: the stream runs to its budget, the swap to
    step 2 shows in ``/statz``, a request after it gets the tokens of an
    engine on the step-2 weights in memory).  In this process, the
    restore recipe (``load_gpt_serving_model``) and an engine on the
    restored tree: the in-memory engine's tokens, K1 8 a prefill, K3 17 a
    prefill or step.  Then ``train.py --mode=generate``, greedy, beam 4
    and speculative 8, each as a process: the in-process decode family's
    tokens on the step-2 weights.  Returns the in-process run's
    launches."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.serving.client import ServeClient
    from distributed_tensorflow_tpu_torch.serving.engine import (
        DecodeEngine, EngineConfig)
    from distributed_tensorflow_tpu_torch.serving.scheduler import Request
    from distributed_tensorflow_tpu_torch.tools import checkpoint_io
    from distributed_tensorflow_tpu_torch.tools.export_model import (
        clear_restore_memo)
    from distributed_tensorflow_tpu_torch.tools.serve import (
        load_gpt_serving_model)

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_checkpoint_")
    run_dir = os.path.join(tmp, "gpt_mini")
    ckpt_dir = os.path.join(run_dir, "checkpoints")

    def save(m, step) -> dict:
        """``save_raw`` of ``m``'s weights as step ``step``: the data
        written and renamed into place (``visible_unix``), then the
        manifest's CRC pass (``manifest_unix``)."""
        t0 = time.perf_counter()
        tree = {"params": gpt.params_to_jax(m.state_dict()),
                "global_step": np.asarray(step, np.int32)}
        to_host_s = time.perf_counter() - t0
        gb = 4 * sum(t.numel() for t in m.state_dict().values()) / 1e9
        started = time.time()
        step_dir = checkpoint_io.save_raw(ckpt_dir, step, tree)
        # The rename is the last change to the checkpoints directory.
        visible = os.path.getmtime(ckpt_dir)
        manifest = os.path.getmtime(os.path.join(
            step_dir, checkpoint_io.MANIFEST_NAME))
        return dict(gb=gb, to_host_s=to_host_s, write_s=visible - started,
                    write_gb_per_s=gb / (visible - started),
                    manifest_s=manifest - visible, step_dir=step_dir,
                    visible_unix=visible, manifest_unix=manifest)

    def verify(saved) -> None:
        t0 = time.perf_counter()
        verdict = checkpoint_io.verify_checkpoint(saved.pop("step_dir"))
        if verdict[0] != "valid":
            raise AssertionError(f"{verdict}")
        saved.update(verify=verdict[1],
                     verify_s=time.perf_counter() - t0)

    def engine_run(m, params, prompt) -> tuple[list, dict, int]:
        """One greedy request alone through an engine stepped here: its
        tokens, the launches and the engine steps."""
        engine = DecodeEngine(m, params, EngineConfig(**ENGINE), device=dev)
        req = Request(prompt, NEW_TOKENS)
        reset_launch_counts()
        engine.admit(req)
        while engine.active_slots:
            engine.step()
        torch.cuda.synchronize()
        return (req.tokens, {k: v for k, v in launch_counts().items() if v},
                engine.step_index)

    try:
        saved1 = save(model, 1)
        verify(saved1)
        prompts, served = whole["prompts"], whole["results"]
        metrics = os.path.join(tmp, "serve.jsonl")
        with CliProcess(
                "tools.serve", "--logdir", run_dir, "--port", 0,
                "--device", dev, "--hot_swap", "--swap_poll_s", 0.2,
                "--slots", ENGINE["num_slots"],
                "--page_size", ENGINE["page_size"],
                "--num_pages", ENGINE["num_pages"],
                "--max_pages_per_seq", ENGINE["max_pages_per_seq"],
                "--tenants", "search:1,ads:1",
                "--metrics_file", metrics) as cli:
            t0 = time.perf_counter()
            banner = cli.wait_for("serving gpt_mini ", 600)
            startup_s = time.perf_counter() - t0
            port = int(banner.split(" on :")[1].split(" ")[0])
            client = ServeClient(f"http://127.0.0.1:{port}",
                                 timeout_s=600.0)
            client.generate(prompts[0][:16], 4)             # warm-up
            done, burst_s = burst(client, prompts, mixed_kw)
            same = [a["tokens"] == b["tokens"]
                    for a, b in zip(done, served)]
            greedy = [i for i in range(len(prompts)) if "seed" not in
                      mixed_kw(i)]
            if not all(same[i] for i in greedy):
                raise AssertionError(
                    "CLI greedy tokens differ from the in-process "
                    "engine's: " + str([first_divergence(
                        done[i]["tokens"], served[i]["tokens"])
                        for i in greedy]))

            # The hot swap: step 2 saved while a long request streams.
            long_new = 900
            streamed: dict = {}
            stream = threading.Thread(target=lambda: streamed.update(
                r=client.generate(prompts[0], long_new, tenant="search")))
            stream.start()
            while client.stats()["engine"]["active_slots"] < 1:
                time.sleep(0.01)
            model2 = gpt.GptLM(gpt.GptConfig(**WIDTH), device=dev,
                               seed=SEED + 1)
            saved2 = save(model2, 2)
            deadline = time.perf_counter() + 300
            while client.stats()["engine"]["model_step"] != 2:
                if time.perf_counter() > deadline:
                    raise AssertionError("the hot swap never landed")
                time.sleep(0.01)
            seen_s = time.time() - saved2["visible_unix"]
            verify(saved2)
            stream.join(timeout=600)
            if stream.is_alive() or streamed["r"]["tokens_out"] != long_new:
                raise AssertionError("the stream across the swap did not "
                                     "run to its budget")
            after = client.generate(prompts[2], NEW_TOKENS, tenant="search")
            stats = client.stats()["engine"]
        if cli.proc.returncode != 0:
            raise AssertionError(f"serve CLI exited {cli.proc.returncode}")
        want2, _ = engine_tokens(dev, model2, [prompts[2]])
        if not (after["model_step"] == 2 and stats["swaps"] == 1
                and after["tokens"][len(prompts[2]):] == want2[0]):
            raise AssertionError("after the swap: not the step-2 tokens")
        with open(metrics) as fh:
            records = [json.loads(x) for x in fh]
        (swap,) = [r for r in records if r.get("kind") == "model_swap"]
        spans = {r["name"]: r for r in records if r.get("kind") == "span"
                 and r.get("name") in ("serve.swap", "serve.swap_load")}
        adopted = spans["serve.swap"]["t_unix"] + spans[
            "serve.swap"]["dur_ms"] / 1e3

        # In process: the restore recipe, and launches on the restored
        # model (the 777-token prompt: K1 and K3 at the serve cases'
        # 784-row prefill bucket).
        clear_restore_memo()
        t0 = time.perf_counter()
        cfg, tree, step = load_gpt_serving_model(run_dir, 1)
        restore_s = time.perf_counter() - t0
        restored = gpt.GptLM(cfg, device=dev)
        params = gpt.params_from_jax(tree)
        del tree
        clear_restore_memo()
        want, want_launches, want_steps = engine_run(model, None, prompts[1])
        got, launches, steps = engine_run(restored, params, prompts[1])
        L = cfg.num_layers
        exact = {"flash_attention_fwd": L,
                 "layer_norm_fwd": (2 * L + 1) * (1 + steps)}
        if not (step == 1 and got == want and launches == exact
                and want_launches == exact and steps == want_steps):
            raise AssertionError(f"restored engine: tokens equal "
                                 f"{got == want}, launches {launches} (want "
                                 f"{exact}), in memory {want_launches}")
        del restored, params

        # train.py --mode=generate, against the decode family in process
        # on the step-2 weights; the three processes run side by side
        # (``wall_s``: from the common start to each one's own end).
        rand, phrase = generate_prompts(WIDTH["vocab_size"])
        arms = {}
        runs = (("greedy", rand[0], (), lambda p: gpt.generate_cached(
                    model2, None, p, NEW_TOKENS)),
                ("beam_4", rand[0], ("--gen_beams=4",),
                 lambda p: gpt.beam_search_cached(
                     model2, None, p, NEW_TOKENS, beam_size=4)[0]),
                ("speculative_8", phrase[0], ("--gen_speculative=8",),
                 lambda p: gpt.generate_cached_speculative_device(
                     model2, None, p, NEW_TOKENS, spec_k=8)[0]))
        outs = generate_clis(dev, tmp, [(prompt.tolist(), flags)
                                        for _, prompt, flags, _ in runs])
        for (name, prompt, _, ref), (toks, seconds, lines) in zip(runs,
                                                                   outs):
            want = ref(prompt[None]).cpu()[0, prompt.size:].tolist()
            if toks != want:
                raise AssertionError(f"train --mode=generate {name}: first "
                                     f"divergence {first_divergence(toks, want)}")
            arms[name] = dict(wall_s=seconds, tokens_equal_in_process=True,
                              line=[x for x in lines if x.startswith(
                                  ("Beam search", "Speculative decode"))])
        del model2
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("checkpoint", card=smi, model="gpt_406m_width",
         seconds=time.perf_counter() - t_phase,
         save_step1=saved1, save_step2=saved2,
         restore_in_process=dict(step=1, seconds=restore_s,
                                 gb_per_s=saved1["gb"] / restore_s),
         serve_cli=dict(startup_s=startup_s, requests=len(done),
                        **burst_numbers(done, burst_s),
                        greedy_equal_in_process=len(greedy),
                        sampled_equal_in_process=sum(
                            same[i] for i in range(len(done))
                            if i not in greedy)),
         hot_swap=dict(stream_new_tokens=long_new,
                       in_flight_at_swap=swap["in_flight"],
                       visible_to_adopted_s=adopted - saved2["visible_unix"],
                       adopted_before_manifest=adopted < saved2[
                           "manifest_unix"],
                       visible_to_statz_s=seen_s,
                       load_ms=spans["serve.swap_load"]["dur_ms"],
                       adopt_ms=spans["serve.swap"]["dur_ms"],
                       after_swap_tokens_equal_step2=True),
         restored_engine=dict(prompt_tokens=len(prompts[1]),
                              new_tokens=NEW_TOKENS, steps=steps,
                              tokens_equal_in_memory=True,
                              launches=launches),
         train_generate=arms)
    return launches


# The fleet phase: the serve phase's model as a checkpoint served by
# tools/serve_fleet.py (each replica a tools/serve.py process on the
# card) and by two tools/serve_cell.py cells behind a global router.
FLEET = dict(replicas=2, poll_s=0.5, fail_after=2, tenants="search:2,ads:1",
             autoscale_max=3, burn_sustain_s=2.0, cooldown_s=5.0,
             # An objective every request of the tenant "probe" breaks, in
             # 5 s / 30 s windows: the autoscaler's burn, as
             # tests/test_router.py:749 induces it (the serving tenants
             # carry no objective, so nothing burns before the probe).
             burn_slo="probe:ttft_p95_ms<=1", slo_short_window_s=5.0,
             slo_long_window_s=30.0, slo_emit_every_s=0.5,
             kill_burst=16,
             # The two-cell drill: tests/test_cells.py:524's objectives,
             # schedule and kill, at a 128-token prompt and 16 new tokens.
             cell_slo="search:e2e_p95_ms<=60000,ads:e2e_p95_ms<=60000",
             cell_schedule=dict(duration_s=14.0, qps=2.0, seed=7,
                                prompt_len=128, gen_len=16),
             kill_at_s=4.0, rehome_bound=8, rehome_window_s=30.0)


def engine_flags() -> list:
    """``ENGINE``'s pool as the serving CLIs' flags."""
    return ["--slots", ENGINE["num_slots"], "--page_size",
            ENGINE["page_size"], "--num_pages", ENGINE["num_pages"],
            "--max_pages_per_seq", ENGINE["max_pages_per_seq"]]


class FleetWatch:
    """A router's ``/fleetz`` polled every 0.1 s from a thread: the
    newest snapshot, and the first ``time.time()`` each member was seen
    in each state."""

    def __init__(self, url: str):
        from distributed_tensorflow_tpu_torch.serving.client import (
            ServeClient)
        self.client = ServeClient(url, timeout_s=5.0, retries=0)
        self.snap: dict | None = None
        self.seen: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def _poll(self):
        while not self._stop.is_set():
            try:
                snap = self.client.fleetz()
            except Exception:  # noqa: BLE001 — the next poll retries
                snap = None
            if snap is not None:
                now = time.time()
                for m in snap["members"]:
                    self.seen.setdefault((m["id"], m["state"]), now)
                self.snap = snap
            self._stop.wait(0.1)

    def wait(self, pred, timeout_s: float, what: str) -> dict:
        deadline = time.time() + timeout_s
        while True:
            snap = self.snap
            if snap is not None and pred(snap):
                return snap
            if time.time() > deadline:
                raise AssertionError(f"{what}: not within {timeout_s} s: "
                                     f"{snap and snap['router']}")
            time.sleep(0.05)

    def close(self):
        self._stop.set()
        self._thread.join()


def members(snap) -> dict:
    return {m["id"]: m for m in snap["members"]}


def replica_launches(log_dir: str) -> dict:
    """Each replica's ``kernel launches`` line (printed on its clean
    exit) from the ``replica-<id>.log`` files in ``log_dir``."""
    out = {}
    for name in sorted(os.listdir(log_dir)):
        if name.startswith("replica-") and name.endswith(".log"):
            with open(os.path.join(log_dir, name)) as fh:
                lines = [x for x in fh if x.startswith("kernel launches ")]
            if lines:
                out[name[len("replica-"):-len(".log")]] = json.loads(
                    lines[-1][len("kernel launches "):])
    return out


def check_replica_launches(where: str, launches: dict, served: dict,
                           num_layers: int) -> None:
    """Gate: every replica that served a request exited cleanly with K1
    a positive multiple of the layers (one a layer a prefill), K3 a
    positive multiple of 2 a layer + 1 (a prefill or a decode step), and
    no other kernel."""
    k3 = 2 * num_layers + 1
    for rid, n in served.items():
        if not n:
            continue
        got = launches.get(rid)
        if got is None:
            raise AssertionError(f"{where} {rid} served {n} requests and "
                                 "printed no launch line")
        k1, ln = got["flash_attention_fwd"], got["layer_norm_fwd"]
        other = {k: v for k, v in got.items() if v and k not in (
            "flash_attention_fwd", "layer_norm_fwd")}
        if not (k1 > 0 and k1 % num_layers == 0 and ln > 0 and ln % k3 == 0
                and not other):
            raise AssertionError(f"{where} {rid}: launches {got}")


def fleet_stream(path: str) -> tuple[list, dict]:
    """A router's or global router's telemetry: its records, and the
    ``summarize_run --check`` verdict on it (gate: exit 0)."""
    from distributed_tensorflow_tpu_torch.tools import summarize_run
    if summarize_run.main([path, "--check"]) != 0:
        raise AssertionError(f"summarize_run --check failed on {path}")
    records, errors = summarize_run.load_records(path)
    return records, summarize_run.build_summary(records)


def fleet_drill(dev, run_dir: str, tmp: str, prompts, want) -> dict:
    """``fleet_serve``, ``fleet_kill`` and ``fleet_autoscale`` on one
    ``serve_fleet``, then the prompts once more from a tenant each, spread
    over the three live members: the numbers, each replica's launches and
    served requests."""
    from distributed_tensorflow_tpu_torch.serving.client import ServeClient
    F = FLEET
    metrics = os.path.join(tmp, "fleet.jsonl")
    state = os.path.join(tmp, "fleet.json")
    log_dir = os.path.join(tmp, "fleet")
    root = os.path.dirname(os.path.abspath(__file__))
    seconds = {}
    t_part = time.perf_counter()
    with CliProcess(
            "tools.serve_fleet", "--logdir", run_dir, "--port", 0,
            "--device", dev, "--replicas", F["replicas"], *engine_flags(),
            "--tenants", F["tenants"], "--respawn", "--poll_s", F["poll_s"],
            "--fail_after", F["fail_after"],
            "--autoscale_min", F["replicas"],
            "--autoscale_max", F["autoscale_max"],
            "--burn_sustain_s", F["burn_sustain_s"],
            "--cooldown_s", F["cooldown_s"], "--idle_sustain_s", 1e9,
            "--slo", F["burn_slo"],
            "--slo_short_window_s", F["slo_short_window_s"],
            "--slo_long_window_s", F["slo_long_window_s"],
            "--slo_emit_every_s", F["slo_emit_every_s"],
            "--metrics_file", metrics, "--state_file", state,
            "--fleet_dir", log_dir) as cli:
        banner = cli.wait_for("routing fleet on :", 120)
        t_spawn = time.time()
        url = f"http://127.0.0.1:{int(banner.split(' on :')[1].split()[0])}"
        client = ServeClient(url, timeout_s=600.0, retries=3)
        watch = FleetWatch(url)
        try:
            # fleet_serve: the serve phase's 8 prompts, greedy, tenants
            # alternating, each traced (route.fleet spans by trace id).
            watch.wait(lambda s: s["router"]["healthy"] >= 2, 300,
                       "two healthy replicas")
            first = [watch.seen[(r, "healthy")] - t_spawn
                     for r in ("r0", "r1")]
            done, serve_s = burst(client, prompts, lambda i: dict(
                tenant=("search", "ads")[i % 2], trace=f"serve-{i}"))
            for i, r in enumerate(done):
                if r["tokens"][len(prompts[i]):] != want[i]:
                    raise AssertionError(
                        f"fleet request {i}: not the in-process engine's "
                        f"tokens (first divergence {first_divergence(r['tokens'][len(prompts[i]):], want[i])})")
            out = subprocess.run(
                [sys.executable, "-m",
                 "distributed_tensorflow_tpu_torch.tools.watch_serve",
                 "--fleet", "--url", url, "--once", "--json"], cwd=root,
                env=dict(os.environ, PYTHONPATH=root), capture_output=True,
                text=True, timeout=60)
            watched = json.loads(out.stdout) if out.returncode == 0 else {}
            healthy = [m["id"] for m in watched.get("members", ())
                       if m["state"] == "healthy"]
            if len(healthy) != 2:
                raise AssertionError(f"watch_serve --fleet: {out.returncode}"
                                     f" {healthy} {out.stderr[-2000:]}")
            seconds["fleet_serve"] = time.perf_counter() - t_part

            # fleet_kill: 16 concurrent requests (the prompts twice), r1
            # SIGKILLed once half have completed.
            t_part = time.perf_counter()
            with open(state) as fh:
                pids = {m["id"]: m["pid"] for m in json.load(fh)["members"]}
            n = F["kill_burst"]
            results: list = [None] * n
            errors: list = []
            half = threading.Event()

            def call(i):
                try:
                    results[i] = client.generate(
                        prompts[i % len(prompts)], NEW_TOKENS,
                        tenant=("search", "ads")[i % 2], trace=f"kill-{i}")
                except Exception as e:  # noqa: BLE001 — the gate's target
                    errors.append((i, repr(e)))
                if sum(r is not None for r in results) + len(errors) \
                        >= n // 2:
                    half.set()
            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(n)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            if not half.wait(600):
                raise AssertionError("half the kill burst never completed")
            t_kill = time.time()
            os.kill(pids["r1"], signal.SIGKILL)
            for t in threads:
                t.join(600)
            kill_burst_s = time.perf_counter() - t0
            if errors or any(r is None for r in results):
                raise AssertionError(f"failed requests through the kill: "
                                     f"{errors}")
            for i, r in enumerate(results):
                if r["tokens_out"] != NEW_TOKENS or r["tokens"][
                        len(prompts[i % len(prompts)]):] != want[
                        i % len(prompts)]:
                    raise AssertionError(f"kill burst request {i}: "
                                         f"{r['tokens_out']} tokens, not "
                                         "the in-process engine's")
            snap = watch.wait(lambda s: members(s)["r1"]["state"] == "dead",
                              30, "r1 marked dead")
            dead_s = watch.seen[("r1", "dead")] - t_kill
            for tenant in ("search", "ads"):     # the survivor serves both
                r = client.generate(prompts[0][:16], 4, tenant=tenant)
                if r["tokens_out"] != 4:
                    raise AssertionError(f"after the kill: {tenant} {r}")
            snap = watch.wait(lambda s: any(
                m["state"] == "healthy" and m["id"] not in ("r0", "r1")
                for m in s["members"]), 300, "a respawned member healthy")
            (respawned,) = [m for m in members(snap) if m not in ("r0", "r1")]
            respawn_s = (watch.seen[(respawned, "healthy")]
                         - watch.seen[(respawned, "starting")])
            failovers = snap["router"]["failovers"]
            if snap["router"]["failed"]:
                raise AssertionError(f"fleet failed {snap['router']}")
            seconds["fleet_kill"] = time.perf_counter() - t_part

            # fleet_autoscale: the probe tenant's burn until a third
            # member is healthy.
            t_part = time.perf_counter()
            stop_burn = threading.Event()

            def burn():
                while not stop_burn.is_set():
                    try:
                        client.generate(prompts[0][:16], 4, tenant="probe")
                    except Exception:  # noqa: BLE001 — keep burning
                        time.sleep(0.2)
            burner = threading.Thread(target=burn)
            t_burn = time.time()
            burner.start()
            try:
                snap = watch.wait(lambda s: s["router"]["healthy"] >= 3, 300,
                                  "the autoscaled member healthy")
            finally:
                stop_burn.set()
                burner.join(600)
            (scaled,) = [m for m in members(snap)
                         if m not in ("r0", "r1", respawned)]
            up_s = watch.seen[(scaled, "starting")] - t_burn
            up_healthy_s = (watch.seen[(scaled, "healthy")]
                            - watch.seen[(scaled, "starting")])
            # The prompts again, each from a tenant of its own: the
            # least-loaded choice spreads them over the three members,
            # the respawned and the autoscaled one included.
            spread, _ = burst(client, prompts,
                              lambda i: dict(tenant=f"spread{i}"))
            final = client.fleetz()
            for i, r in enumerate(spread):
                if r["tokens"][len(prompts[i]):] != want[i]:
                    raise AssertionError(f"spread request {i}: not the "
                                         "in-process engine's tokens")
            seconds["fleet_autoscale"] = time.perf_counter() - t_part
        finally:
            watch.close()
    t_part = time.perf_counter()
    if cli.proc.returncode != 0:
        raise AssertionError(f"serve_fleet exited {cli.proc.returncode}")
    records, summary = fleet_stream(metrics)
    (worker,) = summary["workers"].values()
    fleet = worker["fleet"]
    actions = fleet["actions"]
    if not (actions.get("replica_dead", 0) >= 1 and fleet["failed"] == 0
            and actions.get("scale_up", 0) == 1
            and actions.get("respawn", 0) >= 1):
        raise AssertionError(f"router stream: {fleet}")
    # The router's added latency: a request's route.fleet span (the wall
    # its kind="route" record's route_ms holds) less the replica's e2e
    # (ttft + tpot x (tokens - 1), submit to done), for the requests
    # that needed no failover.
    spans = {r["trace_id"]: r for r in records if r.get("kind") == "span"
             and r.get("name") == "route.fleet"}
    traced = [(f"serve-{i}", r) for i, r in enumerate(done)] + [
        (f"kill-{i}", r) for i, r in enumerate(results)]
    added = [spans[t]["dur_ms"] - (r["ttft_ms"] + r["tpot_ms"] * (
        r["tokens_out"] - 1)) for t, r in traced
        if t in spans and spans[t]["failovers"] == 0]
    # The replicas still in the fleet at its SIGTERM (r1 was SIGKILLed).
    served = {m["id"]: m["served"] for m in final["members"]
              if m["state"] != "dead"}
    launches = replica_launches(log_dir)
    seconds["fleet_stop"] = time.perf_counter() - t_part
    return dict(
        spawn_to_healthy_s={"r0": first[0], "r1": first[1],
                            respawned: respawn_s, scaled: up_healthy_s},
        router_added_ms=dict(p50=statistics.median(added),
                             p95=statistics.quantiles(added, n=20)[-1],
                             requests=len(added)),
        serve_burst=dict(requests=len(done), burst_s=serve_s,
                         tokens_per_s=len(done) * NEW_TOKENS / serve_s),
        kill_burst=dict(requests=n, failed=0, burst_s=kill_burst_s,
                        tokens_per_s=n * NEW_TOKENS / kill_burst_s,
                        kill_to_dead_s=dead_s, failovers=failovers,
                        respawned=respawned,
                        respawn_to_healthy_s=respawn_s),
        autoscale=dict(burn_to_up_s=up_s, up_to_healthy_s=up_healthy_s,
                       member=scaled, scale_up_actions=actions["scale_up"]),
        router=dict(routed=fleet["routed"], failed=fleet["failed"],
                    actions=actions),
        watch_serve_healthy=healthy, served=served, launches=launches,
        seconds=seconds)


def cells_drill(dev, run_dir: str, tmp: str) -> dict:
    """``cells_drill``: two one-replica cells and a global router; loadgen's
    ``cell_kill`` SIGKILLs cell a wholesale at 4 s."""
    from distributed_tensorflow_tpu_torch.serving.client import ServeClient
    from distributed_tensorflow_tpu_torch.tools import loadgen, summarize_run
    from distributed_tensorflow_tpu_torch.utils import faults
    F = FLEET
    states = {c: os.path.join(tmp, f"cell_{c}.json") for c in "ab"}
    gstream = os.path.join(tmp, "global.jsonl")
    gstate = os.path.join(tmp, "global.json")
    with contextlib.ExitStack() as stack:
        t0 = time.time()
        cells = {c: stack.enter_context(CliProcess(
            "tools.serve_cell", "--cell", c, "--logdir", run_dir,
            "--replicas", 1, "--device", dev, *engine_flags(),
            "--tenants", F["tenants"], "--poll_s", F["poll_s"],
            "--fail_after", F["fail_after"], "--slo", F["cell_slo"],
            "--metrics_file", os.path.join(tmp, f"cell_{c}.jsonl"),
            "--state_file", states[c],
            "--cell_dir", os.path.join(tmp, f"cell_{c}"))) for c in "ab"}
        urls = {}
        for c, cli in cells.items():
            cli.wait_for(f"serving cell {c} on :", 120)
            with open(states[c]) as fh:
                urls[c] = json.load(fh)["router_url"]
        healthy_s = {}
        for c, url in urls.items():
            probe = ServeClient(url, timeout_s=10.0, retries=0)
            deadline = time.time() + 300
            while True:
                try:
                    if probe.fleetz()["router"]["healthy"] >= 1:
                        break
                except Exception:  # noqa: BLE001 — still booting
                    pass
                if time.time() > deadline:
                    raise AssertionError(f"cell {c} never became healthy")
                time.sleep(0.1)
            healthy_s[c] = time.time() - t0
        glob = stack.enter_context(CliProcess(
            "tools.serve_cell", "--cell_state",
            f"{states['a']},{states['b']}", "--poll_s", F["poll_s"],
            "--fail_after", F["fail_after"],
            "--rehome_bound", F["rehome_bound"],
            "--rehome_window_s", F["rehome_window_s"],
            "--metrics_file", gstream, "--state_file", gstate))
        glob.wait_for("routing 2 cell(s) on :", 120)
        with open(gstate) as fh:
            gurl = json.load(fh)["router_url"]
        probe = ServeClient(gurl, timeout_s=60.0)
        deadline = time.time() + 60
        while True:
            try:
                if probe.cellz()["global"]["healthy_cells"] == 2:
                    break
            except Exception:  # noqa: BLE001 — still adopting the cells
                pass
            if time.time() > deadline:
                raise AssertionError("the global router never saw 2 "
                                     "healthy cells")
            time.sleep(0.1)
        for tenant in ("search", "ads"):         # pin the tenants' homes
            probe.generate([1, 2, 3], 2, tenant=tenant)
        schedule = loadgen.build_schedule("cell_kill",
                                          **F["cell_schedule"])
        report = loadgen.run_schedule(
            gurl, schedule, slo=F["cell_slo"], timeout_s=60.0,
            kill_at_s=F["kill_at_s"], scenario="cell_kill",
            kill_fn=lambda: faults.kill_cell(states["a"], "a"))
        if report["failed"] or not report["ok"] \
                or report["ever_burning"] != []:
            raise AssertionError(f"cell_kill: {report}")
        snap = ServeClient(urls["b"], timeout_s=10.0).fleetz()
        for m in snap["members"]:
            slo = (m.get("statz") or {}).get("slo") or {}
            if slo.get("ever_burning", []) != []:
                raise AssertionError(f"cell b burned: {m}")
        served = {m["id"]: m["served"] for m in snap["members"]}
    records, _ = fleet_stream(gstream)
    section = summarize_run.cell_summary(records)
    if not (section.get("cell_deaths", 0) >= 1
            and section.get("rehomes", 0) >= 1):
        raise AssertionError(f"global stream: {section}")
    return dict(
        spawn_to_healthy_s=healthy_s,
        loadgen={k: report[k] for k in ("requests", "ok", "rejected",
                                        "failed", "ever_burning")
                 if k in report},
        failover_gap_ms=section.get("failover_gap_ms_max"),
        failover_gaps=section.get("failover_gaps"),
        rehomes=section["rehomes"], rejected_429=report["rejected"],
        throttle_rejects=section.get("throttle_rejects"),
        actions=section.get("actions"), served=served,
        launches=replica_launches(os.path.join(tmp, "cell_b")))


def fleet_phase(dev, smi: str, model, whole: dict,
                timed_beside=()) -> dict:
    """Phase ``fleet``: the serving fleet tier at the serve phase's width.
    ``save_raw`` writes the model as the ``checkpoint`` phase does; the
    fleet's two replicas give the in-process engine's greedy tokens,
    survive a replica's SIGKILL with no failed request (respawn), and
    scale up on a burning objective; two cells survive a cell's SIGKILL
    behind the global router.  ``timed_beside``: the lines of the phases
    that run beside it (its times are then contended).  Returns the
    replicas' summed launches."""
    import numpy as np
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.tools import checkpoint_io

    t_phase = t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    run_dir = os.path.join(tmp, "gpt_mini")
    try:
        checkpoint_io.save_raw(
            os.path.join(run_dir, "checkpoints"), 1,
            {"params": gpt.params_to_jax(model.state_dict()),
             "global_step": np.asarray(1, np.int32)})
        prompts = whole["prompts"]
        want, _ = engine_tokens(dev, model, prompts)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fleet = fleet_drill(dev, run_dir, tmp, prompts, want)
        t1 = time.perf_counter()
        cells = cells_drill(dev, run_dir, tmp)
        cells_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    L = WIDTH["num_layers"]
    check_replica_launches("fleet", fleet["launches"], fleet["served"], L)
    check_replica_launches("cell b", cells["launches"], cells["served"], L)
    total: dict = {}
    for counts in [*fleet["launches"].values(),
                   *cells["launches"].values()]:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    emit("fleet", card=smi, model="gpt_406m_width",
         timed_beside=list(timed_beside),
         seconds=time.perf_counter() - t_phase,
         seconds_by_part=dict(setup=setup_s, **fleet.pop("seconds"),
                              cells_drill=cells_s),
         fleet_tokens_per_s=fleet["kill_burst"]["tokens_per_s"],
         serve_tokens_per_s=whole["tokens_per_s"],
         tokens_equal_in_process=len(whole["prompts"]),
         **fleet, cells=cells, launches_total=total)
    return total


def gpt_train_flops(cfg, B: int, S: int) -> float:
    """bench.py:523-531's analytic matmul flops of one train step (3x the
    forward: dense layers, attention scores and values, LM head)."""
    H, L, I, V = (cfg.hidden_size, cfg.num_layers, cfg.intermediate_size,
                  cfg.vocab_size)
    per_layer = (2 * B * S * H * 3 * H + 2 * B * S * H * H
                 + 2 * 2 * B * S * S * H + 2 * 2 * B * S * H * I)
    return 3 * (L * per_layer + 2 * B * S * H * V)


def step_grads(model, loss_fn, batch, ctx=None):
    """One step's loss and flattened fp32 gradients of ``model`` (under
    ``ctx``) in parameter-name order, a parameter split over the model
    axis gathered whole, leaving no gradient behind."""
    import contextlib
    import torch
    from distributed_tensorflow_tpu_torch.parallel.sharding import (
        gather_named)
    model.train()
    model.zero_grad(set_to_none=True)
    with ctx or contextlib.nullcontext():
        loss, _ = loss_fn(model, batch)
        loss.backward()
    grads = gather_named(model, {n: p.grad for n, p in
                                 model.named_parameters()})
    grads = torch.cat([g.float().flatten().to(loss.device)
                       for _, g in sorted(grads.items())])
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def compare_steps(a, b, tols, names=("kernel", "plain")) -> dict:
    """Two steps' (loss, gradients), ``a`` the kernels' and ``b`` the one
    it is held to, within (loss, relative grad norm, min cosine)
    tolerances; the dict names them by ``names``."""
    (la, ga), (lb, gb) = a, b
    # Float64 sums a chunk at a time: an fp32 dot product of 406M terms
    # on the CPU can read a cosine above 1.
    dot = na2 = nb2 = 0.0
    for x, y in zip(ga.split(1 << 24), gb.split(1 << 24)):
        x, y = x.double(), y.to(x.device).double()
        dot += (x @ y).item()
        na2 += (x @ x).item()
        nb2 += (y @ y).item()
    na, nb = math.sqrt(na2), math.sqrt(nb2)
    out = {f"loss_{names[0]}": la, f"loss_{names[1]}": lb,
           "loss_diff": abs(la - lb), f"grad_norm_{names[0]}": na,
           f"grad_norm_{names[1]}": nb,
           "grad_norm_rel_diff": abs(na - nb) / nb,
           "grad_cos": dot / (na * nb)}
    loss_tol, norm_rtol, min_cos = tols
    if not (math.isfinite(la) and math.isfinite(lb)
            and out["loss_diff"] <= loss_tol
            and out["grad_norm_rel_diff"] <= norm_rtol
            and out["grad_cos"] >= min_cos):
        raise AssertionError(f"train step, {names[0]} vs {names[1]}: {out}")
    return out


def check_train_step(dev, model, loss_fn, batch, tols):
    """One step's loss and gradients through the kernels against the plain
    path (dense attention, plain LayerNorm and, for ``matmul_int8``, the
    plain versions of K4/K5) with the same weights and batch.  ``tols``:
    (loss, relative grad norm, min cosine)."""
    import contextlib
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    from distributed_tensorflow_tpu_torch.ops import quant_train as qt

    @contextlib.contextmanager
    def plain_versions():
        """The int8 MLP through the plain versions of K4/K5, for this
        comparison only (the wrappers launch the kernels on the card)."""
        saved = qt.quantized_matmul, qt.quantized_matmul_nt
        qt.quantized_matmul = qmm.quantized_matmul_reference
        qt.quantized_matmul_nt = qmm.quantized_matmul_nt_reference
        try:
            yield
        finally:
            qt.quantized_matmul, qt.quantized_matmul_nt = saved

    plain = gpt.GptLM(dataclasses.replace(
        model.cfg, attention_backend="xla", fused_ln=False), device=dev,
        param_dtype=torch.float32)
    plain.load_state_dict(model.state_dict())
    kernel = step_grads(model, loss_fn, batch)
    plain_step = step_grads(plain, loss_fn, batch, plain_versions()
                            if plain.cfg.matmul_int8 else None)
    del plain
    loss_tol, norm_rtol, min_cos = tols
    out = dict(batch=len(batch["tokens"]),
               **compare_steps(kernel, plain_step, tols),
               loss_tol=loss_tol, grad_norm_rtol=norm_rtol,
               grad_min_cos=min_cos)
    del kernel, plain_step
    torch.cuda.empty_cache()
    return out


def profile_train_step(step, state, batch, named=None) -> dict:
    """``torch.profiler`` over one train step: the card's busy share of
    the step (the sum of its kernels' times over the step's wall time),
    the kernels that take most of it, and the operators they ran under
    (an operator's device time is that of the kernels it launched, and a
    user annotation such as the optimizer step spans kernels on the
    device's timeline too: only the kernels are summed).  ``named``:
    {label: substring}, each label's device ms and calls over the kernels
    and operators whose name holds the substring."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels, ops = [], []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            row = (e.key, us / 1e3, e.count)
            kernel = (e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False))
            (kernels if kernel else ops).append(row)
    kernels.sort(key=lambda r: -r[1])
    ops.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in kernels)
    out = dict(window_ms=window_ms, device_busy_ms=busy_ms,
               busy_share=busy_ms / window_ms if kernels else None,
               top_kernels=[[k[:60], ms, n] for k, ms, n in kernels[:10]],
               top_ops=[[k[:60], ms, n] for k, ms, n in ops[:10]])
    if named:
        out["named"] = {
            label: dict(kernel_ms=sum(ms for k, ms, _ in kernels if sub in k),
                        kernel_calls=sum(n for k, _, n in kernels if sub in k),
                        op_ms=sum(ms for k, ms, _ in ops if sub in k),
                        op_calls=sum(n for k, _, n in ops if sub in k))
            for label, sub in named.items()}
    return out


def launch_counts() -> dict:
    """Every kernel's launch counter, by kernel name (the counters a
    serving CLI prints on exit)."""
    from distributed_tensorflow_tpu_torch.ops import kernels
    return kernels.launch_counts()


def reset_launch_counts() -> None:
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import layer_norm as ln
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    fa.launches = fa.dq_launches = fa.dkv_launches = ln.launches = 0
    fa.chunk_launches = fa.chunk_dq_launches = fa.chunk_dkv_launches = 0
    qmm.launches = qmm.nt_launches = qmm.dgelu_launches = 0
    qmm.quantize_launches = qmm.gemm_launches = qmm.transpose_launches = 0


def train_run(dev, cfg, steps: int, check=None, profile=True,
              mesh=None, named=None, place=None, after=None) -> dict:
    """The flagship step of ``cfg`` (fp32 masters, Adam, B=8, S=1024, the
    synthetic stream from its seed; ``mesh``: the sequence-parallel
    backends' and the tensor-parallel heads'; ``place(state)``: the
    layout's placement, ``ParallelConfig.place_state``): the
    kernel-vs-plain ``check(model, loss_fn, batch)`` when given, on the
    placed model, then ``steps`` steps with the launch counters set to 0
    just before and read just after, then one profiled step;
    ``after(state)``'s dict joins the numbers."""
    import torch
    from distributed_tensorflow_tpu_torch.data.lm import make_lm_datasets
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.parallel.sync import (
        build_sync_train_step)
    from distributed_tensorflow_tpu_torch.training.optimizers import (
        make_optimizer)
    from distributed_tensorflow_tpu_torch.training.state import TrainState

    t0 = time.perf_counter()
    B, S = TRAIN["batch"], TRAIN["seq_len"]
    model = gpt.GptLM(cfg, device=dev, seed=SEED, param_dtype=torch.float32,
                      mesh=mesh)
    n_params = sum(p.numel() for p in model.parameters())
    data = make_lm_datasets(cfg, seq_len=S).train

    def loss_fn(m, batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        loss, acc = gpt.lm_loss(m(tokens), tokens)
        return loss, {"accuracy": acc}

    state = TrainState.create(model, make_optimizer("adam", TRAIN["lr"]),
                              params_to_tree=gpt.params_to_jax,
                              params_from_tree=gpt.params_from_jax)
    if place is not None:
        state = place(state)
    checked = None
    if check is not None:
        checked = check(state.model, loss_fn, data.next_batch(B))
    step = build_sync_train_step(loss_fn, log_grad_norm=True)
    batches = [data.next_batch(B) for _ in range(steps + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    reset_launch_counts()
    losses, step_ms, grad_norms = [], [], []
    for batch in batches[:steps]:
        t = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))      # waits for the step
        step_ms.append((time.perf_counter() - t) * 1e3)
        grad_norms.append(float(metrics["grad_norm"]))
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profiled = profile_train_step(step, state, batches[steps], named) \
        if profile else None
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite train loss: {losses}")
    if state.global_step != steps + 1 + int(profile):
        raise AssertionError(f"global_step {state.global_step}")
    extra = after(state) if after is not None else {}
    del state, model
    torch.cuda.empty_cache()
    med_ms = statistics.median(step_ms[2:]) if steps > 2 else None
    flops = gpt_train_flops(cfg, B, S)
    return dict(
        params=n_params, batch=B, seq_len=S, steps=steps,
        optimizer="adam", lr=TRAIN["lr"], loss_first=losses[0],
        loss_last5_mean=statistics.mean(losses[-5:]), losses=losses,
        grad_norms=grad_norms, step_ms_median=med_ms, step_ms=step_ms,
        tokens_per_s=B * S / (med_ms / 1e3) if med_ms else None,
        model_tflops_per_step=flops / 1e12,
        mfu=flops / (med_ms / 1e3) / PEAK_BF16_FLOPS if med_ms else None,
        peak_mem_gb=peak_gb, launches=launches, kernel_vs_plain=checked,
        setup_s=setup_s, profiled=profiled, **extra)


def expect_launches(name, launches, per_step, steps) -> None:
    want = {k: per_step.get(k, 0) * steps for k in launches}
    if launches != want:
        raise AssertionError(f"{name} launches {launches}, expected "
                             f"{per_step} per step x {steps}")


def falls(name, run) -> None:
    if not run["loss_last5_mean"] < run["loss_first"]:
        raise AssertionError(f"{name}: loss did not fall: first "
                             f"{run['loss_first']}, mean of the last 5 "
                             f"{run['loss_last5_mean']}")


def train(dev, smi: str):
    """Phase 5: the port's GPT train step at GPT-406M width.  Returns the
    launches and the step's numbers the int8 phase is held to."""
    from distributed_tensorflow_tpu_torch.models import gpt
    cfg = gpt.GptConfig(**WIDTH)
    run = train_run(dev, cfg, TRAIN["steps"], check=lambda m, f, b: (
        check_train_step(dev, m, f, b, (TRAIN_LOSS_TOL, TRAIN_GRAD_NORM_RTOL,
                                        TRAIN_GRAD_MIN_COS))))
    L = cfg.num_layers
    per_step = {"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L, "layer_norm_fwd": 2 * L + 1}
    expect_launches("train", run["launches"], per_step, TRAIN["steps"])
    falls("train", run)
    emit("train_profile", **run.pop("profiled"))
    emit("train", model="gpt_406m_width", launches_per_step=per_step,
         card=smi, **run)
    return run["launches"], run


def train_int8(dev, smi: str, bf16: dict):
    """Phase 6: the same step with the int8 training MLP (K4, K5), then a
    short arm with the int8 attention projections as well."""
    from distributed_tensorflow_tpu_torch.models import gpt
    cfg = gpt.GptConfig(**WIDTH, matmul_int8=True)
    # K4/K5's kernels and the weight transpose by name in the profile.
    named = {"kernel A (quantize_blocks)": "quantize_blocks",
             "kernel B (qgemm_wgmma)": "qgemm_wgmma",
             "K4 weight transpose (transpose_s8)": "transpose_s8"}
    run = train_run(dev, cfg, TRAIN["steps"], check=lambda m, f, b: (
        check_train_step(dev, m, f, b, (TRAIN_INT8_LOSS_TOL,
                                        TRAIN_INT8_GRAD_NORM_RTOL,
                                        TRAIN_INT8_GRAD_MIN_COS))),
        named=named)
    L = cfg.num_layers
    per_step = {"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L, "layer_norm_fwd": 2 * L + 1,
                "quant_matmul": 2 * L, "quant_matmul_nt": 2 * L,
                "quantize_blocks": 4 * L, "quant_gemm": 4 * L,
                "transpose_s8": 2 * L}
    expect_launches("train_int8", run["launches"], per_step, TRAIN["steps"])
    falls("train_int8", run)
    limit = INT8_LOSS_RATIO * bf16["loss_last5_mean"] + INT8_LOSS_SLACK
    if not run["loss_last5_mean"] <= limit:
        raise AssertionError(f"int8 loss {run['loss_last5_mean']} above "
                             f"{limit} (bf16 {bf16['loss_last5_mean']})")
    emit("train_int8_profile", **run.pop("profiled"))
    # MFU in bf16-equivalent model flops (bench.py's
    # gpt_int8_mfu_pct_bf16_equiv): the same flops over the bf16 peak.
    emit("train_int8", model="gpt_406m_width", launches_per_step=per_step,
         card=smi, loss_limit=limit, bf16_loss_last5_mean=bf16[
             "loss_last5_mean"],
         step_ms_ratio_to_bf16=run["step_ms_median"]
         / bf16["step_ms_median"], mfu_convention="bf16-equivalent", **run)
    arm = train_run(dev, gpt.GptConfig(**WIDTH, matmul_int8=True,
                                       attn_int8=True), ATTN_INT8_STEPS,
                    profile=False)
    emit("train_int8_attn", model="gpt_406m_width", card=smi,
         losses=arm["losses"], step_ms=arm["step_ms"],
         launches=arm["launches"], peak_mem_gb=arm["peak_mem_gb"])
    return run["launches"]


def check_ring_step(dev, model, loss_fn, batch) -> dict:
    """One ring step's loss and gradients through K6/K7 against the same
    ring with the plain chunk versions, and against the pallas step (K1/K2
    over the whole sequence), with the same weights and batch."""
    import contextlib
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.parallel import ring

    @contextlib.contextmanager
    def plain_chunks():
        """The ring's hops through the chunk functions' plain versions,
        for this comparison only (the wrappers launch the kernels on the
        card)."""
        names = ("flash_attention_chunk", "flash_attention_chunk_dq",
                 "flash_attention_chunk_dkv")
        saved = [getattr(ring, n) for n in names]
        for n in names:
            setattr(ring, n, getattr(fa, n + "_reference"))
        # The ring asks K6 for its in-place form; the plain version returns
        # new carries, which the ring takes all the same.
        ring.flash_attention_chunk = (
            lambda *a, in_place=False, **kw:
            fa.flash_attention_chunk_reference(*a, **kw))
        try:
            yield
        finally:
            for n, f in zip(names, saved):
                setattr(ring, n, f)

    tols = (TRAIN_LOSS_TOL, TRAIN_GRAD_NORM_RTOL, TRAIN_GRAD_MIN_COS)
    kernel = step_grads(model, loss_fn, batch)
    vs_plain = compare_steps(kernel, step_grads(model, loss_fn, batch,
                                                plain_chunks()),
                             tols, ("kernel", "plain_chunks"))
    pallas = gpt.GptLM(dataclasses.replace(
        model.cfg, attention_backend="pallas"), device=dev,
        param_dtype=torch.float32)
    pallas.load_state_dict(model.state_dict())
    vs_pallas = compare_steps(kernel, step_grads(pallas, loss_fn, batch),
                              tols, ("kernel", "pallas"))
    del pallas, kernel
    out = dict(batch=len(batch["tokens"]), vs_plain_chunks=vs_plain,
               vs_pallas=vs_pallas, loss_tol=tols[0],
               grad_norm_rtol=tols[1], grad_min_cos=tols[2])
    torch.cuda.empty_cache()
    return out


def train_ring(dev, smi: str, bf16: dict):
    """Phase 7: the same step with sequence-parallel ring attention
    (``attention_backend="ring"``) over four sequence shards of 256 on the
    card: every block's attention through K6 forward and K7a/K7b backward
    per hop, K3 as before, no K1/K2."""
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.parallel.mesh import create_mesh
    from distributed_tensorflow_tpu_torch.parallel.ring import _ring_hops
    cfg = gpt.GptConfig(**{**WIDTH, "attention_backend": "ring"})
    mesh = create_mesh(data=1, seq=RING_SEQ, devices=[dev] * RING_SEQ)
    run = train_run(dev, cfg, TRAIN["steps"], mesh=mesh,
                    check=lambda m, f, b: check_ring_step(dev, m, f, b))
    L = cfg.num_layers
    hops = _ring_hops(RING_SEQ, TRAIN["seq_len"] // RING_SEQ, True,
                      cfg.attention_window)
    per_hop = RING_SEQ * hops * L
    per_step = {"flash_attention_chunk": per_hop,
                "flash_attention_chunk_dq": per_hop,
                "flash_attention_chunk_dkv": per_hop,
                "layer_norm_fwd": 2 * L + 1}
    expect_launches("train_ring", run["launches"], per_step, TRAIN["steps"])
    falls("train_ring", run)
    emit("train_ring_profile", **run.pop("profiled"))
    emit("train_ring", model="gpt_406m_width", launches_per_step=per_step,
         card=smi, mesh=dict(data=1, seq=RING_SEQ, devices=str(dev)),
         hops=hops, step_ms_ratio_to_bf16=run["step_ms_median"]
         / bf16["step_ms_median"], bf16_loss_last5_mean=bf16[
             "loss_last5_mean"], **run)
    return run["launches"]


def check_parallel_step(dev, model, loss_fn, batch, tols=None) -> dict:
    """One step of the placed model (its shards' gradients gathered)
    against the unsharded pallas step (K1/K2 over the whole sequence and
    every head; the int8 MLP's K4/K5 unsharded for an int8 model) with
    the same weights and batch, within ``tols`` (default TRAIN_*)."""
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.parallel.sharding import (
        gather_named)
    tols = tols or (TRAIN_LOSS_TOL, TRAIN_GRAD_NORM_RTOL, TRAIN_GRAD_MIN_COS)
    pallas = gpt.GptLM(dataclasses.replace(
        model.cfg, attention_backend="pallas"), device=dev,
        param_dtype=torch.float32)
    pallas.load_state_dict(gather_named(model, model.state_dict()))
    kernel = step_grads(model, loss_fn, batch)
    out = dict(batch=len(batch["tokens"]), vs_pallas=compare_steps(
        kernel, step_grads(pallas, loss_fn, batch), tols,
        ("parallel", "pallas")), loss_tol=tols[0], grad_norm_rtol=tols[1],
        grad_min_cos=tols[2])
    del pallas, kernel
    torch.cuda.empty_cache()
    return out


def parallel_launches(L: int, seq: int, model: int, backend: str,
                      int8: bool = False) -> dict:
    """One step's launches on a seq x model mesh: K1/K2 once a layer per
    (model column, seq device) for pallas and ulysses (each seq device
    attends over its head block of the whole sequence), K6/K7 once a hop
    per (model column, seq shard) for the causal ring (``seq`` hops), and
    K3 2L + 1 on the replicated residual stream.  ``int8``: the MLP's K4
    twice a shard a layer (mlp_in's columns, mlp_out's K part) and K5
    twice (their dgrads), each K4 and K5 one quantize pass and one GEMM,
    each K4 one weight transpose (the K-blocks align with the shards at
    GPT-406M width: one pass a shard)."""
    per = {"layer_norm_fwd": 2 * L + 1}
    if int8:
        per.update(quant_matmul=2 * model * L, quant_matmul_nt=2 * model * L,
                   quantize_blocks=4 * model * L, quant_gemm=4 * model * L,
                   transpose_s8=2 * model * L)
    if backend == "ring":
        for name in ("flash_attention_chunk", "flash_attention_chunk_dq",
                     "flash_attention_chunk_dkv"):
            per[name] = L * model * seq * seq
    else:
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            per[name] = L * model * seq
    return per


def train_parallel(dev, smi: str, bf16: dict) -> dict:
    """Phase ``train_parallel``: the train step at GPT-406M width with its
    positions on the one card, placed by ``ParallelConfig.place_state``
    (``gpt_sharding_rules`` over the model axis): each arm's first step
    against the unsharded pallas step, then ``PARALLEL["steps"]`` steps
    with exact launches and a falling loss, and a profiled step (the
    ``train_parallel_profile`` line); then the trainer CLI with
    ``--tensor_parallel=2 --sequence_parallel=2
    --attention_backend=ulysses``.  Returns each arm's launches by path
    name."""
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.parallel.mesh import ParallelConfig
    t0 = time.perf_counter()
    out = {}
    for arm, seq, model_axis, backend, int8 in PARALLEL["arms"]:
        pc = ParallelConfig(model=model_axis, seq=seq, attention=backend,
                            quantize="int8" if int8 else "off")
        mesh = pc.build_mesh([dev] * (seq * model_axis))
        cfg = gpt.GptConfig(**{**WIDTH, "attention_backend": backend,
                               "matmul_int8": int8})
        tols = ((TRAIN_INT8_LOSS_TOL, TRAIN_INT8_GRAD_NORM_RTOL,
                 TRAIN_INT8_GRAD_MIN_COS) if int8 else None)
        run = train_run(
            dev, cfg, PARALLEL["steps"], mesh=mesh,
            place=lambda st: pc.place_state(mesh, st,
                                            gpt.gpt_sharding_rules()),
            check=lambda m, f, b: check_parallel_step(dev, m, f, b, tols))
        per_step = parallel_launches(cfg.num_layers, seq, model_axis, backend,
                                     int8)
        expect_launches(f"train_parallel {arm}", run["launches"], per_step,
                        PARALLEL["steps"])
        falls(f"train_parallel {arm}", run)
        emit("train_parallel_profile", arm=arm, **run.pop("profiled"))
        emit("train_parallel", arm=arm, model="gpt_406m_width", card=smi,
             layout=pc.describe(), mesh=dict(data=1, seq=seq,
                                             model=model_axis,
                                             devices=str(dev)),
             attention=backend, launches_per_step=per_step,
             step_ms_ratio_to_bf16=run["step_ms_median"]
             / bf16["step_ms_median"],
             bf16_step_ms_median=bf16["step_ms_median"], **run)
        out[f"train_parallel_{arm}"] = run["launches"]
    emit("train_parallel_done", arms_s=time.perf_counter() - t0)
    return out


def parallel_cli(dev, smi: str) -> dict:
    """``train.py --model=gpt_mini --tensor_parallel=2 --sequence_parallel=2
    --attention_backend=ulysses --fused_layer_norm`` on the card (its four
    positions on the one card, as the CLI prints), with
    ``--log_sharding``; then ``--mode=eval`` (gate: the trained process's
    test accuracy) and ``--mode=generate`` (gate: an in-process decode of
    the restored tree) on its logdir.  Gate: its launches exactly as its
    steps and eval forwards predict."""
    from distributed_tensorflow_tpu_torch.models import gpt
    T = PARALLEL
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        logdir = os.path.join(tmp, "run")
        common = ["--model=gpt_mini", "--tensor_parallel=2",
                  "--sequence_parallel=2", "--attention_backend=ulysses",
                  "--fused_layer_norm", f"--bert_seq_len={T['cli_seq']}",
                  f"--batch_size={T['cli_batch']}", f"--logdir={logdir}",
                  # No card index: the CLI lays the positions round robin
                  # over the visible cards (here all on the one).
                  f"--device={dev.type}", "--job_name=worker",
                  "--task_index=0",
                  f"--worker_hosts=localhost:{free_port()}", "--ps_hosts=",
                  "--sync_replicas=true"]
        t0 = time.perf_counter()
        with CliProcess("train", *common, f"--train_steps={T['cli_steps']}",
                        f"--save_interval_steps={T['cli_steps']}",
                        "--log_every=1", "--log_sharding",
                        f"--metrics_file={os.path.join(tmp, 'm.jsonl')}"
                        ) as proc:
            lines = finish(proc, 300)
        train_s = time.perf_counter() - t0
        layout = line_value(lines, "Worker 0: mesh")
        if "4 positions on 1 distinct device(s)" not in layout:
            raise AssertionError(f"parallel CLI layout: {layout}")
        placed = [x for x in lines if x.startswith("Worker 0: param ")]
        if not any("layer0/qkv/kernel (128, 3, 4, 32) -> PartitionSpec("
                   "None, None, 'model', None)" in x for x in placed):
            raise AssertionError(f"parallel CLI placement: {placed[:8]}")
        nums = trainer_numbers(lines, os.path.join(tmp, "m.jsonl"), 0)
        losses = [float(x.split(" loss ")[1].split()[0]) for x in lines
                  if x.startswith("Worker 0: traing step")]
        steps = nums["steps"]
        if steps != T["cli_steps"] - 1 or len(losses) != steps:
            raise AssertionError(f"{steps} steps, {len(losses)} loss lines")
        if not (all(map(math.isfinite, losses))
                and statistics.mean(losses[-5:]) < losses[0]):
            raise AssertionError(f"parallel CLI loss did not fall: {losses}")
        L = gpt.mini().num_layers
        # Each train step and eval forward: K1 (and in the step K2a/K2b)
        # once a layer per (model column, seq device); K3 2L + 1.  The
        # evaluations: the validation at step 0 and the final test,
        # make_lm_eval_fn's 4 batches each.
        per = 2 * 2 * L
        forwards = steps + 2 * 4
        want = {"flash_attention_fwd": per * forwards,
                "flash_attention_bwd_dq": per * steps,
                "flash_attention_bwd_dkv": per * steps,
                "layer_norm_fwd": (2 * L + 1) * forwards,
                "quant_matmul": 0, "quant_matmul_nt": 0}
        if nums["launches"] != want:
            raise AssertionError(f"parallel CLI launches {nums['launches']}"
                                 f", expected {want}")
        after = eval_and_generate(dev, common, logdir, nums, T["cli_steps"],
                                  T["gen_tokens"])
        emit("train_parallel_cli", card=smi, layout_line=layout,
             train_wall_s=train_s, batch=T["cli_batch"], seq_len=T["cli_seq"],
             loss_first=losses[0],
             loss_last5_mean=statistics.mean(losses[-5:]),
             tokens_per_s=T["cli_batch"] * T["cli_seq"]
             / (nums["step_ms_median"] / 1e3),
             launches_expected=want, **after, **nums)
        return nums["launches"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def pipeline_launches(L: int, micro: int, n_chunks: int,
                      schedule: str) -> dict:
    """One step's launches of the pipelined train step: every micro-batch
    through every layer forward (K1, two K3) and backward (K2a, K2b).
    GPipe (no remat) runs the head once on the whole batch (one K3);
    1F1B and interleaved recompute each chunk's forward in its backward
    slot, skip the last chunk's forward slot (its output is recomputed
    there) and run the head a micro-batch (one K3 each)."""
    if schedule == "gpipe":
        fwd, head = L * micro, 1
    else:
        per = L // n_chunks
        fwd, head = micro * (2 * L - per), micro
    return {"flash_attention_fwd": fwd,
            "flash_attention_bwd_dq": L * micro,
            "flash_attention_bwd_dkv": L * micro,
            "layer_norm_fwd": 2 * fwd + head}


def train_pipeline(dev, smi: str, bf16: dict) -> dict:
    """Phase ``train_pipeline``: the flagship step at GPT-406M width with
    its decoder blocks as pipeline stages on the one card
    (``models/registry.build_gpt_pipeline``: GPipe through autograd, 1F1B
    and interleaved through the hand-rolled schedules), the weights of
    the ``train`` phase's seed.  Each arm: its first step against the
    unpipelined pallas step (TRAIN_*), then ``PIPELINE["steps"]`` Adam
    steps with the launch counters set to 0 just before and read just
    after (gate: the schedule's count, :func:`pipeline_launches`), a
    falling loss, peak memory, and one profiled step.  Then the trainer
    CLI (:func:`pipeline_cli`).  Returns each path's launches."""
    import torch
    from distributed_tensorflow_tpu_torch.data.lm import make_lm_datasets
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.models.registry import (
        build_gpt_pipeline)
    from distributed_tensorflow_tpu_torch.parallel.mesh import create_mesh
    from distributed_tensorflow_tpu_torch.parallel.sync import (
        build_sync_train_step)
    from distributed_tensorflow_tpu_torch.training.optimizers import (
        make_optimizer)
    from distributed_tensorflow_tpu_torch.training.state import TrainState
    t0 = time.perf_counter()
    T, B, S = PIPELINE, TRAIN["batch"], TRAIN["seq_len"]
    cfg = gpt.GptConfig(**WIDTH)
    data = make_lm_datasets(cfg, seq_len=S).train
    batches = [data.next_batch(B) for _ in range(T["steps"] + 1)]

    def loss_fn(m, batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        loss, acc = gpt.lm_loss(m(tokens), tokens)
        return loss, {"accuracy": acc}
    plain = gpt.GptLM(cfg, device=dev, seed=SEED, param_dtype=torch.float32)
    # The unpipelined step's gradients, held off the card so that no arm's
    # peak memory counts them.
    loss0, grads0 = step_grads(plain, loss_fn, batches[0])
    pallas = (loss0, grads0.cpu())
    del plain, grads0
    torch.cuda.empty_cache()
    width = {k: v for k, v in WIDTH.items()
             if k not in ("dtype", "attention_backend", "fused_ln")}
    tols = (TRAIN_LOSS_TOL, TRAIN_GRAD_NORM_RTOL, TRAIN_GRAD_MIN_COS)
    out = {}
    for arm, n_pipe, v in T["arms"]:
        mesh = create_mesh(data=1, pipe=n_pipe, devices=[dev] * n_pipe)

        b = build_gpt_pipeline(
            TRAIN["lr"], mesh, seed=SEED, seq_len=S, n_micro=T["micro"],
            attention_backend="pallas", dtype=WIDTH["dtype"],
            tx=make_optimizer("adam", TRAIN["lr"]), fused_ln=True,
            schedule=arm, virtual_stages=v, width=width)
        state = b.place_state(mesh, b.state)
        step = (b.train_step_builder(mesh, log_grad_norm=True)
                if b.train_step_builder else
                build_sync_train_step(b.loss_fn, log_grad_norm=True))
        model = state.model
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses, step_ms, vs_pallas = [], [], None
        for batch in batches[:T["steps"]]:
            t = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            step_ms.append((time.perf_counter() - t) * 1e3)
            if vs_pallas is None:
                # The first step's gradients (left in .grad by the step),
                # by the plain model's names in its order, against the
                # unpipelined pallas step's on the same batch.
                flat = torch.cat([g.float().flatten().cpu() for _, g in
                                  sorted((plain_name(model, n), p.grad)
                                         for n, p in
                                         model.named_parameters())])
                vs_pallas = compare_steps((losses[0], flat), pallas, tols,
                                          ("pipeline", "pallas"))
                del flat
        launches = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        profiled = profile_train_step(step, state, batches[-1])
        per_step = pipeline_launches(cfg.num_layers, T["micro"], n_pipe * v,
                                     arm)
        expect_launches(f"train_pipeline {arm}", launches, per_step,
                        T["steps"])
        run = dict(loss_first=losses[0],
                   loss_last5_mean=statistics.mean(losses[-5:]))
        if not all(map(math.isfinite, losses)) or not (
                losses[-1] < losses[0]):
            raise AssertionError(f"train_pipeline {arm}: losses {losses}")
        med = statistics.median(step_ms[1:])
        emit("train_pipeline_profile", arm=arm, **profiled)
        emit("train_pipeline", arm=arm, model="gpt_406m_width", card=smi,
             schedule=arm, pipe=n_pipe, virtual_stages=v,
             micro_batches=T["micro"], batch=B, seq_len=S,
             mesh=dict(data=1, pipe=n_pipe, devices=str(dev)),
             vs_pallas=vs_pallas, loss_tol=tols[0], grad_norm_rtol=tols[1],
             grad_min_cos=tols[2], losses=losses, step_ms=step_ms,
             step_ms_median=med,
             step_ms_ratio_to_bf16=med / bf16["step_ms_median"],
             bf16_step_ms_median=bf16["step_ms_median"],
             tokens_per_s=B * S / (med / 1e3), peak_mem_gb=peak_gb,
             bf16_peak_mem_gb=bf16["peak_mem_gb"],
             busy_share=profiled["busy_share"],
             peak_stash=getattr(step, "peak_stash", None),
             launches=launches, launches_per_step=per_step, **run)
        out[f"train_pipeline_{arm}"] = launches
        del state, model, b, step
        torch.cuda.empty_cache()
    emit("train_pipeline_done", arms_s=time.perf_counter() - t0)
    return out


def plain_name(model, name: str) -> str:
    """The plain ``GptLM``'s name of a ``PipelinedGptLM`` parameter:
    ``stages.c.layers.l.x`` is ``layers.i.x`` (``i`` the global layer),
    ``embed.x`` and ``head.x`` are ``x``."""
    part, _, rest = name.partition(".")
    if part != "stages":
        return rest
    c, _, l, leaf = rest.split(".", 3)
    return f"layers.{model._layer(int(c), int(l))}.{leaf}"


def pipeline_cli(dev, smi: str) -> dict:
    """``train.py --model=gpt_mini --pipeline_parallel=2
    --pipeline_schedule=1f1b --attention_backend=pallas --fused_layer_norm``
    on the card (both stages on the one card), then ``--mode=eval`` and
    ``--mode=generate`` from the pipelined checkpoint (namespace
    ``gpt_mini_pp2``, the stage-stacked tree; gate: its tokens are an
    in-process decode of the merged tree).  Gate: its launches exactly
    as the schedule's steps and the GPipe eval forwards predict."""
    from distributed_tensorflow_tpu_torch.models import gpt
    T = PIPELINE
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    try:
        logdir = os.path.join(tmp, "run")
        pipe = ["--pipeline_parallel=2", "--pipeline_schedule=1f1b",
                f"--pipeline_microbatches={T['cli_micro']}"]
        common = ["--model=gpt_mini", *pipe, "--attention_backend=pallas",
                  "--fused_layer_norm", f"--bert_seq_len={T['cli_seq']}",
                  f"--batch_size={T['cli_batch']}", f"--logdir={logdir}",
                  f"--device={dev.type}", "--job_name=worker",
                  "--task_index=0",
                  f"--worker_hosts=localhost:{free_port()}", "--ps_hosts=",
                  "--sync_replicas=true"]
        t0 = time.perf_counter()
        with CliProcess("train", *common, f"--train_steps={T['cli_steps']}",
                        f"--save_interval_steps={T['cli_steps']}",
                        "--log_every=1", "--log_sharding",
                        f"--metrics_file={os.path.join(tmp, 'm.jsonl')}"
                        ) as proc:
            lines = finish(proc, 300)
        train_s = time.perf_counter() - t0
        layout = line_value(lines, "Worker 0: mesh")
        if "(pipe=2, seq=1, model=1): 2 positions on 1 distinct" not in \
                layout:
            raise AssertionError(f"pipeline CLI layout: {layout}")
        placed = [x for x in lines if x.startswith("Worker 0: param ")]
        if not any("stages/qkv/kernel (2, 2, 128, 3, 4, 32) -> "
                   "PartitionSpec('pipe',)" in x for x in placed):
            raise AssertionError(f"pipeline CLI placement: {placed[:8]}")
        nums = trainer_numbers(lines, os.path.join(tmp, "m.jsonl"), 0)
        losses = [float(x.split(" loss ")[1].split()[0]) for x in lines
                  if x.startswith("Worker 0: traing step")]
        steps = nums["steps"]
        if steps != T["cli_steps"] - 1 or len(losses) != steps:
            raise AssertionError(f"{steps} steps, {len(losses)} loss lines")
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"pipeline CLI loss did not fall: {losses}")
        L, M = gpt.mini().num_layers, T["cli_micro"]
        # Each 1F1B step (:func:`pipeline_launches`, 2 chunks); each eval
        # forward (the validation at step 0 and the final test,
        # make_lm_eval_fn's 4 batches each) is the GPipe apply: every
        # micro-batch through every layer, the head once.
        per = pipeline_launches(L, M, 2, "1f1b")
        forwards = 2 * 4
        want = {"flash_attention_fwd": per["flash_attention_fwd"] * steps
                + L * M * forwards,
                "flash_attention_bwd_dq": per["flash_attention_bwd_dq"]
                * steps,
                "flash_attention_bwd_dkv": per["flash_attention_bwd_dkv"]
                * steps,
                "layer_norm_fwd": per["layer_norm_fwd"] * steps
                + (2 * L * M + 1) * forwards,
                "quant_matmul": 0, "quant_matmul_nt": 0}
        if nums["launches"] != want:
            raise AssertionError(f"pipeline CLI launches {nums['launches']}"
                                 f", expected {want}")
        after = eval_and_generate(dev, common, logdir, nums, T["cli_steps"],
                                  T["gen_tokens"], gen_flags=pipe,
                                  name="gpt_mini_pp2")
        emit("train_pipeline_cli", card=smi, layout_line=layout,
             train_wall_s=train_s, batch=T["cli_batch"],
             seq_len=T["cli_seq"], micro_batches=M, loss_first=losses[0],
             loss_last=losses[-1],
             tokens_per_s=T["cli_batch"] * T["cli_seq"]
             / (nums["step_ms_median"] / 1e3),
             launches_expected=want, **after, **nums)
        return nums["launches"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


_FSDP_RANK = r"""
import json, statistics, sys, time
import torch, torch.distributed as dist
rank, port, out, conf = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                         json.loads(sys.argv[4]))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)
from distributed_tensorflow_tpu_torch.data.lm import make_lm_datasets
from distributed_tensorflow_tpu_torch.models import gpt
from distributed_tensorflow_tpu_torch.ops import kernels
from distributed_tensorflow_tpu_torch.parallel import sync
from distributed_tensorflow_tpu_torch.parallel.mesh import create_mesh
from distributed_tensorflow_tpu_torch.parallel.sharding import (
    FsdpExchange, fsdp_state)
from distributed_tensorflow_tpu_torch.training.optimizers import (
    make_optimizer)
from distributed_tensorflow_tpu_torch.training.state import TrainState
dev = torch.device(conf["device"])
cuda = dev.type == "cuda"
if cuda:
    kernels.load()
cfg = gpt.GptConfig(**conf["width"])
B, steps = conf["batch"], conf["steps"]
data = make_lm_datasets(cfg, seq_len=conf["seq_len"]).train
# The global batch is both ranks' B rows; each rank feeds its half.
batches = [data.next_batch(2 * B) for _ in range(steps)]
def mine(b):
    return {"tokens": b["tokens"][rank * B:(rank + 1) * B]}
def loss_fn(m, batch):
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    loss, acc = gpt.lm_loss(m(tokens), tokens)
    return loss, {"accuracy": acc}
def counters():
    return dict(kernels.launch_counts())
def reset():
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import layer_norm as ln
    fa.launches = fa.dq_launches = fa.dkv_launches = ln.launches = 0
ar = sync.GradientAllReduce()
res, first = {}, {}
for arm in ("replicated", "fsdp"):
    model = gpt.GptLM(cfg, device=dev, seed=conf["seed"],
                      param_dtype=torch.float32)
    state = TrainState.create(model, make_optimizer("adam", conf["lr"]),
                              params_to_tree=gpt.params_to_jax,
                              params_from_tree=gpt.params_from_jax)
    if arm == "fsdp":
        state = fsdp_state(create_mesh(data=1, devices=[dev]), state,
                           min_size=conf["min_size"])
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    step = sync.build_sync_train_step(loss_fn, all_reduce=ar)
    reset()
    losses, step_ms = [], []
    for b in batches:
        t = time.perf_counter()
        state, m = step(state, mine(b))
        losses.append(float(m["loss"]))
        if cuda:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        if len(losses) == 1:
            # The first step's loss and mean gradients over the ranks
            # (left in .grad by the step), whole, kept on the host: the
            # other arm's peak memory is its own.
            grads = {n: p.grad for n, p in model.named_parameters()}
            if arm == "fsdp":
                grads = FsdpExchange(model).gather_named(grads)
            first[arm] = (losses[0], torch.cat(
                [g.float().flatten().cpu() for _, g in sorted(grads.items())]))
            del grads
    launches = counters()
    # (A generator: a list of the slots here would keep this arm's
    # slots alive into the next arm's peak.)
    r = dict(losses=losses, step_ms=step_ms,
             step_ms_median=statistics.median(step_ms),
             peak_mem_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                          if cuda else None),
             param_bytes=sum(p.numel() * p.element_size()
                             for p in model.parameters()),
             slot_bytes=sum(v.numel() * v.element_size()
                            for p in state.optimizer.params
                            for v in state.optimizer.base.state.get(
                                p, {}).values()
                            if torch.is_tensor(v) and v.dim()),
             launches=launches)
    fs = step.cache.get("fsdp")
    if fs is not None:
        e = fs.exchange
        r.update(split_parameters=len(e.entries),
                 gather_ms=e.gather_s * 1e3 / e.calls,
                 reduce_scatter_ms=e.scatter_s * 1e3 / e.calls)
    res[arm] = r
    del state, model, step
    if cuda:
        torch.cuda.empty_cache()
(lr_, gr), (lf, gf) = first["replicated"], first["fsdp"]
nr, nf = gr.double().norm().item(), gf.double().norm().item()
res["first_step"] = dict(
    loss_replicated=lr_, loss_fsdp=lf, loss_diff=abs(lr_ - lf),
    grad_norm_replicated=nr, grad_norm_fsdp=nf,
    grad_norm_rel_diff=abs(nr - nf) / nr,
    grad_cos=(gr.double() @ gf.double()).item() / (
        gr.double().norm() * gf.double().norm()).item(),
    bit_equal=bool(torch.equal(gr, gf)) and lr_ == lf)
json.dump(res, open(out, "w"))
dist.destroy_process_group()
"""


def train_fsdp(dev, smi: str, bf16: dict, alone: bool = False) -> dict:
    """Phase ``train_fsdp``: ZeRO-3 over two sync workers sharing the one
    card (two gloo ranks as processes, ``_FSDP_RANK``) at GPT-406M width,
    B=8 a rank, ``FSDP["steps"]`` Adam steps of the FSDP state
    (parameters, Adam slots split over the ranks by
    ``parallel/sharding.fsdp_state``, gathered whole for the step,
    reduce-scattered after it) and as many of the replicated two-rank
    sync step on the same batches: the first step's loss and mean
    gradients (whole, gathered) of the one against the other's (TRAIN_*;
    bit-equality stated either way), the persistent parameter and slot
    bytes a rank, peak memory, step ms, and the all-gather and
    reduce-scatter ms a step (gate: FSDP's peak under replicated's).
    ``alone``: no other phase runs beside it (``--fsdp``).  Returns rank
    0's FSDP launches."""
    T = FSDP
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fsdp_")
    conf = dict(width={k: v for k, v in WIDTH.items()},
                batch=TRAIN["batch"], seq_len=TRAIN["seq_len"],
                steps=T["steps"], lr=TRAIN["lr"], seed=SEED,
                device=str(dev), min_size=T["min_size"])
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    port = free_port()
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-c", _FSDP_RANK, str(r), str(port),
             os.path.join(tmp, f"rank{r}.json"), json.dumps(conf)],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(T["ranks"])]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=T["timeout_s"])[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, text in zip(procs, outs):
            if p.returncode != 0:
                raise AssertionError(f"train_fsdp rank exited "
                                     f"{p.returncode}: {text[-4000:]}")
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                 for r in range(T["ranks"])]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    first = ranks[0]["first_step"]
    tols = (TRAIN_LOSS_TOL, TRAIN_GRAD_NORM_RTOL, TRAIN_GRAD_MIN_COS)
    if not (math.isfinite(first["loss_fsdp"])
            and first["loss_diff"] <= tols[0]
            and first["grad_norm_rel_diff"] <= tols[1]
            and first["grad_cos"] >= tols[2]):
        raise AssertionError(f"train_fsdp first step vs replicated: {first}")
    L = WIDTH["num_layers"]
    per_step = {"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L, "layer_norm_fwd": 2 * L + 1}
    for r, rank in enumerate(ranks):
        for arm in ("replicated", "fsdp"):
            got = {k: rank[arm]["launches"][k] for k in per_step}
            expect_launches(f"train_fsdp rank {r} {arm}", got, per_step,
                            T["steps"])
            if not all(map(math.isfinite, rank[arm]["losses"])):
                raise AssertionError(f"train_fsdp rank {r} {arm}: "
                                     f"{rank[arm]['losses']}")
        f, rep = rank["fsdp"], rank["replicated"]
        share = (f["param_bytes"] + f["slot_bytes"]) / (
            rep["param_bytes"] + rep["slot_bytes"])
        if not share < 0.55:
            raise AssertionError(f"train_fsdp rank {r}: persistent bytes "
                                 f"{share:.3f} of replicated")
        if f["peak_mem_gb"] is not None and not (
                f["peak_mem_gb"] < rep["peak_mem_gb"]):
            raise AssertionError(f"train_fsdp rank {r}: peak "
                                 f"{f['peak_mem_gb']} GB, replicated "
                                 f"{rep['peak_mem_gb']}")
        rank["persistent_share"] = share
    # In the whole run its processes run beside the two gpt_mini CLIs on
    # the one card and host: step, gather and reduce-scatter ms are then
    # contended times (``alone``: ``--fsdp``).
    emit("train_fsdp", card=smi, model="gpt_406m_width", wall_s=wall_s,
         timed_beside=([] if alone else ["train_parallel_cli",
                                         "train_pipeline_cli",
                                         "train_models", "train_data_cli",
                                         "train_mesh_cli"]),
         ranks_n=T["ranks"], devices=str(dev), batch_per_rank=TRAIN["batch"],
         seq_len=TRAIN["seq_len"], steps=T["steps"], first_step=first,
         loss_tol=tols[0], grad_norm_rtol=tols[1], grad_min_cos=tols[2],
         bf16_step_ms_median=bf16["step_ms_median"],
         launches_per_step=per_step, ranks=ranks)
    return {k: ranks[0]["fsdp"]["launches"][k] for k in per_step}


# ------------------------------------------------------------- trainer


_PORTS_LOCK = threading.Lock()
_PORTS_HANDED: set = set()


def free_port() -> int:
    """A free port on localhost whose port + 1000 is free too (a worker
    without a PS, ``--ps_hosts=``, whose chief listens at this port hosts
    the coordination service at port + 1000), neither of them handed out
    before by this process (parts side by side start their CLIs at
    once)."""
    import socket
    with _PORTS_LOCK:
        while True:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            pair = {port, port + 1000}
            if port + 1000 > 65535 or pair & _PORTS_HANDED:
                continue
            with socket.socket() as s:
                try:
                    s.bind(("127.0.0.1", port + 1000))
                except OSError:
                    continue
            _PORTS_HANDED.update(pair)
            return port


def finish(proc: CliProcess, timeout_s: float) -> list:
    """Every output line of a CLI process that must exit 0 within
    ``timeout_s``."""
    deadline = time.perf_counter() + timeout_s
    while True:
        try:
            line = proc.lines.get(
                timeout=max(deadline - time.perf_counter(), 0.01))
        except queue.Empty:
            raise AssertionError("CLI timed out: "
                                 + "".join(proc.seen[-30:])) from None
        if line is None:
            break
        proc.seen.append(line)
    if proc.proc.wait(timeout=60) != 0:
        raise AssertionError(f"CLI exited {proc.proc.returncode}: "
                             + "".join(proc.seen[-40:]))
    return proc.seen


def line_value(lines, prefix: str) -> str:
    """The rest of the last line that starts with ``prefix``."""
    hits = [x[len(prefix):].strip() for x in lines if x.startswith(prefix)]
    if not hits:
        raise AssertionError(f"no {prefix!r} line: " + "".join(lines[-30:]))
    return hits[-1]


def run_summary(path: str) -> dict:
    """The trainer's telemetry: its ``run_summary`` record and the
    ``step_ms`` of its ``train_step`` records (``--log_every=1``)."""
    records = [json.loads(x) for x in open(path)]
    (summary,) = [r for r in records if r.get("kind") == "run_summary"]
    steps = [r["data_wait_ms"] + r["compute_ms"] for r in records
             if r.get("kind") == "train_step"]
    return dict(summary=summary, step_ms=steps)


CHUNK_KERNELS = ("flash_attention_chunk", "flash_attention_chunk_dq",
                 "flash_attention_chunk_dkv")


def printed_launches(lines, task: int) -> tuple:
    """A trainer's ``kernel launches`` line as ``(launches, chunk
    launches)``: the ring's per-hop kernels K6/K7a/K7b apart from the
    rest."""
    both = json.loads(line_value(lines, f"Worker {task}: kernel launches"))
    return ({k: v for k, v in both.items() if k not in CHUNK_KERNELS},
            {k: both[k] for k in CHUNK_KERNELS})


def trainer_numbers(lines, metrics: str, task: int,
                    profile: str | None = None) -> dict:
    """A trainer process's numbers: its printed lines, its telemetry
    (``step_ms`` is data wait + compute, the step synchronised with the
    card each step) and, with ``--profile_dir``, its profile summary."""
    tele = run_summary(metrics)
    steady = tele["step_ms"][2:]
    step_ms = statistics.median(steady)
    out = dict(
        test_accuracy=float(line_value(lines, f"Worker {task}: test "
                                              "accuracy")),
        train_s=float(line_value(lines, "Training elapsed time:")
                      .rstrip(" s")),
        step_ms_median=step_ms, step_ms_mean=statistics.mean(steady),
        steps_per_s=1e3 / step_ms,
        steps=len(tele["step_ms"]),
        digest=line_value(lines, f"Worker {task}: parameter digest"))
    out["launches"], out["chunk_launches"] = printed_launches(lines, task)
    if profile is not None:
        with open(os.path.join(profile, "summary.json")) as fh:
            prof = json.load(fh)
        out.update(busy_share=prof["busy_share"],
                   profile_window_ms=prof["window_ms"],
                   device_busy_ms=prof["device_busy_ms"],
                   top_kernels=prof["top_kernels"][:5])
    return out


def reference_job(device: str, tmp: str, smi: str, workers: int = 2,
                  backend: str = "gloo", *extra, label: str = "reference",
                  profile: bool = True) -> dict:
    """The reference job, ``examples/launch_local_cluster.sh``'s flags:
    one PS and ``workers`` sync workers, MNIST MLP at the reference's
    width, one all-reduce a step over ``backend`` (the one the workers
    must print).  ``device``: ``cuda:0`` puts every worker on the one card
    (gloo), ``cuda`` gives worker i card i (NCCL with a card each).
    ``extra``: more flags (``--fsdp=true``); ``label`` names its logdir,
    files and output line (``trainer_<label>``); ``profile``: the
    workers' ``--profile_dir``."""
    ps_port = free_port()
    ports = [free_port() for _ in range(workers)]
    T = TRAINER
    logdir = os.path.join(tmp, label)
    prof_dir = os.path.join(tmp, f"{label}_profile")
    common = [f"--ps_hosts=localhost:{ps_port}",
              "--worker_hosts=" + ",".join(f"localhost:{p}" for p in ports),
              f"--data_dir={os.path.join(tmp, 'no-mnist')}",
              f"--train_steps={T['steps']}", f"--batch_size={T['batch']}",
              f"--hidden_units={T['hidden']}",
              f"--learning_rate={T['lr']}", "--sync_replicas=true",
              "--log_every=1", f"--logdir={logdir}", f"--device={device}",
              f"--metrics_file={os.path.join(tmp, label + '.jsonl')}",
              *([f"--profile_dir={prof_dir}"] if profile else []), *extra]
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        ps = stack.enter_context(CliProcess(
            "train", "--job_name=ps", "--task_index=0", *common))
        # The non-chiefs first: they wait for the chief's init signal.
        procs = {t: stack.enter_context(CliProcess(
            "train", "--job_name=worker", f"--task_index={t}", *common))
            for t in [*range(1, workers), 0]}
        outs = {t: finish(procs[t], 300) for t in range(workers)}
        ps_alive = ps.proc.poll() is None
    wall_s = time.perf_counter() - t0
    if not ps_alive:
        raise AssertionError("the PS exited before it was stopped: "
                             + "".join(ps.seen[-20:]))
    for task, lines in outs.items():
        text = "".join(lines)
        want = "Initailizing session" if task == 0 else "Waiting for session"
        for needle in (want, f"Worker {task}: test accuracy",
                       "Training elapsed time", f" over {backend} "):
            if needle not in text:
                raise AssertionError(f"worker {task}: no {needle!r}: "
                                     + text[-3000:])
    nums = [trainer_numbers(outs[t], os.path.join(
        tmp, f"{label}.jsonl.task{t}"), t, os.path.join(prof_dir, f"task{t}")
        if profile else None) for t in range(workers)]
    digests = {n["digest"] for n in nums}
    if len(digests) != 1:
        raise AssertionError(f"worker parameters differ: digests {digests}")
    acc = nums[0]["test_accuracy"]
    if abs(acc - T["jax_cpu_test_accuracy"]) > T["accuracy_tol"]:
        raise AssertionError(
            f"test accuracy {acc}, the JAX CLI's {T['jax_cpu_test_accuracy']}"
            f" (tol {T['accuracy_tol']})")
    allreduce = line_value(outs[0], "Worker 0: all-reduce")
    ar_ms = float(allreduce.split(" ms")[0])
    emit(f"trainer_{label}", card=smi, wall_s=wall_s, workers_n=workers,
         flags=list(extra),
         jax_cpu_test_accuracy=T["jax_cpu_test_accuracy"],
         accuracy_tol=T["accuracy_tol"],
         bring_up=line_value(outs[0], "Worker 0: process group"),
         allreduce=allreduce, allreduce_ms=ar_ms,
         allreduce_share_of_step=ar_ms / nums[0]["step_ms_median"],
         workers=nums)
    return nums[0]


def eval_and_generate(dev, common: list, logdir: str, nums: dict,
                      steps: int, gen_tokens: int, gen_flags=(),
                      name: str = "gpt_mini", n_virtual: int = 1) -> dict:
    """``--mode=eval`` and ``--mode=generate`` on a trainer CLI's logdir
    (``common``: its flags).  They read the same checkpoint, so they run
    side by side, each wall time from their common start to its own end.
    Gates: eval restores step ``steps`` and reports the trained process's
    test accuracy; generate's tokens are an in-process decode of the
    restored tree (its EMA parameters where it has them; a pipelined
    run's stage-stacked tree, namespace ``name``, merged) through the
    kernels.  ``gen_flags``: the run's pipeline flags, which name its
    checkpoint namespace and layout."""
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.tools.checkpoint_io import (
        restore_raw)
    from distributed_tensorflow_tpu_torch.tools.export_model import (
        kernel_config, merge_if_pipelined)
    device = next(a for a in common if a.startswith("--device="))
    prompt = list(range(1, 17))
    t0 = time.perf_counter()
    with CliProcess("train", *common, "--mode=eval") as proc, \
            CliProcess("train", "--mode=generate", "--model=gpt_mini",
                       f"--logdir={logdir}", device, *gen_flags,
                       f"--gen_tokens={gen_tokens}",
                       "--gen_prompt=" + ",".join(map(str, prompt))) as gen:
        eval_lines = finish(proc, 300)
        gen_lines = finish(gen, 300)
    eval_s, gen_s = proc.ended - t0, gen.ended - t0
    eval_acc = float(line_value(eval_lines, "Worker 0: test accuracy"))
    if eval_acc != nums["test_accuracy"]:
        raise AssertionError(f"--mode=eval test accuracy {eval_acc}, the "
                             f"trained process's {nums['test_accuracy']}")
    restored = int(line_value(eval_lines, "Worker 0: restored global step"))
    if restored != steps:
        raise AssertionError(f"--mode=eval restored step {restored}, "
                             f"expected {steps}")
    got = [int(t) for t in line_value(gen_lines,
                                      "Generated tokens:").split()]
    tree = restore_raw(os.path.join(logdir, name))[0]
    params = merge_if_pipelined(tree.get("ema_params") or tree["params"],
                                n_virtual)
    cfg = dataclasses.replace(gpt.mini(), **gpt.infer_widths(params))
    with _BUSY_LOCK:            # outside any part's in-process profile
        model = gpt.GptLM(kernel_config(cfg), device=dev)
        model.load_state_dict(gpt.params_from_jax(params))
        want = gpt.generate_cached(
            model, None, torch.tensor([prompt], dtype=torch.int32),
            gen_tokens)[0, len(prompt):].tolist()
    if got != want:
        raise AssertionError(f"--mode=generate tokens {got}, in process "
                             f"{want}")
    del model
    torch.cuda.empty_cache()
    return dict(eval_wall_s=eval_s, generate_wall_s=gen_s,
                eval_test_accuracy=eval_acc,
                eval_validation_accuracy=float(line_value(
                    eval_lines, "Worker 0: validation accuracy")),
                generated=got)


def gpt_trainer_busy(dev) -> dict:
    with _BUSY_LOCK:
        return _gpt_trainer_busy(dev)


def _gpt_trainer_busy(dev) -> dict:
    """The busy share of the trainer's gpt_mini step: the bundle the CLI
    builds from its flags (``models/registry.build``) and its sync step,
    one step profiled in this process after three (the CLI's own
    ``--profile_dir`` would add the profiler's start and its trace export,
    ~45 s, to the phase)."""
    import types
    from distributed_tensorflow_tpu_torch.models import registry
    from distributed_tensorflow_tpu_torch.parallel.sync import (
        build_sync_train_step)
    from distributed_tensorflow_tpu_torch.training.loop import to_device
    T = TRAINER
    flags = types.SimpleNamespace(
        learning_rate=0.01, seed=0, bert_seq_len=T["gpt_seq"],
        attention_backend="pallas", fused_layer_norm=True,
        bert_dtype="bfloat16", optimizer="")
    bundle = registry.build("gpt_mini", flags, dev)
    step = build_sync_train_step(bundle.loss_fn)
    data = bundle.load_datasets(None).train
    state = bundle.state
    for _ in range(3):
        state, metrics = step(state, to_device(
            data.next_batch(T["gpt_batch"]), dev))
    float(metrics["loss"])
    out = profile_train_step(step, state, to_device(
        data.next_batch(T["gpt_batch"]), dev))
    del bundle, state
    return out


def gpt_trainer(dev, tmp: str, smi: str) -> dict:
    """gpt_mini at mini()'s full width through the trainer CLI (one
    worker, no PS: the reference's config #1, the worker hosting the
    coordination service) on the hand-written kernels, then
    ``--mode=eval`` and ``--mode=generate`` on its checkpoint."""
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt
    T = TRAINER
    logdir = os.path.join(tmp, "gpt")
    common = ["--model=gpt_mini", "--attention_backend=pallas",
              "--fused_layer_norm", f"--bert_seq_len={T['gpt_seq']}",
              f"--batch_size={T['gpt_batch']}", f"--logdir={logdir}",
              f"--device={dev}", "--job_name=worker", "--task_index=0",
              f"--worker_hosts=localhost:{free_port()}", "--ps_hosts=",
              "--sync_replicas=true"]
    t0 = time.perf_counter()
    with CliProcess("train", *common, f"--train_steps={T['gpt_steps']}",
                    f"--save_interval_steps={T['gpt_save']}",
                    "--log_every=1",
                    f"--metrics_file={os.path.join(tmp, 'gpt.jsonl')}"
                    ) as proc:
        lines = finish(proc, 400)
    train_wall_s = time.perf_counter() - t0
    nums = trainer_numbers(lines, os.path.join(tmp, "gpt.jsonl"), 0)
    losses = [float(x.split(" loss ")[1].split()[0]) for x in lines
              if x.startswith("Worker 0: traing step")]
    steps = nums["steps"]
    if steps != T["gpt_steps"] - 1 or len(losses) != steps:
        raise AssertionError(f"{steps} steps, {len(losses)} loss lines; "
                             f"expected {T['gpt_steps'] - 1}")
    if not (all(map(math.isfinite, losses))
            and statistics.mean(losses[-5:]) < losses[0]):
        raise AssertionError(f"gpt_mini loss did not fall: {losses}")
    L = gpt.mini().num_layers
    # Each train step: K1, K2a, K2b once a layer, K3 twice a layer and
    # once at the end; each eval forward (the validation at step 0 and the
    # final test, ``make_lm_eval_fn``'s 4 batches each) K1 and K3 as a
    # step's forward.
    forwards = steps + 2 * 4
    want = {"flash_attention_fwd": L * forwards,
            "flash_attention_bwd_dq": L * steps,
            "flash_attention_bwd_dkv": L * steps,
            "layer_norm_fwd": (2 * L + 1) * forwards,
            "quant_matmul": 0, "quant_matmul_nt": 0}
    if nums["launches"] != want:
        raise AssertionError(f"trainer launches {nums['launches']}, "
                             f"expected {want}")
    peak_gib = float(line_value(lines, "Worker 0: peak device memory")
                     .split()[0])

    after = eval_and_generate(dev, common, logdir, nums, T["gpt_steps"],
                              T["gen_tokens"])
    profiled = gpt_trainer_busy(dev)
    torch.cuda.empty_cache()
    tokens = T["gpt_batch"] * T["gpt_seq"]
    emit("trainer_gpt", card=smi, train_wall_s=train_wall_s,
         batch=T["gpt_batch"], seq_len=T["gpt_seq"], loss_first=losses[0],
         loss_last5_mean=statistics.mean(losses[-5:]),
         tokens_per_s=tokens / (nums["step_ms_median"] / 1e3),
         peak_mem_gib=peak_gib, launches_expected=want,
         busy_share=profiled["busy_share"], **after, **nums)
    emit("trainer_gpt_profile", **profiled)
    return nums["launches"]


def trainer(dev, smi: str) -> tuple:
    """Phase ``trainer``: the port's CLI trainer as processes (the
    reference job, the same with ``--fsdp``, gpt_mini with eval and
    generate) and, beside them, the ``async_trainer`` phase's jobs
    (``async_gpt``, and the two MNIST jobs of :func:`async_trainer`; each
    job's worker 0 paced past its peer's start).  Returns the gpt_mini
    run's and ``async_gpt``'s kernel launches."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        # The reference job and the same job with --fsdp (hid/kernel [784,
        # 100] sharded over the two workers) side by side; the FSDP job's
        # accuracy within TRAINER's tolerance of the replicated job's.
        # gpt_mini's trainer CLI and the async gpt_mini pair beside them.
        t0 = time.perf_counter()
        plain, fsdp, launches, async_launches, _ = side_by_side(
            (reference_job, str(dev), tmp, smi),
            (lambda: reference_job(str(dev), tmp, smi, 2, "gloo",
                                   "--fsdp=true", label="reference_fsdp",
                                   profile=False),),
            (gpt_trainer, dev, tmp, smi), (async_gpt, dev, tmp, smi),
            (async_trainer, dev, smi))
        emit("trainer_group", seconds=time.perf_counter() - t0,
             side_by_side=["trainer_reference", "trainer_reference_fsdp",
                           "trainer_gpt", "async_gpt", "async_reference",
                           "async_overlap"])
        gap = abs(fsdp["test_accuracy"] - plain["test_accuracy"])
        if gap > TRAINER["accuracy_tol"]:
            raise AssertionError(
                f"--fsdp reference job: test accuracy "
                f"{fsdp['test_accuracy']}, the replicated job's "
                f"{plain['test_accuracy']} (tol {TRAINER['accuracy_tol']})")
        return launches, async_launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------- the config ladder (7b)


def model_flags(**kw):
    """The trainer's flags for ``registry.build`` of a ladder model (its
    transformers on the kernels: ``--attention_backend=pallas
    --fused_layer_norm``)."""
    import types
    base = dict(learning_rate=1e-3, seed=SEED, optimizer="",
                hidden_units=TRAINER["hidden"],
                bert_seq_len=MODELS["bert_seq"], attention_backend="pallas",
                fused_layer_norm=True, bert_dtype="bfloat16")
    base.update(kw)
    return types.SimpleNamespace(**base)


def no_data_dir() -> str:
    """A data directory that holds nothing: the MNIST and CIFAR readers
    fall back to their deterministic synthetic stand-ins."""
    return os.path.join(tempfile.gettempdir(), "chip_smoke_no_data")


def check_model_step(dev, bundle, batch) -> dict:
    """One step's loss and gradients of a ladder transformer through the
    kernels (K1, K2a/K2b, K3) against the same step on their plain
    versions (dense attention, plain LayerNorm) from the same weights and
    batch, within the TRAIN_* tolerances (under the busy lock, as every
    launch of this phase: :func:`model_steps`)."""
    import torch
    model = bundle.state.model
    plain = type(model)(dataclasses.replace(
        model.cfg, attention_backend="xla", fused_ln=False), device=dev)
    plain.load_state_dict(model.state_dict())
    tols = (TRAIN_LOSS_TOL, TRAIN_GRAD_NORM_RTOL, TRAIN_GRAD_MIN_COS)
    with _BUSY_LOCK:
        out = compare_steps(step_grads(model, bundle.loss_fn, batch),
                            step_grads(plain, bundle.loss_fn, batch), tols)
    del plain
    torch.cuda.empty_cache()
    return dict(out, loss_tol=tols[0], grad_norm_rtol=tols[1],
                grad_min_cos=tols[2])


def model_steps(name, step, state, batches) -> dict:
    """``step`` over the batches (on the card already) with the launch
    counters set to 0 just before and read just after; the loss finite
    and falling (the mean of the last five below the first: Adam's first
    steps overshoot on ViT's synthetic CIFAR)."""
    import torch
    # Under the busy lock, as every launch of the phase: the parts beside
    # it launch kernels in this process only under it (their in-process
    # decodes and busy profiles).
    with _BUSY_LOCK:
        torch.cuda.synchronize()
        reset_launch_counts()
        losses, step_ms, aux = [], [], []
        for batch in batches:
            t = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))      # waits for the step
            step_ms.append((time.perf_counter() - t) * 1e3)
            if "moe_aux" in metrics:
                aux.append(float(metrics["moe_aux"]))
        launches = launch_counts()
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    last5 = statistics.mean(losses[-5:])
    if not last5 < losses[0]:
        raise AssertionError(f"{name}: loss did not fall: {losses}")
    return dict(state=state, launches=launches, losses=losses,
                loss_first=losses[0], loss_last5_mean=last5,
                step_ms=step_ms, step_ms_median=statistics.median(
                    step_ms[2:]), **({"moe_aux": aux} if aux else {}))


def train_transformer(dev, smi: str, name: str) -> dict:
    """BERT-tiny or ViT-tiny through ``registry.build`` on the kernels:
    the kernel-vs-plain step, then ``MODELS["steps"]`` sync steps with
    launches exactly K1, K2a and K2b once a layer and K3 at every
    LayerNorm of a forward (BERT: ln_emb, two a layer, mlm_ln; ViT: two a
    layer, ln_final)."""
    import torch
    from distributed_tensorflow_tpu_torch.models import registry
    from distributed_tensorflow_tpu_torch.parallel.sync import (
        build_sync_train_step)
    from distributed_tensorflow_tpu_torch.training.loop import to_device
    M = MODELS
    t0 = time.perf_counter()
    bundle = registry.build(name, model_flags(), dev)
    data = bundle.load_datasets(no_data_dir()).train
    checked = check_model_step(dev, bundle,
                               to_device(data.next_batch(M["batch"]), dev))
    batches = [to_device(data.next_batch(M["batch"]), dev)
               for _ in range(M["steps"])]
    step = build_sync_train_step(bundle.loss_fn)
    setup_s = time.perf_counter() - t0
    run = model_steps(name, step, bundle.state, batches)
    cfg = bundle.state.model.cfg
    L = cfg.num_layers
    per_step = {"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L,
                "layer_norm_fwd": 2 * L + (2 if name == "bert_tiny" else 1)}
    expect_launches(name, run["launches"], per_step, M["steps"])
    seq = M["bert_seq"] if name == "bert_tiny" else M["vit_patches"]
    state = run.pop("state")
    del bundle, state, batches
    torch.cuda.empty_cache()
    short = name.split("_")[0]
    emit(f"train_models_{short}", card=smi, model=name, batch=M["batch"],
         seq_len=seq, heads=cfg.num_heads, head_dim=cfg.head_dim,
         layers=L, optimizer="adam", lr=1e-3, launches_per_step=per_step,
         kernel_vs_plain=checked, setup_s=setup_s,
         tokens_per_s=M["batch"] * seq / (run["step_ms_median"] / 1e3),
         **run)
    return run["launches"]


def train_cnn(dev, smi: str, name: str) -> None:
    """ResNet-20 (its stateful sync step: BatchNorm's running statistics
    must move) or LeNet-5 on the card, ``MODELS["steps"]`` steps of SGD
    at the CLI's batch; neither reaches a kernel (their convolutions and
    products are cuDNN and cuBLAS calls, XLA ops in JAX), so every launch
    counter stays at 0."""
    import torch
    from distributed_tensorflow_tpu_torch.models import registry
    from distributed_tensorflow_tpu_torch.parallel import sync
    from distributed_tensorflow_tpu_torch.training.loop import to_device
    M = MODELS
    lr = M["lenet_lr"] if name == "lenet5" else M["cnn_lr"]
    bundle = registry.build(name, model_flags(learning_rate=lr), dev)
    data = bundle.load_datasets(no_data_dir()).train
    batches = [to_device(data.next_batch(M["batch"]), dev)
               for _ in range(M["steps"])]
    if bundle.stateful_loss_fn is not None:
        step = sync.build_stateful_sync_train_step(bundle.stateful_loss_fn)
    else:
        step = sync.build_sync_train_step(bundle.loss_fn)
    stats = bundle.state.model_state or {}
    before = {k: v.clone() for k, v in stats.items()}
    run = model_steps(name, step, bundle.state, batches)
    run.pop("state")
    if any(run["launches"].values()):
        raise AssertionError(f"{name} launched kernels: {run['launches']}")
    moved = {k: (stats[k] - v).abs().max().item() for k, v in before.items()}
    if stats and not max(moved.values()) > 0:
        raise AssertionError(f"{name}: the running statistics did not move")
    del bundle, batches
    torch.cuda.empty_cache()
    emit(f"train_models_{name}", card=smi, model=name, batch=M["batch"],
         optimizer="sgd", lr=lr,
         images_per_s=M["batch"] / (run["step_ms_median"] / 1e3),
         running_stats_max_move=max(moved.values()) if moved else None,
         **run)


def train_models(dev, smi: str) -> dict:
    """Phase ``train_models``: the ladder's models in this process at
    their published widths.  Returns BERT's and ViT's launches, by path."""
    t0 = time.perf_counter()
    out = {"train_models_bert": train_transformer(dev, smi, "bert_tiny"),
           "train_models_vit": train_transformer(dev, smi, "vit_tiny")}
    out.update(train_bert_moe(dev, smi))
    train_cnn(dev, smi, "resnet20")
    train_cnn(dev, smi, "lenet5")
    emit("train_models_done", seconds=time.perf_counter() - t0)
    return out


def train_bert_moe(dev, smi: str) -> dict:
    """``train_models_bert_moe``: BERT-tiny with ``MODELS["experts"]``
    experts (top-2, capacity factor 2) through ``registry.build`` on the
    kernels, as :func:`train_transformer` drives BERT-tiny (the
    kernel-vs-plain step, ``MODELS["steps"]`` steps, launches exactly
    K1/K2a/K2b once a layer and K3 6 a step, the loss falling), the aux
    loss a step; then each arm of ``MODELS["expert_arms"]``: the same
    weights with the stacked experts split over that many expert
    positions on this card, its first step within TRAIN_* of the
    unsharded step, then ``MODELS["arm_steps"]`` steps with exact
    launches.  Returns each run's launches, by path."""
    import torch
    from distributed_tensorflow_tpu_torch.models import registry
    from distributed_tensorflow_tpu_torch.parallel import mesh as mesh_lib
    from distributed_tensorflow_tpu_torch.parallel.sync import (
        build_sync_train_step)
    from distributed_tensorflow_tpu_torch.training.loop import to_device
    M = MODELS
    t0 = time.perf_counter()
    flags = model_flags(num_experts=M["experts"])
    bundle = registry.build("bert_moe", flags, dev)
    data = bundle.load_datasets(no_data_dir()).train
    batches = [to_device(data.next_batch(M["batch"]), dev)
               for _ in range(M["steps"])]
    checked = check_model_step(dev, bundle, batches[0])
    tols = (TRAIN_LOSS_TOL, TRAIN_GRAD_NORM_RTOL, TRAIN_GRAD_MIN_COS)
    # The arms start from the unsharded model's weights before it trains.
    weights = {k: v.clone() for k, v in
               bundle.state.model.state_dict().items()}
    with _BUSY_LOCK:
        first = step_grads(bundle.state.model, bundle.loss_fn, batches[0])
    setup_s = time.perf_counter() - t0
    run = model_steps("bert_moe", build_sync_train_step(bundle.loss_fn),
                      bundle.state, batches)
    cfg = bundle.state.model.cfg
    L = cfg.num_layers
    per_step = {"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L, "layer_norm_fwd": 2 * L + 2}
    expect_launches("bert_moe", run["launches"], per_step, M["steps"])
    run.pop("state")
    del bundle
    out = {"train_models_bert_moe": run["launches"]}
    arms = {}
    for ep in M["expert_arms"]:
        arm = registry.build("bert_moe", flags, dev)
        arm.state.model.load_state_dict(weights)
        mesh = mesh_lib.create_mesh(data=1, expert=ep, devices=[dev] * ep)
        state = mesh_lib.ParallelConfig(data=1, expert=ep).place_state(
            mesh, arm.state, arm.sharding_rules)
        with _BUSY_LOCK:
            cmp = compare_steps(step_grads(state.model, arm.loss_fn,
                                           batches[0]), first, tols,
                                names=(f"ep{ep}", "ep1"))
        r = model_steps(f"bert_moe_ep{ep}",
                        build_sync_train_step(arm.loss_fn), state,
                        batches[:M["arm_steps"]])
        expect_launches(f"bert_moe_ep{ep}", r["launches"], per_step,
                        M["arm_steps"])
        r.pop("state")
        del arm, state
        arms[f"ep{ep}"] = dict(
            first_step=cmp, step_ms_median=r["step_ms_median"],
            ratio_to_unsharded=r["step_ms_median"] / run["step_ms_median"],
            # Each MoE layer's forward sends the dispatched rows to the
            # ep positions and brings ep outputs back; the backward
            # returns each: copies a step, by the module's structure.
            dispatch_copies_per_step=4 * ep * L,
            loss_first=r["loss_first"], loss_last5_mean=r["loss_last5_mean"],
            moe_aux=r["moe_aux"], launches=r["launches"])
        out[f"train_models_bert_moe_ep{ep}"] = r["launches"]
    torch.cuda.empty_cache()
    emit("train_models_bert_moe", card=smi, model="bert_moe",
         experts=M["experts"], top_k=cfg.moe_top_k,
         capacity_factor=cfg.moe_capacity_factor, batch=M["batch"],
         seq_len=M["bert_seq"], heads=cfg.num_heads, head_dim=cfg.head_dim,
         layers=L, optimizer="adam", lr=1e-3, launches_per_step=per_step,
         kernel_vs_plain=checked, setup_s=setup_s,
         tokens_per_s=M["batch"] * M["bert_seq"]
         / (run["step_ms_median"] / 1e3), expert_arms=arms, **run)
    return out


def ladder_job(dev, tmp: str, label: str, model: str, workers: int,
               *extra, steps: int | None = None) -> dict:
    """One rung through the trainer CLI: ``workers`` workers (no PS: the
    chief hosts the coordination service) started together on the card,
    the CLI's default batch; each worker's lines and numbers."""
    M = MODELS
    ports = [free_port() for _ in range(workers)]
    metrics = os.path.join(tmp, label + ".jsonl")
    common = ["--ps_hosts=", "--worker_hosts=" + ",".join(
        f"localhost:{p}" for p in ports), f"--data_dir={no_data_dir()}",
        f"--model={model}", f"--train_steps={steps or M['cli_steps']}",
        f"--batch_size={M['batch']}", "--log_every=1",
        f"--logdir={os.path.join(tmp, label)}", f"--device={dev}",
        f"--metrics_file={metrics}", *extra]
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        procs = {t: stack.enter_context(CliProcess(
            "train", "--job_name=worker", f"--task_index={t}", *common))
            for t in [*range(1, workers), 0]}
        outs = {t: finish(procs[t], 300) for t in range(workers)}
    wall_s = time.perf_counter() - t0
    nums = []
    for t in range(workers):
        path = metrics + (f".task{t}" if workers > 1 else "")
        n = trainer_numbers(outs[t], path, t)
        n["losses"] = [float(x.split(" loss ")[1].split()[0])
                       for x in outs[t]
                       if x.startswith(f"Worker {t}: traing step")]
        if not (n["losses"] and all(map(math.isfinite, n["losses"]))):
            raise AssertionError(f"{label} worker {t}: losses {n['losses']}"
                                 + "".join(outs[t][-30:]))
        nums.append(n)
    return dict(common=common, wall_s=wall_s, text={
        t: "".join(lines) for t, lines in outs.items()}, workers=nums)


def ladder_lenet(dev, tmp: str, smi: str) -> None:
    """LeNet-5, async (``--sync_replicas=false``): two workers, each a
    replica, averaging every ``async_period`` local steps through the
    coordination service; paced as the async MNIST jobs are, so that
    their windows overlap."""
    M = MODELS
    out = ladder_job(dev, tmp, "ladder_lenet", "lenet5", 2,
                     "--sync_replicas=false",
                     f"--async_sync_period={M['async_period']}",
                     f"--learning_rate={M['lenet_lr']}",
                     f"--inject_step_delay={ASYNC['overlap_pace_s']}:0:"
                     "1000000000", steps=4 * M["cli_steps"])
    both = out["text"][0] + out["text"][1]
    if "averaged parameters with 1 peer(s)" not in both:
        raise AssertionError("ladder lenet5: no averaging: " + both[-3000:])
    for n in out["workers"]:
        if any(n["launches"].values()):
            raise AssertionError(f"ladder lenet5 launched {n['launches']}")
    emit("ladder_lenet5", card=smi, wall_s=out["wall_s"],
         averaged_lines=both.count("averaged parameters with 1 peer(s)"),
         workers=out["workers"])
    return {}


def ladder_resnet(dev, tmp: str, smi: str) -> None:
    """ResNet-20, sync over two gloo workers on the one card: BatchNorm's
    statistics over both workers' rows, so the parameters AND the
    running statistics stay bit-equal (equal digests); then
    ``--mode=eval`` restores the checkpoint, its running statistics
    included, and reports the trained run's test accuracy."""
    M = MODELS
    out = ladder_job(dev, tmp, "ladder_resnet", "resnet20", 2,
                     "--sync_replicas=true",
                     f"--learning_rate={M['cnn_lr']}")
    for key in ("parameter digest", "model state digest"):
        digests = {line_value(out["text"][t].splitlines(keepends=True),
                              f"Worker {t}: {key}") for t in (0, 1)}
        if len(digests) != 1:
            raise AssertionError(f"ladder resnet20: {key}s differ: "
                                 f"{digests}")
    if " over gloo " not in out["text"][0]:
        raise AssertionError("ladder resnet20: no gloo group: "
                             + out["text"][0][-3000:])
    eval_s, acc = eval_restores("ladder resnet20", out)
    emit("ladder_resnet20", card=smi, wall_s=out["wall_s"],
         eval_wall_s=eval_s, eval_test_accuracy=acc,
         digest=out["workers"][0]["digest"],
         model_state_digest=line_value(
             out["text"][0].splitlines(keepends=True),
             "Worker 0: model state digest"),
         workers=out["workers"])
    return {}


def eval_restores(label: str, out: dict, *extra) -> tuple:
    """``--mode=eval`` with a ladder job's worker-0 flags (a cluster of
    one; ``extra`` added): it must restore the trained step and report
    the trained process's test accuracy.  Returns (wall s, accuracy)."""
    worker0 = [f"--worker_hosts=localhost:{free_port()}" if a.startswith(
        "--worker_hosts") else a for a in out["common"]
        if not a.startswith("--metrics_file")]
    t0 = time.perf_counter()
    with CliProcess("train", "--job_name=worker", "--task_index=0",
                    *worker0, *extra, "--mode=eval") as proc:
        lines = finish(proc, 300)
    eval_s = time.perf_counter() - t0
    restored = int(line_value(lines, "Worker 0: restored global step"))
    acc = float(line_value(lines, "Worker 0: test accuracy"))
    want = out["workers"][0]["test_accuracy"]
    if restored != MODELS["cli_steps"] or acc != want:
        raise AssertionError(f"{label} --mode=eval: step {restored}, test "
                             f"accuracy {acc}; trained {want} at step "
                             f"{MODELS['cli_steps']}")
    return eval_s, acc


def ladder_transformer(dev, tmp: str, smi: str, name: str, *extra) -> dict:
    """BERT-tiny, BERT-MoE or ViT-tiny through the CLI on the kernels (one
    worker): launches exactly a step's and an eval forward's (the
    validation at step 0 and the final test: BERT's 4 fixed batches
    each, ViT's whole split in one forward), the loss finite (its fall is
    ``train_models``' gate, over more steps).  BERT-MoE then restores its
    checkpoint through ``--mode=eval`` with the same flags."""
    M = MODELS
    out = ladder_job(dev, tmp, f"ladder_{name}", name, 1,
                     "--sync_replicas=true", "--attention_backend=pallas",
                     "--fused_layer_norm", f"--bert_seq_len={M['bert_seq']}",
                     *extra)
    n = out["workers"][0]
    steps = n["steps"]
    bert = name.startswith("bert")
    L = 2 if bert else 4
    ln = 2 * L + (2 if bert else 1)
    forwards = steps + 2 * (4 if bert else 1)
    want = {"flash_attention_fwd": L * forwards,
            "flash_attention_bwd_dq": L * steps,
            "flash_attention_bwd_dkv": L * steps,
            "layer_norm_fwd": ln * forwards,
            "quant_matmul": 0, "quant_matmul_nt": 0}
    if steps != M["cli_steps"] - 1 or n["launches"] != want:
        raise AssertionError(f"ladder {name}: {steps} steps, launches "
                             f"{n['launches']}, expected {want}")
    restored = {}
    if name == "bert_moe":
        if "Worker 0: mesh dp-1-ep2-mb1 (expert=2," not in out["text"][0]:
            raise AssertionError("ladder bert_moe: no expert mesh: "
                                 + out["text"][0][-3000:])
        # A trained accuracy above 0, so that the restore's equal
        # accuracy is not 0 == 0.
        if not n["test_accuracy"] > 0.0:
            raise AssertionError(f"ladder bert_moe: test accuracy "
                                 f"{n['test_accuracy']}")
        eval_s, acc = eval_restores("ladder bert_moe", out)
        restored = dict(eval_wall_s=eval_s, eval_test_accuracy=acc)
    emit(f"ladder_{name}", card=smi, wall_s=out["wall_s"], flags=list(extra),
         launches_expected=want, **restored, **n)
    key = "bert_moe" if name == "bert_moe" else name.split("_")[0]
    return {f"ladder_{key}": n["launches"]}


def ladder(dev, smi: str, *rungs) -> dict:
    """Phase ``ladder``: rungs of the config ladder through the trainer
    CLI (``(fn, *args)`` each), every rung its own processes, side by
    side.  Returns the transformers' launches, by path."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ladder_")
    t0 = time.perf_counter()
    try:
        done = side_by_side(*((fn, dev, tmp, smi, *args)
                              for fn, *args in rungs))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("ladder_done", seconds=time.perf_counter() - t0,
         rungs=[fn.__name__ for fn, *_ in rungs])
    return {k: v for launches in done for k, v in launches.items()}



# ------------------------------------------ items 7a and 7c (7c: above)


def repo_text() -> bytes:
    """This checkout's text: its top-level ``*.md`` and ``*.py`` files and
    the packages' and tests' ``*.py``, sorted, concatenated."""
    root = os.path.dirname(os.path.abspath(__file__))
    paths = [p for pattern in ("*.md", "*.py",
                               "distributed_tensorflow_tpu*/**/*.py",
                               "tests/*.py")
             for p in sorted(glob.glob(os.path.join(root, pattern),
                                       recursive=True))]
    out = []
    for p in paths:
        with open(p, "rb") as fh:
            out.append(fh.read())
    return b"".join(out)


def lm_bpe(dev, smi: str) -> dict:
    """Phase ``lm_bpe``: gpt_mini through the trainer CLI on a corpus
    that streams, BPE-encoded, with adafactor, on the kernels; then the
    run resumed from its checkpoint and cursor; then ``--mode=generate``
    from text.  Gates: the CLI's BPE table is the one the native core
    trains here from the same sample (training is a pure function of the
    bytes; the core raises rather than fall back), the launches exact in
    both runs, the cursor restored and moved on, and the generated text
    the saved tokenizer's decode of the generated tokens (cut at the stop
    text), the prompt its encoding, through K1 and K3.  Returns the two
    training runs' launches."""
    from distributed_tensorflow_tpu_torch.data.lm import (BPE_SAMPLE_BYTES,
                                                          CorpusFiles)
    from distributed_tensorflow_tpu_torch.data.tokenizer import (
        BpeTokenizer, native_library)
    from distributed_tensorflow_tpu_torch.models import gpt
    B = LM_BPE
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_bpe_")
    try:
        want = B["corpus_mb"] << 20
        text = repo_text()
        text = (text * -(-want // len(text)))[:want]
        data_dir = os.path.join(tmp, "corpus")
        os.makedirs(data_dir)
        path = os.path.join(data_dir, "corpus.txt")
        with open(path, "wb") as fh:
            fh.write(text)
        # The native core on this host, on the CLI's own sample and train
        # region.
        files = CorpusFiles([path])
        train_end = int(files.total * 0.9)
        sample = files.read(0, min(train_end, BPE_SAMPLE_BYTES))
        t0 = time.perf_counter()
        tok = BpeTokenizer.train(sample, B["vocab"])
        train_s = time.perf_counter() - t0
        region = files.read(0, train_end)
        t0 = time.perf_counter()
        ids = tok.encode(region)
        encode_s = time.perf_counter() - t0

        logdir = os.path.join(tmp, "run")
        common = ["--model=gpt_mini", "--attention_backend=pallas",
                  "--fused_layer_norm", "--gpt_tokenizer=bpe",
                  f"--gpt_bpe_vocab={B['vocab']}",
                  f"--gpt_stream_corpus_mb={B['stream_mb']}",
                  "--optimizer=adafactor", f"--learning_rate={B['lr']}",
                  f"--bert_seq_len={B['seq']}", f"--batch_size={B['batch']}",
                  f"--data_dir={data_dir}", f"--logdir={logdir}",
                  f"--device={dev}", "--job_name=worker", "--task_index=0",
                  f"--worker_hosts=localhost:{free_port()}", "--ps_hosts=",
                  "--sync_replicas=true",
                  f"--save_interval_steps={B['save']}", "--log_every=1"]
        L = gpt.mini().num_layers
        runs, launches = [], {}
        t_phase = time.perf_counter()
        for i, steps in enumerate((B["steps"], 2 * B["steps"])):
            metrics = os.path.join(tmp, f"run{i}.jsonl")
            t0 = time.perf_counter()
            with CliProcess("train", *common, f"--train_steps={steps}",
                            f"--metrics_file={metrics}") as proc:
                lines = finish(proc, 400)
            n = trainer_numbers(lines, metrics, 0)
            n["wall_s"] = time.perf_counter() - t0
            text_out = "".join(lines)
            if "gpt bpe streaming corpus" not in text_out:
                raise AssertionError("lm_bpe: the corpus did not stream: "
                                     + text_out[-3000:])
            restored = "restored streaming-corpus cursor" in text_out
            if restored != (i == 1):
                raise AssertionError(f"lm_bpe run {i}: cursor restored "
                                     f"{restored}: " + text_out[-3000:])
            # Each step K1/K2a/K2b once a layer and K3 2L+1; the eval
            # forwards (validation at the run's first step, the final
            # test: 4 batches each) K1 and K3 as a step's forward.
            forwards = n["steps"] + 2 * 4
            want = {"flash_attention_fwd": L * forwards,
                    "flash_attention_bwd_dq": L * n["steps"],
                    "flash_attention_bwd_dkv": L * n["steps"],
                    "layer_norm_fwd": (2 * L + 1) * forwards,
                    "quant_matmul": 0, "quant_matmul_nt": 0}
            if n["launches"] != want:
                raise AssertionError(f"lm_bpe run {i} launches "
                                     f"{n['launches']}, expected {want}")
            for k, v in n["launches"].items():
                launches[k] = launches.get(k, 0) + v
            with open(os.path.join(logdir, "gpt_mini",
                                   "data_cursor_p0.json")) as fh:
                n["cursor"] = json.load(fh)
            n["losses"] = [float(x.split(" loss ")[1].split()[0])
                           for x in lines
                           if x.startswith("Worker 0: traing step")]
            runs.append(n)
        if runs[1]["cursor"] == runs[0]["cursor"]:
            raise AssertionError("lm_bpe: the resumed run's cursor did not "
                                 f"move: {runs[1]['cursor']}")
        saved = BpeTokenizer.load(os.path.join(logdir, "gpt_mini",
                                               "tokenizer.json"))
        if saved.merges != tok.merges:
            raise AssertionError("lm_bpe: the CLI's BPE table is not the "
                                 "native core's on the same sample")

        t0 = time.perf_counter()
        with CliProcess("train", *common, "--mode=generate",
                        f"--gen_tokens={B['gen_tokens']}",
                        f"--gen_prompt_text={B['prompt']}",
                        f"--gen_stop_text={B['stop']}") as gen:
            gen_lines = finish(gen, 300)
        gen_s = time.perf_counter() - t0
        prompt = [int(t) for t in line_value(gen_lines,
                                             "Prompt tokens:").split()]
        got = [int(t) for t in line_value(gen_lines,
                                          "Generated tokens:").split()]
        printed = line_value(gen_lines, "Generated text:")
        decoded = saved.decode(got).decode("utf-8", errors="replace")
        decoded = decoded.split(B["stop"], 1)[0]
        gen_launches = json.loads(line_value(gen_lines, "Kernel launches:"))
        if prompt != saved.encode(B["prompt"].encode()).tolist():
            raise AssertionError(f"lm_bpe generate: prompt ids {prompt}")
        if printed != repr(decoded):
            raise AssertionError(f"lm_bpe generate: text {printed}, the "
                                 f"tokenizer decodes {decoded!r}")
        if not (gen_launches["flash_attention_fwd"]
                and gen_launches["layer_norm_fwd"]):
            raise AssertionError(f"lm_bpe generate launches {gen_launches}")
        emit("lm_bpe", card=smi, corpus_bytes=len(text),
             native_tokenizer=native_library(), vocab=tok.vocab_size,
             bpe_train_mb_per_s=len(sample) / 2 ** 20 / train_s,
             bpe_encode_mb_per_s=len(region) / 2 ** 20 / encode_s,
             bpe_train_s=train_s, bpe_encode_s=encode_s,
             bytes_per_token=len(region) / len(ids), batch=B["batch"],
             seq_len=B["seq"], optimizer="adafactor",
             wall_s=time.perf_counter() - t_phase, runs=runs,
             generate_wall_s=gen_s, generated_text=printed,
             generate_launches=gen_launches)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_optimizers(dev, smi: str) -> dict:
    """Phase ``train_optimizers``: the train phase's step (GPT-406M
    width, B=8, S=1024, fp32 masters) under each optimizer of
    ``OPTIMIZERS``, ``OPTIMIZERS["steps"]`` steps each: step ms, the
    optimizer update's ms alone (after a backward, between two
    synchronisations), the slot bytes, the peak.  Gate: adafactor's
    slots on the matrices it factors under 1% of adam's.  Returns the
    steps' launches."""
    import torch
    from distributed_tensorflow_tpu_torch.data.lm import make_lm_datasets
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.parallel.sync import (
        build_sync_train_step)
    from distributed_tensorflow_tpu_torch.training.optimizers import (
        _factored_dims, make_optimizer)
    from distributed_tensorflow_tpu_torch.training.state import TrainState
    O = OPTIMIZERS
    t0 = time.perf_counter()
    B, S = TRAIN["batch"], TRAIN["seq_len"]
    cfg = gpt.GptConfig(**WIDTH)
    model = gpt.GptLM(cfg, device=dev, seed=SEED, param_dtype=torch.float32)
    data = make_lm_datasets(cfg, seq_len=S).train

    def loss_fn(m, batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        loss, acc = gpt.lm_loss(m(tokens), tokens)
        return loss, {"accuracy": acc}

    batches = [data.next_batch(B) for _ in range(O["steps"] + 1)]
    # Every optimizer starts from the same weights.
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    out, slots, launches = {}, {}, {}
    for name in O["names"]:
        model.load_state_dict(weights)
        state = TrainState.create(model, make_optimizer(name, O["lr"]))
        step = build_sync_train_step(loss_fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        step_ms, losses = [], []
        for batch in batches[:O["steps"]]:
            t = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            step_ms.append((time.perf_counter() - t) * 1e3)
        for k, v in launch_counts().items():
            launches[k] = launches.get(k, 0) + v
        # The update alone: a backward, then the optimizer between two
        # synchronisations.
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, batches[-1])
        loss.backward()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state.optimizer.step()
        torch.cuda.synchronize()
        update_ms = (time.perf_counter() - t) * 1e3
        model.zero_grad(set_to_none=True)
        peak = torch.cuda.max_memory_allocated()
        st = state.optimizer.base.state
        per = {}
        for p in model.parameters():
            per[p] = sum(v.numel() * v.element_size()
                         for v in st.get(p, {}).values()
                         if torch.is_tensor(v) and v.dim())
        slots[name] = per
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"train_optimizers {name}: losses {losses}")
        out[name] = dict(step_ms=step_ms, update_ms=update_ms,
                         slot_bytes=sum(per.values()), peak_mem_gb=peak / 1e9,
                         losses=losses)
        del state, step
        torch.cuda.empty_cache()
    factored = [p for p in model.parameters()
                if _factored_dims(tuple(p.shape)) is not None]
    ratio = (sum(slots["adafactor"][p] for p in factored)
             / sum(slots["adam"][p] for p in factored))
    if not ratio < 0.01:
        raise AssertionError(f"adafactor's factored slots {ratio:.4f} of "
                             "adam's")
    per_step = {"flash_attention_fwd": cfg.num_layers,
                "flash_attention_bwd_dq": cfg.num_layers,
                "flash_attention_bwd_dkv": cfg.num_layers,
                "layer_norm_fwd": 2 * cfg.num_layers + 1}
    expect_launches("train_optimizers", launches, per_step,
                    O["steps"] * len(O["names"]))
    n_params = sum(p.numel() for p in model.parameters())
    del model, weights
    torch.cuda.empty_cache()
    emit("train_optimizers", card=smi, seconds=time.perf_counter() - t0,
         params=n_params, batch=B, seq_len=S, lr=O["lr"], factored_params=sum(p.numel() for p in factored),
         adafactor_over_adam_factored_slots=ratio, optimizers=out,
         launches=launches)
    return launches


def check_data_step(dev, state, loss_fn, batch) -> dict:
    """One step of every data row of ``state`` on its part of ``batch``
    (``parallel/sync.row_parts``; a split parameter's shards gathered,
    FSDP's slices gathered whole for it), the rows' mean loss and
    gradient against the unsharded pallas step on the whole batch with
    the same weights, within TRAIN_*."""
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.parallel.sharding import (
        fsdp_gathered, gather_named)
    from distributed_tensorflow_tpu_torch.parallel.sync import row_parts
    tols = (TRAIN_LOSS_TOL, TRAIN_GRAD_NORM_RTOL, TRAIN_GRAD_MIN_COS)
    with fsdp_gathered(state):
        model = state.model
        pallas = gpt.GptLM(dataclasses.replace(
            model.cfg, attention_backend="pallas"), device=dev,
            param_dtype=torch.float32)
        pallas.load_state_dict(gather_named(model, model.state_dict()))
        parts = row_parts(state, batch)
        loss = grads = None
        for row, part in parts:
            l, g = step_grads(row, loss_fn, part)
            loss = l if loss is None else loss + l
            grads = g if grads is None else grads.add_(g)
            del g
    rows = (loss / len(parts), grads.div_(len(parts)))
    out = dict(batch=len(batch["tokens"]), rows=len(parts),
               vs_pallas=compare_steps(rows, step_grads(pallas, loss_fn,
                                                        batch),
                                       tols, ("data_rows", "pallas")),
               loss_tol=tols[0], grad_norm_rtol=tols[1],
               grad_min_cos=tols[2])
    del pallas, rows, grads
    torch.cuda.empty_cache()
    return out


def rows_bit_equal(state) -> bool:
    """Every data row holds the lead's parameters bit for bit (each its
    own FSDP slices)."""
    import torch
    lead = dict(state.model.named_parameters())
    return all(torch.equal(p, lead[n]) for m in state.rows
               for n, p in m.named_parameters()
               if getattr(p, "fsdp_info", None) is None)


def train_data(dev, smi: str, bf16: dict) -> dict:
    """Phase ``train_data`` (slice 8d): the train step's global batch at
    GPT-406M width over local data rows on the one card, each row its
    own copy of the model (its positions sharing the card, as
    ``train_parallel``'s), placed by ``ParallelConfig.place_state``:
    each arm's first step (the rows' mean) against the unsharded pallas
    step, ``DATA["steps"]`` steps with exact launches (each row's
    kernels), the rows bit-equal after them, its step ms over the bf16
    step's, the card's busy share and peak memory; FSDP over four
    positions gathered equal to the replicated dp4 arm and under its
    peak; then the async arm (:func:`data_async`).  Returns each arm's
    launches by path name."""
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.parallel.mesh import ParallelConfig
    from distributed_tensorflow_tpu_torch.parallel.sharding import (
        fsdp_gathered)
    t0 = time.perf_counter()
    out, kept = {}, {}
    for arm, d, seq, model_axis, backend, fsdp in DATA["arms"]:
        pc = ParallelConfig(data=d, model=model_axis, seq=seq,
                            attention=backend, fsdp=fsdp,
                            fsdp_min_size=DATA["fsdp_min_size"])
        mesh = pc.build_mesh([dev] * (d * seq * model_axis))
        cfg = gpt.GptConfig(**{**WIDTH, "attention_backend": backend})
        holder = {}

        def place(st, pc=pc, mesh=mesh, holder=holder):
            holder["state"] = pc.place_state(mesh, st,
                                             gpt.gpt_sharding_rules())
            return holder["state"]

        def after(st, arm=arm):
            res = dict(rows_bit_equal=rows_bit_equal(st))
            with fsdp_gathered(st):
                named = {n: p.detach() for n, p in
                         st.model.named_parameters()}
                if arm == "dp4":
                    kept["dp4"] = {n: p.cpu() for n, p in named.items()}
                elif arm == "fsdp_dp4":
                    res["vs_dp4_max_abs_diff"] = max(
                        (p.cpu() - kept["dp4"][n]).abs().max().item()
                        for n, p in named.items())
            del named
            return res
        run = train_run(
            dev, cfg, DATA["steps"], mesh=mesh, place=place, after=after,
            check=lambda m, f, b, holder=holder: check_data_step(
                dev, holder["state"], f, b))
        holder.clear()
        per_row = parallel_launches(cfg.num_layers, seq, model_axis, backend)
        per_step = {k: d * v for k, v in per_row.items()}
        expect_launches(f"train_data {arm}", run["launches"], per_step,
                        DATA["steps"])
        if not run["rows_bit_equal"]:
            raise AssertionError(f"train_data {arm}: the data rows differ")
        emit("train_data_profile", arm=arm, **run.pop("profiled"))
        run.update(layout=pc.describe(), card=smi,
                   mesh=dict(data=d, seq=seq, model=model_axis,
                             devices=str(dev)),
                   attention=backend, launches_per_step=per_step,
                   step_ms_ratio_to_bf16=run["step_ms_median"]
                   / bf16["step_ms_median"],
                   bf16_step_ms_median=bf16["step_ms_median"])
        out[f"train_data_{arm}"] = run["launches"]
        kept[f"{arm}_peak"] = run["peak_mem_gb"]
        emit("train_data", arm=arm, model="gpt_406m_width", **run)
    diff = run["vs_dp4_max_abs_diff"]
    if not (kept["fsdp_dp4_peak"] < kept["dp4_peak"] and diff <= 1e-5):
        raise AssertionError(
            f"train_data fsdp_dp4: peak {kept['fsdp_dp4_peak']} GB against "
            f"dp4's {kept['dp4_peak']}, gathered parameters {diff} from "
            "dp4's")
    del kept
    torch.cuda.empty_cache()
    out["train_data_async_r2"] = data_async(dev, smi, bf16)
    emit("train_data_done", seconds=time.perf_counter() - t0,
         fsdp_peak_gb=run["peak_mem_gb"])
    return out


def data_async(dev, smi: str, bf16: dict) -> dict:
    """The async arm of ``train_data``: ``DATA["async_replicas"]``
    replicas of the train step (``parallel/async_replicas``, one a local
    data position, here sharing the card), a merge every
    ``async_period`` local steps.  The first local step of the timed run
    is held to the unsharded pallas step on the whole batch: its
    replicas' losses (the step's own ``[R]`` metric) and the gradients
    their optimizers apply (read as each optimizer steps), averaged,
    within TRAIN_*.  Then the local steps' exact launches (each
    replica's kernels), the replicas apart before the first merge and
    bit-equal after the last, step ms, busy share and peak memory.
    Returns its launches."""
    import torch
    from distributed_tensorflow_tpu_torch.data.lm import make_lm_datasets
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.parallel.async_replicas import (
        build_async_train_step)
    from distributed_tensorflow_tpu_torch.training.optimizers import (
        make_optimizer)
    from distributed_tensorflow_tpu_torch.training.state import TrainState
    R, steps, period = (DATA["async_replicas"], DATA["steps"],
                        DATA["async_period"])
    if period < 2:
        raise ValueError("the replicas must step apart before a merge")
    B, S = TRAIN["batch"], TRAIN["seq_len"]
    cfg = gpt.GptConfig(**WIDTH)
    model = gpt.GptLM(cfg, device=dev, seed=SEED, param_dtype=torch.float32)
    data = make_lm_datasets(cfg, seq_len=S).train

    def loss_fn(m, batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        loss, acc = gpt.lm_loss(m(tokens), tokens)
        return loss, {"accuracy": acc}

    batches = [data.next_batch(B) for _ in range(steps + 1)]
    pallas = gpt.GptLM(cfg, device=dev, param_dtype=torch.float32)
    pallas.load_state_dict(model.state_dict())
    want = step_grads(pallas, loss_fn, batches[0])
    want = (want[0], want[1].cpu())      # off the card: the peak is the run's
    del pallas
    torch.cuda.empty_cache()
    state = TrainState.create(model, make_optimizer("adam", TRAIN["lr"]),
                              params_to_tree=gpt.params_to_jax,
                              params_from_tree=gpt.params_from_jax)
    step, astate = build_async_train_step(loss_fn, state, num_replicas=R,
                                          sync_period=period,
                                          devices=[dev] * R)
    # Each replica's gradients as its optimizer applies them, in the first
    # local step only (to the host, by name).
    applied = [{} for _ in range(R)]
    for r, opt in enumerate(astate.optimizers):
        names = {id(v): n for n, v in astate.views(r).items()}

        def read_then_step(opt=opt, names=names, got=applied[r]):
            for p in opt.params:
                got[names[id(p)]] = p.grad.detach().float().cpu()
            del opt.step                     # the class's step from now on
            return opt.step()
        opt.step = read_then_step
    lead = next(iter(astate.params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, step_ms, apart = [], [], None
    for batch in batches[:steps]:
        t = time.perf_counter()
        astate, metrics = step(astate, batch)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t) * 1e3)
        if apart is None:
            first = metrics["loss"].stacked.float().cpu()
            apart = not all(torch.equal(astate.views(0)[lead],
                                        astate.views(r)[lead])
                            for r in range(1, R))
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    equal = all(torch.equal(astate.views(0)[n], astate.views(r)[n])
                for r in range(1, R) for n in astate.params)
    profiled = profile_train_step(step, astate, batches[steps])
    grads = torch.cat([sum(got[n] for got in applied).flatten()
                       for n in sorted(applied[0])]).div_(R)
    tols = (TRAIN_LOSS_TOL, TRAIN_GRAD_NORM_RTOL, TRAIN_GRAD_MIN_COS)
    checked = dict(batch=B, replicas=R, replica_losses=first.tolist(),
                   vs_pallas=compare_steps(
                       (first.mean().item(), grads), want, tols,
                       ("replicas", "pallas")),
                   loss_tol=tols[0], grad_norm_rtol=tols[1],
                   grad_min_cos=tols[2])
    del applied, grads, want
    L = cfg.num_layers
    per_step = {k: R * v for k, v in
                parallel_launches(L, 1, 1, "pallas").items()}
    expect_launches("train_data async_r2", launches, per_step, steps)
    if not (apart and equal and all(map(math.isfinite, losses))
            and astate.global_step == 1 + R * (steps + 1)):
        raise AssertionError(f"train_data async: replicas apart after the "
                             f"first step {apart}, equal after the last "
                             f"merge {equal}, losses {losses}, global step "
                             f"{astate.global_step}")
    del astate, state, model, step
    torch.cuda.empty_cache()
    med = statistics.median(step_ms[2:])
    emit("train_data_profile", arm="async_r2", **profiled)
    emit("train_data", arm="async_r2", model="gpt_406m_width", card=smi,
         replicas=R, sync_period=period, steps=steps, losses=losses,
         step_ms=step_ms, step_ms_median=med,
         step_ms_ratio_to_bf16=med / bf16["step_ms_median"],
         bf16_step_ms_median=bf16["step_ms_median"],
         tokens_per_s=B * S / (med / 1e3), peak_mem_gb=peak_gb,
         replicas_apart_before_merge=apart, replicas_bit_equal=equal,
         launches=launches, launches_per_step=per_step,
         kernel_vs_plain=checked)
    return launches


def data_cli(dev, smi: str) -> dict:
    """``train.py --model=gpt_mini --sync_replicas=true
    --dcn_data_parallel=2`` with two workers (gloo: they share the one
    card, one data row each, each a DCN slice) on K1/K2/K3, with
    ``--sharded_feed=false`` and ``=true``, the four processes started
    together.  Gates: a pair's losses and parameter digests bit-equal
    across its workers, the sharded feed's line where it is on and
    nowhere else, the loss falls, each worker's launches exactly as its
    steps and eval forwards predict.  Returns the ``false`` run's worker
    0's launches."""
    from distributed_tensorflow_tpu_torch.models import gpt
    T = DATA
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_cli_")
    L = gpt.mini().num_layers
    try:
        procs = {}
        t0 = time.perf_counter()
        for feed in ("false", "true"):
            ports = [free_port(), free_port()]
            common = ["--model=gpt_mini", "--attention_backend=pallas",
                      "--fused_layer_norm", f"--bert_seq_len={T['cli_seq']}",
                      f"--batch_size={T['cli_batch']}",
                      f"--train_steps={T['cli_steps']}", "--log_every=1",
                      f"--device={dev.type}", "--job_name=worker",
                      "--worker_hosts=" + ",".join(
                          f"localhost:{p}" for p in ports),
                      "--ps_hosts=", "--sync_replicas=true",
                      "--dcn_data_parallel=2", f"--sharded_feed={feed}",
                      "--save_interval_steps=1000",
                      f"--logdir={os.path.join(tmp, feed)}",
                      "--metrics_file=" + os.path.join(tmp, f"{feed}.jsonl")]
            procs[feed] = [CliProcess("train", *common, f"--task_index={t}")
                           for t in (1, 0)]
        res = {}
        for feed, pair in procs.items():
            with pair[0], pair[1]:
                lines = {1: finish(pair[0], 300), 0: finish(pair[1], 300)}
            nums, losses = {}, {}
            for task, ls in lines.items():
                nums[task] = trainer_numbers(
                    ls, os.path.join(tmp, f"{feed}.jsonl.task{task}"), task)
                losses[task] = [x.split(" loss ")[1].split()[0] for x in ls
                                if x.startswith(f"Worker {task}: traing")]
                said = any("sharded feed — this process loads "
                           f"{T['cli_batch'] // 2}/{T['cli_batch']}" in x
                           for x in ls)
                if said != (feed == "true"):
                    raise AssertionError(f"data CLI {feed}: sharded feed "
                                         f"line {said}")
                if not any("over gloo" in x for x in ls):
                    raise AssertionError("data CLI: not over gloo")
            steps = nums[0]["steps"]
            values = [float(x) for x in losses[0]]
            if not (losses[0] == losses[1] and nums[0]["digest"]
                    == nums[1]["digest"] and steps == T["cli_steps"] - 1
                    and len(values) == steps
                    and all(map(math.isfinite, values))
                    and statistics.mean(values[-3:]) < values[0]):
                raise AssertionError(f"data CLI {feed}: losses {losses}, "
                                     f"digests {nums[0]['digest']} "
                                     f"{nums[1]['digest']}")
            forwards = steps + 2 * 4
            want = {"flash_attention_fwd": L * forwards,
                    "flash_attention_bwd_dq": L * steps,
                    "flash_attention_bwd_dkv": L * steps,
                    "layer_norm_fwd": (2 * L + 1) * forwards,
                    "quant_matmul": 0, "quant_matmul_nt": 0}
            for task in (0, 1):
                if nums[task]["launches"] != want:
                    raise AssertionError(
                        f"data CLI {feed} worker {task} launches "
                        f"{nums[task]['launches']}, expected {want}")
            res[feed] = dict(losses=values, **nums[0])
        emit("train_data_cli", card=smi, wall_s=time.perf_counter() - t0,
             batch=T["cli_batch"], seq_len=T["cli_seq"],
             sharded_feed_false=res["false"], sharded_feed_true=res["true"],
             loss_first_diff=abs(res["false"]["losses"][0]
                                 - res["true"]["losses"][0]))
        return res["false"]["launches"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ train_mesh


def rank_pipe_launches(L: int, n_pipe: int, micro: int, p: int) -> dict:
    """One 1F1B step's launches on pipe rank ``p`` of ``n_pipe`` (its one
    chunk of ``L / n_pipe`` layers): each micro-batch's forward slot
    (skipped on the last rank, whose backward slot recomputes it), the
    recompute and the backward, and on the last rank the head's K3 a
    micro-batch (:func:`pipeline_launches`' terms, a rank's share)."""
    per = L // n_pipe
    last = p == n_pipe - 1
    fwd = micro * per * (1 if last else 2)
    return {"flash_attention_fwd": fwd,
            "flash_attention_bwd_dq": micro * per,
            "flash_attention_bwd_dkv": micro * per,
            "layer_norm_fwd": 2 * fwd + (micro if last else 0)}


def rank_ring_launches(L: int, n_seq: int) -> dict:
    """One step's launches on a rank of a causal ring over ``n_seq``
    ranks: K6 a hop a layer (``n_seq`` hops), K7a and K7b as many, K3 on
    the rank's block of the residual stream."""
    return {"flash_attention_chunk": L * n_seq,
            "flash_attention_chunk_dq": L * n_seq,
            "flash_attention_chunk_dkv": L * n_seq,
            "layer_norm_fwd": 2 * L + 1}


def mesh_rows_pipeline(dev, smi: str, bf16: dict) -> dict:
    """The in-process ``dp2_pp2`` arm: data=2 x pipe=2 on [cuda0] * 4
    (``models/registry.build_gpt_pipeline``: a pipelined copy of the model
    a data row, placed by ``parallel/sharding._place_rows``), 1F1B over
    ``MESH["micro"]`` micro-batches of each row's 4 rows.  Its first step
    (the rows' mean gradient in the lead's ``.grad``) against the
    unpipelined pallas step (TRAIN_*), ``MESH["steps"]`` timed steps with
    exact launches (two rows of :func:`pipeline_launches`), the rows
    bit-equal, busy share and peak memory."""
    import torch
    from distributed_tensorflow_tpu_torch.data.lm import make_lm_datasets
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.models.registry import (
        build_gpt_pipeline)
    from distributed_tensorflow_tpu_torch.parallel.mesh import create_mesh
    from distributed_tensorflow_tpu_torch.training.optimizers import (
        make_optimizer)
    T, B, S = MESH, TRAIN["batch"], TRAIN["seq_len"]
    cfg = gpt.GptConfig(**WIDTH)
    data = make_lm_datasets(cfg, seq_len=S).train
    batches = [data.next_batch(B) for _ in range(T["steps"] + 2)]

    def loss_fn(m, batch):
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        loss, acc = gpt.lm_loss(m(tokens), tokens)
        return loss, {"accuracy": acc}
    plain = gpt.GptLM(cfg, device=dev, seed=SEED, param_dtype=torch.float32)
    loss0, grads0 = step_grads(plain, loss_fn, batches[0])
    pallas = (loss0, grads0.cpu())
    del plain, grads0
    torch.cuda.empty_cache()
    width = {k: v for k, v in WIDTH.items()
             if k not in ("dtype", "attention_backend", "fused_ln")}
    tols = (TRAIN_LOSS_TOL, TRAIN_GRAD_NORM_RTOL, TRAIN_GRAD_MIN_COS)
    mesh = create_mesh(data=2, pipe=2, devices=[dev] * 4)
    b = build_gpt_pipeline(
        TRAIN["lr"], mesh, seed=SEED, seq_len=S, n_micro=T["micro"],
        attention_backend="pallas", dtype=WIDTH["dtype"],
        tx=make_optimizer("adam", TRAIN["lr"]), fused_ln=True,
        schedule="1f1b", width=width)
    state = b.place_state(mesh, b.state)
    step = b.train_step_builder(mesh, log_grad_norm=True)
    model = state.model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, m = step(state, batches[0])
    flat = torch.cat([g.float().flatten().cpu() for _, g in sorted(
        (plain_name(model, n), p.grad) for n, p in model.named_parameters())])
    vs_pallas = compare_steps((float(m["loss"]), flat), pallas, tols,
                              ("dp2_pp2", "pallas"))
    del flat
    reset_launch_counts()
    losses, step_ms = [], []
    for batch in batches[1:T["steps"] + 1]:
        t = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not rows_bit_equal(state):
        raise AssertionError("train_mesh dp2_pp2: the data rows differ")
    per_row = pipeline_launches(cfg.num_layers, T["micro"], 2, "1f1b")
    per_step = {k: 2 * v for k, v in per_row.items()}
    expect_launches("train_mesh dp2_pp2", launches, per_step, T["steps"])
    profiled = profile_train_step(step, state, batches[-1])
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"train_mesh dp2_pp2: losses {losses}")
    med = statistics.median(step_ms)
    emit("train_mesh_profile", arm="dp2_pp2", **profiled)
    emit("train_mesh", arm="dp2_pp2", model="gpt_406m_width", card=smi,
         mesh=dict(data=2, pipe=2, devices=str(dev)), schedule="1f1b",
         micro_batches_a_row=T["micro"], batch=B, seq_len=S,
         vs_pallas=vs_pallas, loss_tol=tols[0], grad_norm_rtol=tols[1],
         grad_min_cos=tols[2], losses=losses, step_ms=step_ms,
         step_ms_median=med, step_ms_ratio_to_bf16=med
         / bf16["step_ms_median"], bf16_step_ms_median=bf16["step_ms_median"],
         peak_mem_gb=peak_gb, busy_share=profiled["busy_share"],
         rows_bit_equal=True, launches=launches, launches_per_step=per_step,
         peak_stash=step.peak_stash)
    del state, model, b, step
    torch.cuda.empty_cache()
    return launches


def mesh_fsdp_tp(dev, smi: str, bf16: dict) -> dict:
    """The in-process ``fsdp_dp2_tp2`` arm: FSDP over data=2 beside
    model=2 on [cuda0] * 4 (``ParallelConfig.place_state``: each row's
    Megatron shards split over the two rows along the dim the composed
    spec gives ``data``, JAX's ``P("data", "model")``), through
    :func:`train_run`: the first step (the rows' mean, the slices gathered
    whole) against the unsharded pallas step, ``MESH["steps"]`` steps
    with exact launches (two rows of a tp2 step's), busy share and peak
    memory."""
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.parallel.mesh import ParallelConfig
    pc = ParallelConfig(data=2, model=2, fsdp=True,
                        fsdp_min_size=MESH["fsdp_min_size"])
    mesh = pc.build_mesh([dev] * 4)
    cfg = gpt.GptConfig(**WIDTH)
    holder = {}

    def place(st):
        holder["state"] = pc.place_state(mesh, st, gpt.gpt_sharding_rules())
        return holder["state"]
    run = train_run(dev, cfg, MESH["steps"], mesh=mesh, place=place,
                    check=lambda m, f, b: check_data_step(
                        dev, holder["state"], f, b))
    holder.clear()
    per_step = {k: 2 * v for k, v in parallel_launches(
        cfg.num_layers, 1, 2, "pallas").items()}
    expect_launches("train_mesh fsdp_dp2_tp2", run["launches"], per_step,
                    MESH["steps"])
    profiled = run.pop("profiled")
    emit("train_mesh_profile", arm="fsdp_dp2_tp2", **profiled)
    run.update(layout=pc.describe(), card=smi,
               mesh=dict(data=2, model=2, devices=str(dev)),
               launches_per_step=per_step,
               busy_share=profiled["busy_share"],
               step_ms_ratio_to_bf16=run["step_ms_median"]
               / bf16["step_ms_median"],
               bf16_step_ms_median=bf16["step_ms_median"])
    emit("train_mesh", arm="fsdp_dp2_tp2", model="gpt_406m_width", **run)
    return run["launches"]


_MESH_RANK = r"""
import dataclasses, json, statistics, sys, time
import torch, torch.distributed as dist
rank, world, port, out, conf = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4],
                                json.loads(sys.argv[5]))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device(conf["devices"][rank])
cuda = dev.type == "cuda"
if cuda:
    torch.cuda.set_device(dev)
dist.init_process_group(conf["backend"], init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
import chip_smoke as cs
from distributed_tensorflow_tpu_torch.cluster.server import form_mesh_groups
from distributed_tensorflow_tpu_torch.data.lm import make_lm_datasets
from distributed_tensorflow_tpu_torch.models import gpt
from distributed_tensorflow_tpu_torch.models.registry import (
    build_gpt_pipeline)
from distributed_tensorflow_tpu_torch.ops import kernels
from distributed_tensorflow_tpu_torch.parallel import sync
from distributed_tensorflow_tpu_torch.parallel.mesh import PIPE_AXIS, global_mesh
from distributed_tensorflow_tpu_torch.parallel.transport import link
from distributed_tensorflow_tpu_torch.training.optimizers import (
    make_optimizer)
from distributed_tensorflow_tpu_torch.training.state import TrainState
if cuda:
    kernels.load()
mesh = global_mesh(num_workers=world, rank=rank, positions=[dev],
                   **conf["sizes"])
groups = form_mesh_groups(mesh, dev)
ranks = mesh.ranks
cfg = gpt.GptConfig(**conf["width"])
B, S, steps = conf["batch"], conf["seq_len"], conf["steps"]
data = make_lm_datasets(cfg, seq_len=S).train
batches = [data.next_batch(B) for _ in range(steps + 2)]
rows = B // ranks.shape["data"]
d = ranks.coords["data"]
def mine(b):
    return {"tokens": b["tokens"][d * rows:(d + 1) * rows]}
def loss_fn(m, batch):
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    loss, acc = gpt.lm_loss(m(tokens), tokens)
    return loss, {"accuracy": acc}
# The unsharded pallas step on the whole batch, on this rank: the
# reference its part of the first step's gradient is held to.
plain = gpt.GptLM(cfg, device=dev, seed=cs.SEED, param_dtype=torch.float32)
plain.train()
ref_loss, _ = loss_fn(plain, batches[0])
ref_loss.backward()
ref = {n: p.grad.float().cpu() for n, p in plain.named_parameters()}
ref_loss = ref_loss.item()
del plain
if cuda:
    torch.cuda.empty_cache()
line = groups["grad"]
ar = (sync.GradientAllReduce(group=ranks.group("grad"),
                             partials=ranks.seq_parts)
      if len(line) > 1 else None)
pipe = PIPE_AXIS in ranks.cross
if pipe:
    width = {k: v for k, v in conf["width"].items()
             if k not in ("dtype", "attention_backend", "fused_ln")}
    b = build_gpt_pipeline(conf["lr"], mesh, seed=cs.SEED, seq_len=S,
                           n_micro=min(conf["micro"], rows),
                           attention_backend="pallas",
                           dtype=cfg.dtype,
                           tx=make_optimizer("adam", conf["lr"]),
                           fused_ln=True, schedule="1f1b", width=width)
    state = b.place_state(mesh, b.state)
    step = b.train_step_builder(mesh, all_reduce=ar, log_grad_norm=True)
    name_of = lambda n: cs.plain_name(state.model, n)
else:
    model = gpt.GptLM(dataclasses.replace(cfg, attention_backend="ring"),
                      device=dev, seed=cs.SEED, param_dtype=torch.float32,
                      mesh=mesh)
    state = TrainState.create(model, make_optimizer("adam", conf["lr"]),
                              params_to_tree=gpt.params_to_jax,
                              params_from_tree=gpt.params_from_jax)
    step = sync.build_sync_train_step(loss_fn, all_reduce=ar,
                                      log_grad_norm=True)
    name_of = lambda n: n
if cuda:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
t = time.perf_counter()
state, m = step(state, mine(batches[0]))
first_ms = (time.perf_counter() - t) * 1e3
# The first step's gradient (this rank's parameters; their sums over the
# pipe group where the stages are split) against the reference's.
sums = torch.zeros(3, dtype=torch.float64)
for n, p in state.model.named_parameters():
    x, y = p.grad.double().flatten().cpu(), ref[name_of(n)].double().flatten()
    sums += torch.stack([x @ y, x @ x, y @ y])
del ref
if pipe:
    sums = sums.to(dev)
    dist.all_reduce(sums, group=link(mesh, PIPE_AXIS).group)
    sums = sums.cpu()
dot, na2, nb2 = sums.tolist()
na, nb = na2 ** 0.5, nb2 ** 0.5
first = dict(loss_ranks=float(m["loss"]), loss_pallas=ref_loss,
             loss_diff=abs(float(m["loss"]) - ref_loss),
             grad_norm_ranks=na, grad_norm_pallas=nb,
             grad_norm_rel_diff=abs(na - nb) / nb, grad_cos=dot / (na * nb),
             grad_norm_logged=float(m["grad_norm"]))
cs.reset_launch_counts()
losses, norms, step_ms = [], [], []
for batch in batches[1:steps + 1]:
    t = time.perf_counter()
    state, m = step(state, mine(batch))
    losses.append(float(m["loss"]))
    norms.append(float(m["grad_norm"]))
    step_ms.append((time.perf_counter() - t) * 1e3)
launches = cs.launch_counts()
peak = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
profiled = (cs.profile_train_step(step, state, mine(batches[-1])) if cuda
            else dict(busy_share=None, top_kernels=[]))
hops = {a: link(mesh, a).describe() for a in ranks.cross}
json.dump(dict(rank=rank, coords=ranks.coords, cross=list(ranks.cross),
               groups=groups, hops=hops, first=first, first_ms=first_ms,
               losses=losses, grad_norms=norms, step_ms=step_ms,
               step_ms_median=statistics.median(step_ms), peak_mem_gb=peak,
               busy_share=profiled["busy_share"],
               top_kernels=profiled["top_kernels"][:5],
               launches=launches), open(out, "w"))
dist.destroy_process_group()
"""


def mesh_ranks(smi: str, label: str, sizes: dict, devices: list,
               backend: str, bf16: dict | None = None, beside=()) -> dict:
    """One arm of ranks as processes (``_MESH_RANK``, a rank each,
    ``devices[r]`` rank ``r``'s card, ``backend`` their group's): GPT-406M
    width, the train step's batch, each rank its part of the global mesh
    (``parallel/mesh.global_mesh``) and its groups
    (``cluster/server.form_mesh_groups``).  Gates: every rank's first step
    (its part of the gradient, summed over the pipe group where it splits
    the stages) within TRAIN_* of the unsharded pallas step, the ranks'
    losses and gradient norms identical, each rank's launches exactly its
    schedule's (:func:`rank_pipe_launches`, :func:`rank_ring_launches`).
    Returns rank 0's launches."""
    from distributed_tensorflow_tpu_torch.parallel.mesh import (
        PIPE_AXIS, global_mesh)
    import torch
    world = len(devices)
    T = MESH
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_mesh_{label}_")
    conf = dict(width=dict(WIDTH), batch=TRAIN["batch"],
                seq_len=TRAIN["seq_len"], steps=T["rank_steps"],
                lr=TRAIN["lr"], micro=T["rank_micro"], sizes=sizes,
                devices=[str(d) for d in devices], backend=backend)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    port = free_port()
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-c", _MESH_RANK, str(r), str(world), str(port),
             os.path.join(tmp, f"rank{r}.json"), json.dumps(conf)],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=T["rank_timeout_s"])[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, text in zip(procs, outs):
            if p.returncode != 0:
                raise AssertionError(f"train_mesh {label} rank exited "
                                     f"{p.returncode}: {text[-4000:]}")
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                 for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    tols = (TRAIN_LOSS_TOL, TRAIN_GRAD_NORM_RTOL, TRAIN_GRAD_MIN_COS)
    L = WIDTH["num_layers"]
    for r, rank in enumerate(ranks):
        first = rank["first"]
        if not (math.isfinite(first["loss_ranks"])
                and first["loss_diff"] <= tols[0]
                and first["grad_norm_rel_diff"] <= tols[1]
                and first["grad_cos"] >= tols[2]):
            raise AssertionError(f"train_mesh {label} rank {r} first step "
                                 f"vs pallas: {first}")
        if not (rank["losses"] == ranks[0]["losses"]
                and rank["grad_norms"] == ranks[0]["grad_norms"]
                and all(map(math.isfinite, rank["losses"]))):
            raise AssertionError(f"train_mesh {label}: rank {r}'s losses "
                                 f"{rank['losses']}, rank 0's "
                                 f"{ranks[0]['losses']}")
        mesh = global_mesh(num_workers=world, rank=r,
                           positions=[torch.device("cpu")], **sizes)
        if PIPE_AXIS in mesh.ranks.cross:
            micro = min(T["rank_micro"],
                        TRAIN["batch"] // mesh.global_shape["data"])
            per_step = rank_pipe_launches(
                L, mesh.global_shape[PIPE_AXIS], micro,
                mesh.ranks.coords[PIPE_AXIS])
        else:
            per_step = rank_ring_launches(L, mesh.global_shape["seq"])
        got = {k: v for k, v in rank["launches"].items() if v}
        want = {k: v * T["rank_steps"] for k, v in per_step.items() if v}
        if got != want:
            raise AssertionError(f"train_mesh {label} rank {r} launches "
                                 f"{got}, expected {per_step} per step x "
                                 f"{T['rank_steps']}")
        rank["launches_per_step"] = per_step
    emit("train_mesh", arm=f"ranks_{label}", model="gpt_406m_width",
         card=smi, backend=backend, devices=conf["devices"], sizes=sizes,
         wall_s=wall_s, timed_beside=list(beside), batch=TRAIN["batch"], seq_len=TRAIN["seq_len"],
         steps=T["rank_steps"], loss_tol=tols[0], grad_norm_rtol=tols[1],
         grad_min_cos=tols[2], step_ms_median=max(
             r["step_ms_median"] for r in ranks),
         step_ms_ratio_to_bf16=(max(r["step_ms_median"] for r in ranks)
                                / bf16["step_ms_median"]) if bf16 else None,
         peak_mem_gb=[r["peak_mem_gb"] for r in ranks],
         busy_share=[r["busy_share"] for r in ranks], ranks=ranks)
    return {k: ranks[0]["launches"].get(k, 0)
            for k in ranks[0]["launches_per_step"]}


def mesh_cli(dev, smi: str) -> dict:
    """``train.py --model=gpt_mini --sync_replicas=true`` as two workers on
    ``cuda:0`` (gloo: they share the card) with ``--pipeline_parallel=2``
    across them (1F1B) and, beside it, ``--sequence_parallel=2
    --attention_backend=ring`` across them, the four processes started
    together.  Gates: each worker's layout line names the axis across
    the workers and its host-staged hops, the pair's losses bit-equal,
    the loss falls, each worker's launches exactly its schedule's steps
    and eval forwards (the pipe's ranked forward: each rank its chunk,
    the head on the last; the ring's every forward).  Returns each
    arm's worker 0's launches by path."""
    from distributed_tensorflow_tpu_torch.models import gpt
    T = MESH
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_cli_")
    L = gpt.mini().num_layers
    arms = {"pipe2": ["--pipeline_parallel=2", "--pipeline_schedule=1f1b",
                      f"--pipeline_microbatches={T['cli_micro']}",
                      "--attention_backend=pallas"],
            "seq2": ["--sequence_parallel=2", "--attention_backend=ring"]}
    try:
        procs = {}
        t0 = time.perf_counter()
        for arm, flags in arms.items():
            ports = [free_port(), free_port()]
            common = ["--model=gpt_mini", *flags, "--fused_layer_norm",
                      f"--bert_seq_len={T['cli_seq']}",
                      f"--batch_size={T['cli_batch']}",
                      f"--train_steps={T['cli_steps']}", "--log_every=1",
                      f"--device={dev}", "--job_name=worker",
                      "--worker_hosts=" + ",".join(
                          f"localhost:{p}" for p in ports),
                      "--ps_hosts=", "--sync_replicas=true",
                      "--save_interval_steps=1000",
                      f"--logdir={os.path.join(tmp, arm)}",
                      "--metrics_file=" + os.path.join(tmp, f"{arm}.jsonl")]
            procs[arm] = [CliProcess("train", *common, f"--task_index={t}")
                          for t in (1, 0)]
        out = {}
        for arm, pair in procs.items():
            with pair[0], pair[1]:
                lines = {1: finish(pair[0], 300), 0: finish(pair[1], 300)}
            axis = "pipe" if arm == "pipe2" else "seq"
            nums, losses = {}, {}
            for task, ls in lines.items():
                layout = line_value(ls, f"Worker {task}: mesh")
                if (f"across the workers: {axis}=2 (this worker {axis} "
                        f"{task}, ranks [0, 1]), data=1") not in layout:
                    raise AssertionError(f"mesh CLI {arm}: {layout}")
                hops = line_value(ls, f"Worker {task}: {axis} hops")
                if "gloo over ranks [0, 1] (host-staged" not in hops:
                    raise AssertionError(f"mesh CLI {arm}: hops {hops}")
                nums[task] = trainer_numbers(
                    ls, os.path.join(tmp, f"{arm}.jsonl.task{task}"), task)
                losses[task] = [x.split(" loss ")[1].split()[0] for x in ls
                                if x.startswith(f"Worker {task}: traing")]
            steps = nums[0]["steps"]
            values = [float(x) for x in losses[0]]
            if not (losses[0] == losses[1] and steps == T["cli_steps"] - 1
                    and len(values) == steps
                    and all(map(math.isfinite, values))
                    and statistics.mean(values[-3:]) < values[0]):
                raise AssertionError(f"mesh CLI {arm}: losses {losses}")
            # The validation at step 0 and the final test: 4 eval
            # batches each (make_lm_eval_fn), a forward each.
            forwards = 2 * 4
            for task in (0, 1):
                if arm == "pipe2":
                    per = rank_pipe_launches(L, 2, T["cli_micro"], task)
                    chunk = L // 2
                    head = 1 if task == 1 else 0
                    want = {k: v * steps for k, v in per.items()}
                    want["flash_attention_fwd"] += chunk * forwards
                    want["layer_norm_fwd"] += (2 * chunk + head) * forwards
                else:
                    per = rank_ring_launches(L, 2)
                    want = {"flash_attention_chunk": per[
                        "flash_attention_chunk"] * (steps + forwards),
                        "flash_attention_chunk_dq": per[
                            "flash_attention_chunk_dq"] * steps,
                        "flash_attention_chunk_dkv": per[
                            "flash_attention_chunk_dkv"] * steps,
                        "layer_norm_fwd": per["layer_norm_fwd"]
                        * (steps + forwards)}
                got = {k: v for k, v in {**nums[task]["launches"],
                                         **nums[task]["chunk_launches"]
                                         }.items() if v}
                if got != want:
                    raise AssertionError(f"mesh CLI {arm} worker {task}: "
                                         f"launches {got}, expected {want}")
            out[arm] = dict(losses=values, **nums[0],
                            worker1_step_ms_median=nums[1]["step_ms_median"])
        emit("train_mesh_cli", card=smi, wall_s=time.perf_counter() - t0,
             batch=T["cli_batch"], seq_len=T["cli_seq"], **out)
        return {f"train_mesh_cli_{arm}": {**r["launches"],
                                          **r["chunk_launches"]}
                for arm, r in out.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_mesh(dev, smi: str, bf16: dict) -> dict:
    """Phase ``train_mesh`` (slice 8e), its in-process arms
    (:func:`mesh_rows_pipeline`, :func:`mesh_fsdp_tp`), in sequence with
    the other in-process phases.  Returns each arm's launches by path."""
    import torch
    t0 = time.perf_counter()
    out = {"train_mesh_dp2_pp2": mesh_rows_pipeline(dev, smi, bf16)}
    torch.cuda.empty_cache()
    out["train_mesh_fsdp_dp2_tp2"] = mesh_fsdp_tp(dev, smi, bf16)
    torch.cuda.empty_cache()
    emit("train_mesh_done", seconds=time.perf_counter() - t0)
    return out


def mesh_rank_arms(dev, smi: str, bf16: dict, beside=()) -> dict:
    """``train_mesh``'s arms of two ranks as processes sharing the card
    over gloo, with the pipe and then the ring's seq axis across them
    (:func:`mesh_ranks`); ``beside``: the phases whose processes run
    beside them (their step times are then contended ones).  Returns each
    arm's rank 0 launches by path."""
    t0 = time.perf_counter()
    out = {f"train_mesh_ranks_{label}": mesh_ranks(
        smi, label, sizes, [dev] * 2, "gloo", bf16, beside)
        for label, sizes in MESH["rank_arms"]}
    emit("train_mesh_ranks_done", seconds=time.perf_counter() - t0,
         timed_beside=list(beside))
    return out


def mesh_nccl(smi: str) -> None:
    """``--nccl`` on four cards (``train_mesh_nccl``): the ranks at
    GPT-406M width, a card each over NCCL, with pipe=4 (1F1B), seq=4 (the
    ring) and data=2 x pipe=2 (:func:`mesh_ranks`), then gpt_mini at B=32,
    S=512 as four one-card workers (:func:`data_cli_arm`), against one
    worker over the four cards' rows (``train_data_nccl``)."""
    import torch
    n = torch.cuda.device_count()
    if n != 4:
        raise AssertionError(f"the mesh over cards needs 4, found {n}")
    devices = [torch.device("cuda", i) for i in range(n)]
    for label, sizes in MESH["nccl_arms"]:
        mesh_ranks(smi, f"nccl_{label}", sizes, devices, "nccl")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_nccl_")
    try:
        data_cli_arm(smi, tmp, "four_workers_a_card_each", 4, "cuda")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def data_nccl(smi: str) -> None:
    """``--nccl`` on four cards: gpt_mini through the trainer CLI on
    K1/K2/K3 with one worker whose data axis spans the cards (``data=-1``:
    four rows, a card each), with two workers of two cards each,
    ``--dcn_data_parallel=2`` over NCCL (each worker a DCN slice), and
    with one worker on one card (``--device=cuda:0``: one row, the
    layout before the data axis had local rows), at the same global
    batch (:func:`data_cli_arm`)."""
    import torch
    n = torch.cuda.device_count()
    if n != 4:
        raise AssertionError(f"the data axis over cards needs 4, found {n}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_nccl_")
    try:
        data_cli_arm(smi, tmp, "one_worker_data4", 1, "cuda")
        data_cli_arm(smi, tmp, "two_workers_dcn2", 2, "cuda")
        data_cli_arm(smi, tmp, "one_worker_one_card", 1, "cuda:0")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def data_cli_arm(smi: str, tmp: str, label: str, workers: int,
                 device: str) -> None:
    """One ``train_data_nccl`` arm: ``workers`` gpt_mini workers with
    ``--device=device`` at B=2 x ``DATA["cli_batch"]``, S=``cli_seq``
    (``--dcn_data_parallel=2`` with two).  Gates: the layout (the rows:
    a card each of the worker's share, one on ``cuda:N``) and backend
    lines, the workers' losses and digests bit-equal, the loss falls,
    launches exactly a row's times the rows."""
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt
    T, L = DATA, gpt.mini().num_layers
    rows = (1 if torch.device(device).index is not None
            else torch.cuda.device_count() // workers)
    ports = [free_port() for _ in range(workers)]
    batch = T["cli_batch"] * 2
    common = ["--model=gpt_mini", "--attention_backend=pallas",
              "--fused_layer_norm", f"--bert_seq_len={T['cli_seq']}",
              f"--batch_size={batch}", f"--train_steps={T['cli_steps']}",
              "--log_every=1", f"--device={device}", "--job_name=worker",
              "--worker_hosts=" + ",".join(f"localhost:{p}" for p in ports),
              "--ps_hosts=", "--sync_replicas=true",
              "--save_interval_steps=1000",
              f"--logdir={os.path.join(tmp, label)}",
              "--metrics_file=" + os.path.join(tmp, label + ".jsonl")]
    if workers == 2:
        common.append("--dcn_data_parallel=2")
    t0 = time.perf_counter()
    procs = [CliProcess("train", *common, f"--task_index={t}")
             for t in reversed(range(workers))][::-1]
    lines = []
    try:
        for p in procs:
            lines.append(finish(p, 300))
    finally:
        for p in procs:
            p.__exit__()
    metrics = os.path.join(tmp, label + ".jsonl")
    nums = [trainer_numbers(ls, metrics + (f".task{t}" if workers > 1
                                           else ""), t)
            for t, ls in enumerate(lines)]
    if rows > 1:
        layout = line_value(lines[0], "Worker 0: mesh")
        if f"{rows} positions on {rows} distinct device(s)" not in layout:
            raise AssertionError(f"data nccl {label}: {layout}")
    elif any(x.startswith("Worker 0: mesh") for x in lines[0]):
        raise AssertionError(f"data nccl {label}: a mesh of several "
                             f"positions on {device}")
    else:
        layout = f"one position on {device}"
    if workers == 2 and not all(any("over nccl" in x for x in ls)
                                for ls in lines):
        raise AssertionError(f"data nccl {label}: not over nccl")
    losses = [[float(x.split(" loss ")[1].split()[0]) for x in ls
               if x.startswith(f"Worker {t}: traing")]
              for t, ls in enumerate(lines)]
    steps = nums[0]["steps"]
    want = {"flash_attention_fwd": L * (rows * steps + 2 * 4),
            "flash_attention_bwd_dq": rows * L * steps,
            "flash_attention_bwd_dkv": rows * L * steps,
            "layer_norm_fwd": (2 * L + 1) * (rows * steps + 2 * 4),
            "quant_matmul": 0, "quant_matmul_nt": 0}
    if not (all(x == losses[0] for x in losses)
            and len({x["digest"] for x in nums}) == 1
            and all(x["launches"] == want for x in nums)
            and statistics.mean(losses[0][-3:]) < losses[0][0]):
        raise AssertionError(
            f"data nccl {label}: losses {losses}, digests "
            f"{[x['digest'] for x in nums]}, launches "
            f"{[x['launches'] for x in nums]} (want {want})")
    emit("train_data_nccl", arm=label, card=smi, layout_line=layout,
         wall_s=time.perf_counter() - t0, batch=batch, seq_len=T["cli_seq"],
         workers=workers, rows=rows, cards=torch.cuda.device_count(),
         losses=losses[0], **nums[0])


def trainer_nccl(smi: str) -> None:
    """``--nccl``: the reference job with one worker on each visible card
    (worker i on card i), so the workers' all-reduce goes over NCCL; the
    same gates as ``trainer_reference``.  Needs 2 or more cards whose count
    divides the global batch of 100."""
    import torch
    n = torch.cuda.device_count()
    if n < 2 or TRAINER["batch"] % n:
        raise AssertionError(f"--nccl needs 2+ cards dividing the batch of "
                             f"{TRAINER['batch']}, found {n}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    try:
        reference_job("cuda", tmp, smi, workers=n, backend="nccl")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The async_trainer phase.  The reference job's flags plus a merge every 4
# local steps, the steps paced (as tests/test_multiprocess.py paces its
# async workers) so that the two workers' windows overlap: 100 ms where
# worker 1 starts after worker 0 has published (a worker takes ~10 s to
# start on the card), 60 ms where both start together; the JAX CLI with
# the same flags on a CPU (a PS and two workers, one device each) reaches
# a test accuracy of 1 on both workers, the tolerance is the sync job's.
# gpt_mini: the trainer phase's width, S=512, B=32, 40 global steps of one
# replica (39 local steps), a merge every 10, paced as well (100 ms, cut
# from 150).
ASYNC = dict(period=4, pace_s=0.1, overlap_pace_s=0.06, lead_steps=100,
             gpt_period=10,
             gpt_steps=40,
             gpt_pace_s=0.1, jax_cpu_test_accuracy=1.0,
             # Full-state bytes over the int8 round's: the JAX package's
             # acceptance bar (tests/test_param_exchange.py:177).
             min_wire_ratio=4.0, drift_share=0.1, drift_scale=0.01,
             # The int8 leg's part of the tree: the embeddings and the
             # first of the eight blocks (widths unchanged; ~53M of the
             # 406M parameters; the first two before a cut).  The codec is
             # host numpy and zlib, 12-40 s an exchange over the whole
             # tree.
             int8_leaves=("word_emb", "pos_emb", "layer0"))


def exchange_records(path: str) -> list:
    """The ``param_exchange`` telemetry records of a trainer's metrics
    file (one an exchange period; the overlapped exchange writes its own
    from its thread)."""
    out = []
    for line in open(path):
        try:
            r = json.loads(line)
        except ValueError:
            continue
        if r.get("kind") == "param_exchange":
            out.append(r)
    return out


def exchange_numbers(lines, metrics: str, task: int, train_s: float) -> dict:
    """A worker's exchange: ms a period (the averager's own clock; in the
    overlapped mode the background thread's), its share of the training
    time, the bytes on the wire a period beside the full state's, and the
    publish rate the trainer prints."""
    recs = exchange_records(metrics)
    if not recs:
        raise AssertionError(f"worker {task}: no param_exchange records")
    ms = [r["dur_ms"] for r in recs]
    rates = [float(x.split("publish, ")[1].split(" MB/s")[0])
             for x in lines if "publish, " in x and " MB/s)" in x]
    wire = [r["bytes_on_wire"] for r in recs if r["peers"]]
    full = [r["full_state_bytes"] for r in recs if r["peers"]]
    return dict(exchanges=len(recs), exchange_ms_mean=statistics.mean(ms),
                exchange_ms_median=statistics.median(ms),
                exchange_share_of_train=sum(ms) / 1e3 / train_s,
                publish_mb_per_s=statistics.mean(rates) if rates else None,
                wire_bytes_per_round=statistics.mean(wire) if wire else None,
                full_state_bytes_per_round=(statistics.mean(full)
                                            if full else None),
                compressed=any(r["compressed"] for r in recs))


def async_job(device: str, tmp: str, smi: str, label: str, *extra,
              pace_s: float, stagger: bool = True) -> dict:
    """The reference job in async mode: a PS and two workers on
    ``device``, each step paced by ``pace_s``; with ``stagger``, worker 1
    starts once worker 0 has published (its first exchange runs at local
    step 4, before the step-5 line), and worker 0 trains
    ``ASYNC["lead_steps"]`` steps more, so that it is still publishing
    when a slow start-up brings worker 1 in (a worker 1 that met only
    worker 0's last publication adopted it and averaged with no one)."""
    ps_port = free_port()
    ports = [free_port(), free_port()]
    T, A = TRAINER, ASYNC
    logdir = os.path.join(tmp, label)
    common = [f"--ps_hosts=localhost:{ps_port}",
              "--worker_hosts=" + ",".join(f"localhost:{p}" for p in ports),
              f"--data_dir={os.path.join(tmp, 'no-mnist')}",
              f"--train_steps={T['steps']}", f"--batch_size={T['batch']}",
              f"--hidden_units={T['hidden']}",
              f"--learning_rate={T['lr']}", "--sync_replicas=false",
              f"--async_sync_period={A['period']}",
              f"--inject_step_delay={pace_s}:0:1000000000",
              "--log_every=1", f"--logdir={logdir}", f"--device={device}",
              f"--metrics_file={os.path.join(tmp, label + '.jsonl')}",
              *extra]

    def worker(t):
        lead = ([f"--train_steps={T['steps'] + A['lead_steps']}"]
                if stagger and t == 0 else [])
        return CliProcess("train", "--job_name=worker", f"--task_index={t}",
                          *common, *lead)

    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        ps = stack.enter_context(CliProcess(
            "train", "--job_name=ps", "--task_index=0", *common))
        w0 = stack.enter_context(worker(0))
        if stagger:
            w0.wait_for("Worker 0: traing step 5 ", 300)
        w1 = stack.enter_context(worker(1))
        outs = {1: finish(w1, 300), 0: finish(w0, 300)}
        ps_alive = ps.proc.poll() is None
    wall_s = time.perf_counter() - t0
    if not ps_alive:
        raise AssertionError("the PS exited before it was stopped: "
                             + "".join(ps.seen[-20:]))
    nums = []
    for t in (0, 1):
        metrics = os.path.join(tmp, f"{label}.jsonl.task{t}")
        try:
            n = trainer_numbers(outs[t], metrics, t)
            n.update(exchange_numbers(outs[t], metrics, t, n["train_s"]))
        except (ValueError, KeyError, AssertionError) as e:
            kinds = [json.loads(x).get("kind") for x in open(metrics)]
            raise AssertionError(
                f"{label} worker {t}: {e!r}; records "
                f"{ {k: kinds.count(k) for k in set(kinds)} }: "
                + "".join(outs[t][-40:])) from e
        acc = n["test_accuracy"]
        if abs(acc - A["jax_cpu_test_accuracy"]) > T["accuracy_tol"]:
            raise AssertionError(
                f"{label} worker {t}: test accuracy {acc}, the JAX CLI's "
                f"{A['jax_cpu_test_accuracy']} (tol {T['accuracy_tol']})")
        n["step_ms_unpaced"] = n["step_ms_median"] - pace_s * 1e3
        nums.append(n)
    text = {t: "".join(outs[t]) for t in (0, 1)}
    return dict(wall_s=wall_s, text=text, workers=nums)


def async_mlp_busy(dev, tmp: str) -> dict:
    with _BUSY_LOCK:
        return _async_mlp_busy(dev, tmp)


def _async_mlp_busy(dev, tmp: str) -> dict:
    """The busy share of the reference job's async local step (the
    trainer's MNIST bundle, one replica) in this process: one step
    profiled after three (the CLI's profiler takes ~17 s to start, longer
    than a paced run)."""
    import types
    from distributed_tensorflow_tpu_torch.models import registry
    from distributed_tensorflow_tpu_torch.parallel.async_replicas import (
        build_async_train_step)
    from distributed_tensorflow_tpu_torch.training.loop import to_device
    T = TRAINER
    flags = types.SimpleNamespace(hidden_units=T["hidden"],
                                  learning_rate=T["lr"], seed=0,
                                  optimizer="")
    bundle = registry.build("mnist_mlp", flags, dev)
    step, astate = build_async_train_step(
        bundle.loss_fn, bundle.state, num_replicas=1,
        sync_period=ASYNC["period"])
    data = bundle.load_datasets(os.path.join(tmp, "no-mnist")).train
    for _ in range(3):
        astate, metrics = step(astate, to_device(data.next_batch(T["batch"]),
                                                 dev))
    float(metrics["loss"])
    return profile_train_step(step, astate, to_device(
        data.next_batch(T["batch"]), dev))


def async_reference(dev, tmp: str, smi: str) -> None:
    """``async_reference``: averaging through the KV, a late joiner's
    adoption, the accuracy gate."""
    out = async_job(str(dev), tmp, smi, "async_ref",
                    pace_s=ASYNC["pace_s"])
    both = out["text"][0] + out["text"][1]
    for needle in ("averaged parameters with 1 peer(s)", "(kv publish"):
        if needle not in both:
            # Each worker's exchange lines, its first skips included.
            seen = {t: [x for x in out["text"][t].splitlines()
                        if "peer" in x or "publish" in x][:8]
                    for t in (0, 1)}
            raise AssertionError(f"async_reference: no {needle!r}: "
                                 f"{seen} " + both[-2000:])
    if "adopted published collective parameters" not in out["text"][1]:
        raise AssertionError("async_reference: worker 1 did not adopt the "
                             "published parameters: "
                             + out["text"][1][-3000:])
    busy = async_mlp_busy(dev, tmp)
    emit("async_reference", card=smi, wall_s=out["wall_s"],
         pace_ms=ASYNC["pace_s"] * 1e3, period=ASYNC["period"],
         busy_share=busy["busy_share"], busy_window_ms=busy["window_ms"],
         jax_cpu_test_accuracy=ASYNC["jax_cpu_test_accuracy"],
         accuracy_tol=TRAINER["accuracy_tol"],
         averaged_lines=[both.count("averaged parameters with 1 peer(s)")],
         workers=out["workers"])


def async_overlap(dev, tmp: str, smi: str) -> None:
    """``async_overlap``: the compressed (int8) exchange overlapped with
    training, both workers started together (tests/test_multiprocess.py:
    282)."""
    out = async_job(str(dev), tmp, smi, "async_ovl",
                    "--async_compress=int8", "--async_overlap_exchange=true",
                    pace_s=ASYNC["overlap_pace_s"], stagger=False)
    both = out["text"][0] + out["text"][1]
    for needle in ("compressed parameter exchange on",
                   "applied overlapped average with 1 peer(s)",
                   "in background"):
        if needle not in both:
            raise AssertionError(f"async_overlap: no {needle!r}: "
                                 + both[-3000:])
    if "averaged parameters with" in both:
        raise AssertionError("async_overlap: a foreground average ran")
    wire = [w["wire_bytes_per_round"] for w in out["workers"]]
    full = [w["full_state_bytes_per_round"] for w in out["workers"]]
    emit("async_overlap", card=smi, wall_s=out["wall_s"],
         pace_ms=ASYNC["overlap_pace_s"] * 1e3, wire_bytes_per_round=wire,
         full_state_bytes_per_round=full,
         applied_lines=both.count("applied overlapped average"),
         workers=out["workers"])


def async_gpt_busy(dev) -> dict:
    with _BUSY_LOCK:
        return _async_gpt_busy(dev)


def _async_gpt_busy(dev) -> dict:
    """The async local step of the trainer's gpt_mini bundle (one replica,
    as the trainer builds it) in this process, not in the CLI: its ms a
    step over 10 (no exchange, no telemetry, no pace) and one step
    profiled, for the busy share (the CLI's profiler takes ~17 s to
    start)."""
    import types
    import torch
    from distributed_tensorflow_tpu_torch.models import registry
    from distributed_tensorflow_tpu_torch.parallel.async_replicas import (
        build_async_train_step)
    from distributed_tensorflow_tpu_torch.training.loop import to_device
    T, A = TRAINER, ASYNC
    flags = types.SimpleNamespace(
        learning_rate=0.01, seed=0, bert_seq_len=T["gpt_seq"],
        attention_backend="pallas", fused_layer_norm=True,
        bert_dtype="bfloat16", optimizer="")
    bundle = registry.build("gpt_mini", flags, dev)
    step, astate = build_async_train_step(
        bundle.loss_fn, bundle.state, num_replicas=1,
        sync_period=A["gpt_period"])
    data = bundle.load_datasets(None).train
    batches = [to_device(data.next_batch(T["gpt_batch"]), dev)
               for _ in range(13)]
    for b in batches[:3]:
        astate, metrics = step(astate, b)
    float(metrics["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[3:]:
        astate, metrics = step(astate, b)
    float(metrics["loss"])
    step_ms = (time.perf_counter() - t0) * 1e3 / 10
    out = profile_train_step(step, astate, batches[0])
    del bundle, astate
    return dict(in_process_step_ms=step_ms,
                in_process_tokens_per_s=(T["gpt_batch"] * T["gpt_seq"]
                                         / step_ms * 1e3),
                **out)


def async_gpt(dev, tmp: str, smi: str) -> dict:
    """``async_gpt``: gpt_mini async through the kernels, two workers on
    the card and no PS (the chief hosts the coordination service).
    Returns the two workers' summed launches."""
    import torch
    from distributed_tensorflow_tpu_torch.models import gpt
    T, A = TRAINER, ASYNC
    ports = [free_port(), free_port()]
    logdir = os.path.join(tmp, "async_gpt")
    common = ["--model=gpt_mini", "--attention_backend=pallas",
              "--fused_layer_norm", f"--bert_seq_len={T['gpt_seq']}",
              f"--batch_size={T['gpt_batch']}", f"--logdir={logdir}",
              f"--device={dev}", "--ps_hosts=",
              "--worker_hosts=" + ",".join(f"localhost:{p}" for p in ports),
              "--sync_replicas=false",
              f"--async_sync_period={A['gpt_period']}",
              f"--train_steps={A['gpt_steps']}", "--log_every=1",
              f"--inject_step_delay={A['gpt_pace_s']}:0:1000000000"]
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        procs = {t: stack.enter_context(CliProcess(
            "train", "--job_name=worker", f"--task_index={t}", *common,
            f"--metrics_file={os.path.join(tmp, 'async_gpt.jsonl')}"))
            for t in (1, 0)}
        outs = {t: finish(procs[t], 400) for t in (0, 1)}
    wall_s = time.perf_counter() - t0
    L = gpt.mini().num_layers
    local = A["gpt_steps"] - 1
    # A local step: K1, K2a, K2b once a layer, K3 twice a layer and once
    # at the end; an eval forward (the validation at step 0 and the final
    # test, 4 batches each) K1 and K3 as a step's forward.
    forwards = local + 2 * 4
    want = {"flash_attention_fwd": L * forwards,
            "flash_attention_bwd_dq": L * local,
            "flash_attention_bwd_dkv": L * local,
            "layer_norm_fwd": (2 * L + 1) * forwards,
            "quant_matmul": 0, "quant_matmul_nt": 0}
    workers, total = [], {}
    for t in (0, 1):
        lines = outs[t]
        launches = printed_launches(lines, t)[0]
        if launches != want:
            raise AssertionError(f"async_gpt worker {t}: launches "
                                 f"{launches}, expected {want}")
        losses = [float(x.split(" loss ")[1].split()[0]) for x in lines
                  if x.startswith(f"Worker {t}: traing step")]
        if len(losses) != local or not (
                all(map(math.isfinite, losses))
                and statistics.mean(losses[-5:]) < losses[0]):
            raise AssertionError(f"async_gpt worker {t}: losses {losses}")
        metrics = os.path.join(tmp, f"async_gpt.jsonl.task{t}")
        # The CLI worker's own telemetry step (data wait + compute, the
        # card synchronised each step), less the pace.
        nums = trainer_numbers(lines, metrics, t)
        step_ms = nums["step_ms_median"] - A["gpt_pace_s"] * 1e3
        ex = exchange_numbers(lines, metrics, t, nums["train_s"])
        workers.append(dict(
            test_accuracy=nums["test_accuracy"],
            step_ms=step_ms,
            tokens_per_s=T["gpt_batch"] * T["gpt_seq"] / step_ms * 1e3,
            loss_first=losses[0], loss_last5_mean=statistics.mean(losses[-5:]),
            peak_mem_gib=float(line_value(
                lines, f"Worker {t}: peak device memory").split()[0]),
            averaged_lines=sum("averaged parameters with 1 peer(s)" in x
                               for x in lines),
            train_s=nums["train_s"], launches=launches, **ex))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    if not any(w["averaged_lines"] for w in workers):
        raise AssertionError("async_gpt: no 'averaged parameters with 1 "
                             "peer(s)' line: " + "".join(outs[0][-20:]))
    busy = async_gpt_busy(dev)
    torch.cuda.empty_cache()
    emit("async_gpt", card=smi, wall_s=wall_s, batch=T["gpt_batch"],
         seq_len=T["gpt_seq"], local_steps=local, period=A["gpt_period"],
         pace_ms=A["gpt_pace_s"] * 1e3, launches_expected=want,
         step_ms=[w["step_ms"] for w in workers],
         tokens_per_s=[w["tokens_per_s"] for w in workers],
         busy_share_in_process=busy["busy_share"], workers=workers)
    emit("async_gpt_profile", card=smi, **busy)
    return total


def async_exchange(dev, tmp: str, smi: str, timed_beside=()) -> None:
    """``async_exchange``: the exchange at transformer scale, in this
    process, through the trainer's own functions.  A GPT-406M-width bf16
    model (seeded weights) as one async replica, and a drifted copy of its
    parameters (a tenth of the coordinates moved, as SGD moves them): the
    consensus tree off the card (``host_tree``), two ``ParamAverager``s
    over the logdir side-channel (publish, fetch, average), the consensus
    back onto the card (``adopt_consensus``); then two int8
    ``CompressedShardedAverager``s to their first assembled round, on an
    eighth of the tree cut by depth (``ASYNC["int8_leaves"]``: the
    embeddings and the first of the eight blocks, widths unchanged),
    with the same gates: the wire cut and the codec's error bound.
    ``timed_beside``: the lines of the phases that run beside it."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.cluster import param_sync as ps
    from distributed_tensorflow_tpu_torch.cluster.coordination import (
        CoordinationClient, CoordinationServer)
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.parallel.async_replicas import (
        adopt_consensus, host_tree, make_async_state)
    from distributed_tensorflow_tpu_torch.training.optimizers import (
        make_optimizer)
    from distributed_tensorflow_tpu_torch.training.state import TrainState
    from distributed_tensorflow_tpu_torch.utils.pytree import tree_leaves
    A = ASYNC
    torch.manual_seed(SEED)
    model = gpt.GptLM(gpt.GptConfig(**WIDTH), device=dev)
    astate = make_async_state(TrainState.create(
        model, make_optimizer("sgd", 0.0), params_to_tree=gpt.params_to_jax,
        params_from_tree=gpt.params_from_jax), 1)
    del model
    mine = {n: t[0].clone() for n, t in astate.params.items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    drifted = {}
    for n, p in mine.items():
        move = torch.rand(p.shape, generator=g, device=dev) < A["drift_share"]
        step = torch.randn(p.shape, generator=g, device=dev) * A["drift_scale"]
        drifted[n] = (p.float() + step * move).to(p.dtype)
    nbytes = sum(t.numel() * t.element_size() for t in mine.values())
    host_tree(astate)          # allocates the state's pinned buffers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree_a = host_tree(astate)
    d2h_s = time.perf_counter() - t0
    tree_b = host_tree(astate, drifted)
    srv = CoordinationServer(port=0, num_tasks=2, heartbeat_timeout=60.0)
    srv.start()
    clients = [CoordinationClient("127.0.0.1", srv.port, task_id=t)
               for t in (0, 1)]
    xdir = os.path.join(tmp, "async_exchange")
    try:
        avg = [ps.ParamAverager(clients[t], t, 2, namespace="plain",
                                exchange_dir=xdir) for t in (0, 1)]
        legs = {"publish": 0.0, "fetch": 0.0}

        def timed(name, fn):
            def call(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    legs[name] += time.perf_counter() - t0
            return call
        # Worker 1's exchange as the trainer calls it, its legs timed:
        # publish, fetch of worker 0's file, and the rest (fingerprints,
        # the bf16 mean).
        avg[0].exchange(tree_a)
        if avg[0].last_publish_transport != "binary":
            raise AssertionError("the 406M-width tree did not take the "
                                 "binary side-channel")
        avg[1]._publish = timed("publish", avg[1]._publish)
        avg[1]._fetch_peer = timed("fetch", avg[1]._fetch_peer)
        t0 = time.perf_counter()
        consensus, peers = avg[1].exchange(tree_b)
        exchange_s = time.perf_counter() - t0
        if peers != 1:
            raise AssertionError(f"plain exchange saw {peers} peers")
        publish_s, fetch_s = legs["publish"], legs["fetch"]
        average_s = exchange_s - publish_s - fetch_s
        plain_wire = avg[1].last_bytes_out + avg[1].last_bytes_in
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adopt_consensus(astate, consensus)
        torch.cuda.synchronize()
        h2d_s = time.perf_counter() - t0
        for n, t in astate.params.items():
            want = ((mine[n].float() + drifted[n].float()) / 2).to(t.dtype)
            if not torch.equal(t[0].view(torch.int16),
                               want.view(torch.int16)):
                raise AssertionError(f"{n}: the adopted consensus is not "
                                     "the fp32 mean cast to bf16 on the card")

        # The int8 compressed exchange of the same two trees' first
        # eighth by depth, to the first assembled round (worker 1's:
        # worker 0 anchors, both publish deltas, each freezes its shard,
        # worker 1 assembles).
        part_a, part_b = ({k: t[k] for k in A["int8_leaves"]}
                          for t in (tree_a, tree_b))
        comp = [ps.CompressedShardedAverager(
            clients[t], t, 2, namespace="int8", exchange_dir=xdir,
            quant="int8") for t in (0, 1)]
        params = [part_a, part_b]
        rounds = []
        t0 = time.perf_counter()
        for _ in range(4):
            for t in (0, 1):
                r0 = time.perf_counter()
                params[t], _ = comp[t].exchange(params[t])
                rounds.append(dict(
                    task=t, ms=(time.perf_counter() - r0) * 1e3,
                    bytes_on_wire=comp[t].last_bytes_out
                    + comp[t].last_bytes_in,
                    rounds_completed=comp[t].rounds_completed,
                    fallbacks=comp[t].fallback_exchanges))
                if comp[t].rounds_completed:
                    break
            if any(c.rounds_completed for c in comp):
                break
        int8_s = time.perf_counter() - t0
        done = [c for c in comp if c.rounds_completed]
        if not done:
            raise AssertionError(f"int8 exchange assembled no round: {rounds}")
        # A round after the bootstrap's anchor (full precision by design):
        # the delta publish, the frozen reduce and the assembly.
        wire = max(r["bytes_on_wire"] for r in rounds
                   if r["rounds_completed"] >= 1)
        part_bytes = sum(x.nbytes for x in tree_leaves(part_a))
        full = 2 * part_bytes           # a full-state publish and fetch
        ratio = full / wire
        if ratio < A["min_wire_ratio"]:
            raise AssertionError(f"int8 round moved {wire} bytes, full "
                                 f"state {full}: ratio {ratio:.2f}")
        # The codec's bound: an int8 quantization errs by at most half a
        # step (its block's absmax / 127 / 2), and the consensus is
        # quantized twice (the delta, then the reduced shard): it lies
        # within one step of the largest delta of the exact mean.
        fa, fb = ps._flatten_f32(part_a), ps._flatten_f32(part_b)
        exact = (fa.astype(np.float64) + fb) / 2
        c = done[0]._consensus
        bound_abs = float(np.abs(fb - fa).max()) / 127 + 1e-6
        err = float(np.abs(c - exact).max())
        if err > bound_abs:
            raise AssertionError(f"int8 consensus off the exact mean by "
                                 f"{err}, bound {bound_abs}")
        plain_err = float(np.abs(ps._flatten_f32(consensus) - (
            ps._flatten_f32(tree_a).astype(np.float64)
            + ps._flatten_f32(tree_b)) / 2).max())
        leaves = len(tree_leaves(tree_a))
    finally:
        for c in clients:
            c.close()
        srv.stop()
    del astate, mine, drifted
    torch.cuda.empty_cache()

    def gbs(seconds):
        return nbytes / seconds / 1e9
    emit("async_exchange", card=smi, timed_beside=list(timed_beside),
         tree_bytes=nbytes, leaves=leaves,
         d2h_ms=d2h_s * 1e3, d2h_gb_per_s=gbs(d2h_s),
         publish_ms=publish_s * 1e3, publish_gb_per_s=gbs(publish_s),
         fetch_ms=fetch_s * 1e3, fetch_gb_per_s=gbs(fetch_s),
         average_and_rest_ms=average_s * 1e3,
         average_and_rest_gb_per_s=gbs(average_s),
         exchange_ms=exchange_s * 1e3,
         h2d_adopt_ms=h2d_s * 1e3, h2d_adopt_gb_per_s=gbs(h2d_s),
         plain_wire_bytes=plain_wire, plain_err_vs_exact=plain_err,
         int8_leaves=list(A["int8_leaves"]), int8_tree_bytes=part_bytes,
         int8_wall_ms=int8_s * 1e3, int8_rounds=rounds,
         int8_wire_bytes_per_round=wire, full_state_bytes_per_round=full,
         int8_wire_ratio=ratio, int8_err_vs_exact=err,
         int8_err_bound=bound_abs)


def async_trainer(dev, smi: str) -> None:
    """Phase ``async_trainer``: ``async_reference`` and ``async_overlap``
    side by side, in the ``trainer`` phase's group beside ``async_gpt``
    (``async_exchange`` runs in :func:`exchange_and_ladder`)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_async_")
    seconds = {}
    start = time.perf_counter()

    def timed(name, fn):
        t0 = time.perf_counter()
        fn(dev, tmp, smi)
        seconds[name] = time.perf_counter() - t0
    try:
        # The two MNIST jobs (a PS and two paced workers each) side by
        # side.  Start-up load beside async_reference's staggered worker 1
        # cost that job its overlap once (async_gpt's, before worker 0's
        # lead of ASYNC["lead_steps"]).
        side_by_side((timed, "async_reference", async_reference),
                     (timed, "async_overlap", async_overlap))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("async_trainer", card=smi, seconds=time.perf_counter() - start,
         seconds_by_part=seconds,
         side_by_side=[["async_reference", "async_overlap"]])


def exchange_and_ladder(dev, smi: str, beside_lines=()) -> dict:
    """``async_exchange`` (host numpy and zlib in this process, no kernel
    launched) with the config ladder's CLIs beside it (LeNet-5 async,
    BERT-tiny, ViT-tiny, BERT-MoE over two expert positions), and beside
    both the parts ``beside_lines`` names.  Returns the ladder's
    launches, by path."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_exchange_")
    rungs = ["ladder_lenet5", "ladder_bert_tiny", "ladder_vit_tiny",
             "ladder_bert_moe"]
    t0 = time.perf_counter()
    try:
        _, launches = side_by_side(
            (functools.partial(async_exchange,
                               timed_beside=[*rungs, *beside_lines]),
             dev, tmp, smi),
            (ladder, dev, smi, (ladder_lenet,),
             (ladder_transformer, "bert_tiny"),
             (ladder_transformer, "vit_tiny", "--data_augmentation=true"),
             (ladder_transformer, "bert_moe", "--expert_parallel=2",
              "--optimizer=lamb", "--learning_rate=0.03")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("exchange_group", seconds=time.perf_counter() - t0,
         side_by_side=["async_exchange", "ladder", *beside_lines])
    return launches


def main() -> int:
    import torch
    args = sys.argv[1:]
    if args not in ([], ["--nccl"], ["--fsdp"]):
        print("usage: chip_smoke.py [--nccl | --fsdp]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distributed_tensorflow_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = card()
    emit("env", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    if args:
        if args == ["--nccl"]:
            kernels.load()
            trainer_nccl(smi)
            data_nccl(smi)
            mesh_nccl(smi)
        else:
            t0 = time.perf_counter()
            kernels.load()
            emit("build", seconds=time.perf_counter() - t0)
            train_fsdp(dev, smi, {"step_ms_median": None}, alone=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    t_start = t0 = time.perf_counter()
    lib = kernels.load()
    emit("build", seconds=time.perf_counter() - t0,
         sources=[os.path.basename(s) for s in kernels.sources()],
         flash_bf16_kernels=flash_build_report(kernels, lib),
         quant_kernels=quant_build_report(kernels, lib))

    rows = check_kernels(dev)
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    # K8 is on no path: its launches are the kernels phase's own.
    by_path = {"kernels": {"quant_matmul_dgelu": qmm.dgelu_launches}}
    by_path["serve"], model, whole = serve(dev)
    by_path["serve_decode"] = by_path["serve"]
    by_path["serve_chunked"] = serve_chunked(dev, model, whole)
    by_path["serve_spec"] = serve_spec(dev, model)
    by_path["generate"] = generate_phase(dev, model)
    # The async exchange (host work in this process) and the config
    # ladder's CLIs beside the checkpoint phase's processes.
    t0 = time.perf_counter()
    by_path["checkpoint"], ladder_launches = side_by_side(
        (checkpoint_phase, dev, smi, model, whole),
        (exchange_and_ladder, dev, smi, ["checkpoint"]))
    by_path.update(ladder_launches)
    emit("checkpoint_group", seconds=time.perf_counter() - t0,
         side_by_side=["checkpoint", "async_exchange", "ladder"])
    # The config ladder's ResNet-20 rung (its processes: two gloo workers,
    # then --mode=eval) and lm_bpe's gpt_mini CLIs beside the fleet's
    # processes.
    by_path["fleet"], _, by_path["lm_bpe"] = side_by_side(
        (fleet_phase, dev, smi, model, whole, ["ladder_resnet20", "lm_bpe"]),
        (ladder, dev, smi, (ladder_resnet,)), (lm_bpe, dev, smi))
    del model, whole
    torch.cuda.empty_cache()
    by_path["train"], bf16_step = train(dev, smi)
    by_path["train_int8"] = train_int8(dev, smi, bf16_step)
    torch.cuda.empty_cache()
    by_path["train_ring"] = train_ring(dev, smi, bf16_step)
    torch.cuda.empty_cache()
    # The in-process arms one phase after another, nothing beside them:
    # their step times and busy shares are the card's and this process's
    # alone.
    by_path.update(train_parallel(dev, smi, bf16_step))
    torch.cuda.empty_cache()
    by_path.update(train_pipeline(dev, smi, bf16_step))
    torch.cuda.empty_cache()
    by_path["train_optimizers"] = train_optimizers(dev, smi)
    torch.cuda.empty_cache()
    by_path.update(train_data(dev, smi, bf16_step))
    torch.cuda.empty_cache()
    by_path.update(train_mesh(dev, smi, bf16_step))
    torch.cuda.empty_cache()
    # The two FSDP ranks, the gpt_mini trainer CLIs (tp2 x ulysses2; the
    # 1f1b pipeline; the mesh's pipe2 and seq2) each with its eval and
    # generate, the data CLI's two pairs and train_mesh's two-rank arms,
    # side by side: all of them processes of their own.  The config
    # ladder's in-process phase (train_models) beside them, every launch
    # of it under the busy lock.  The trainer group after them, alone:
    # its async jobs gate on a worker joining a peer that is still
    # publishing, which a loaded host's start-up can miss.
    t0 = time.perf_counter()
    (by_path["train_fsdp"], by_path["train_parallel_cli"],
     by_path["train_pipeline_cli"], models,
     by_path["train_data_cli"], mesh_clis, ranks) = side_by_side(
        (train_fsdp, dev, smi, bf16_step), (parallel_cli, dev, smi),
        (pipeline_cli, dev, smi), (train_models, dev, smi),
        (data_cli, dev, smi), (mesh_cli, dev, smi),
        (mesh_rank_arms, dev, smi, bf16_step, ["fsdp_and_cli_pair"]))
    by_path.update(models)
    by_path.update(mesh_clis)
    by_path.update(ranks)
    emit("fsdp_and_cli_pair", seconds=time.perf_counter() - t0,
         beside=["train_models", "train_data_cli", "train_mesh_cli",
                 "train_mesh_ranks"])
    by_path["trainer"], by_path["async_trainer"] = trainer(dev, smi)
    for row in rows:
        row["launches"] = by_path[row["main"]][row["name"]]
        if row["name"] in by_path["async_trainer"]:
            row["async_trainer_launches"] = \
                by_path["async_trainer"][row["name"]]
        for path, sub in row["paths"].items():
            sub["launches"] = by_path[path][row["name"]]
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
