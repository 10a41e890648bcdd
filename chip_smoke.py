"""Chip smoke test of the PyTorch port: drives its main paths on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each (a failed phase stops the script with a non-zero
exit and no result line):

  build    compile the CUDA kernels for sm_90a, one nvcc per source, side
           by side (nvcc -Xptxas -v lines; a tensor-core kernel that
           spills fails the phase: the bf16 attention forward and backward
           passes and the bf16 cross-entropy kernels), and the card's name
           and power limit from nvidia-smi;
  kernel   every kernel against its plain PyTorch version on the card,
           each case with its max error against the tolerance, kernel_ms /
           plain_ms / library_ms (CUDA events) and the roofline bound, and
           proof that the tolerance catches a wrong kernel (the kernel fed
           a fault must fall outside it):
           * the flash-attention op at engine-step shapes of gemma3-1b
             (window 512 and 0, bf16 and float32) and llama3.2-3b (bf16):
             bf16 its tile ranges, the tensor-core forward
             ``flash_fwd_mma_kernel`` split over blocks and the merge pass
             ``flash_combine_kernel``; float32 the split pass
             ``flash_fwd_kernel`` and the merge pass; launched twice more
             (the same bits); and the merge pass alone (faults: a window
             or causal limit one off, a live KV tile or a KV split
             dropped);
           * the attention backward (its tile ranges
             ``flash_bwd_tiles_kernel``, ``flash_bwd_dq_kernel``,
             ``flash_bwd_dkdv_kernel``), the forward's output and its
             log-sum-exp on the train phase's largest chunk of step 0 (its
             own segments and positions, no context; gemma3-1b global and
             window-512 layers, bf16), then on a training chunk with
             context rows, for gemma3-1b global and window-512 layers and
             llama3.2-3b, then in float32 (``flash_fwd_kernel`` and the
             float32 passes) at the largest chunk of each float32 verify
             phase with its carry in front, as the step feeds it (gemma3-1b
             global layer; hymba-1.5b, 25 query heads, 5 KV heads of 64)
             (faults: a window or causal limit one off, a live KV tile
             dropped);
           * the cross-entropy kernels B, C1, C2 (bf16: ``ce_fwd_mma_kernel``,
             ``ce_bwd_dh_mma_kernel``, ``ce_bwd_dw_mma_kernel`` on the
             tensor cores; float32: ``ce_fwd_kernel``, ``ce_bwd_kernel<dh>``,
             ``ce_bwd_kernel<dw>``) on that chunk's targets (gemma3-1b
             head, bf16), then at T = 8192 tokens on gemma3-1b's (D 1152,
             V 262144) and llama3.2-3b's (D 3072, V 128256) head, bf16 and
             float32 (faults: a target shifted by one, one vocab tile
             dropped; each kernel launched twice more must give the same
             bits); B's yardsticks: h @ W.T + logsumexp in float32 and on
             cuBLAS's bf16 path (torch.mm with out_dtype float32);
           * at hymba-1.5b's train shapes (step 0's largest chunk: 16,384
             rows): the selective scan D (three passes:
             ``mamba_scan_fwd_summary_kernel``, ``_carry_``, ``_emit_``) and
             its gradient D' (``mamba_scan_bwd_summary_kernel``,
             ``_carry_``, ``_tile_`` and the fixed-order sums of its
             partials, ``mamba_scan_reduce_kernel``), each pass timed, at DI
             3200, DS 16: ungated with float32 delta, B, C and bf16 xs and
             all float32; on step 0's most packed chunk with row 0
             continuing a non-zero h0; at falcon-mamba-7b's width (DI 8192,
             8,192 rows, bf16 xs) (faults: the resets shifted by one row, h0
             dropped, the last time tile dropped, each outside the float32
             tolerance in D and in D'); gated (the mixer's fused scan with
             its softplus, skip and gate, as the train step runs it) in
             bf16 on the largest chunk with pad rows, and in float32 on
             train_verify_hymba's largest chunk (faults: the skip dropped,
             pad rows not made neutral); each case launched again must give
             the same bits; the attention forward
             and backward at hymba's heads (25 query heads, 5 KV heads of
             64) and B, C1, C2 with its head (D 1600, V 32001, one target
             in the last, ragged vocab tile);
           * at olmoe-1b-7b's shapes (16 query and 16 KV heads of 128; head
             D 2048, V 50304): the attention forward and backward on
             train_moe's largest chunk of step 0 (bf16, 47,231 tokens, its
             own segments; the plain version over blocks of 1,024 query
             rows) and on train_verify_moe's largest chunk (float32, its
             carry in front); B, C1, C2 on those chunks' targets and at
             CE_T random targets (bf16);
           the plain versions run over blocks of rows, so that their
           materialised scores or logits fit the card; each attention
           backward case also holds the forward as the train step runs it
           (bf16: ``flash_fwd_mma_kernel`` on the op's tile ranges, with
           lse, unsplit on a train chunk) to the plain output, catches the
           same faults in its output, launches it twice more (the same
           bits) and times it beside its bound, its plain version and
           SDPA's forward on the EFFICIENT_ATTENTION backend; it times the
           tile ranges (``bwd_tiles``), counts
           each pass's tile pairs in range, visited and live, launches both
           passes twice more (the results must be bitwise equal) and times
           the library yardstick, scaled_dot_product_attention with the
           boolean mask on the EFFICIENT_ATTENTION backend under autograd
           (where that backend refuses a case, the record says why); the
           kernels line reports the train-chunk cases of the training
           kernels;
  serve    gemma3-1b at full width, bf16, random weights from --seed, 16
           requests of the "github" trace served by the continuous-batching
           engine (n_items=4, cap_t=512, page_sz=16, k=1); every request
           must complete, the tile ranges and the tensor-core forward must
           launch 26 times per engine step, the merge pass at least once,
           and the plain attention never;
  verify   the same engine in float32 on the first 2 requests (8 new
           tokens) against the port's one_shot_generate;
  serve_mesh  the engine on a 2x2 mesh of this card (2 pipeline stages of
           2 sequence-parallel ranks, the pool's pages split over the
           ranks), gemma3-1b at full width and depth in bf16 on serve's
           trace: every request completes, A's forward and its tile ranges
           launch 26 x 2 times per engine step (every rank, a rank with no
           live row too), no plain call, the pool's bytes per rank equal
           the reference's ``engine_pool_struct`` share, every rank holds
           pages; tokens/s, TTFT and TPOT p50/p95, peak memory, collective
           bytes a step; then kernel A with its lse against its plain
           version at each (rank, window)'s largest call of the run (all
           the step's queries against the rank's resident rows), with its
           faults (a live key tile dropped, the causal limit or window one
           off), times and bound;
  verify_mesh  the engine in float32 at 2x2 on serve's first 2 requests
           (8 new tokens; the pool cut to their pages, so both ranks hold
           some) against one_shot_generate under the near-tie rule, and
           the float32 kernel cases at the run's calls; planted faults
           must fail the gate: the last rank's partial dropped from the
           log-sum-exp merge, each rank reading the next rank's pages;
  train    gemma3-1b at full width, bf16 with a float32 AdamW master, 2
           steps of ``launch/train.train`` on github batches of 8 x 16384
           tokens planned for one H100: per step
           loss, tokens, wall time, tokens/s, peak device memory and the
           plan's own estimate; every loss finite, every step's peak at or
           under the plan's estimate, every kernel launched exactly as the
           plan predicts (the attention forward and its tile ranges 26 x
           chunks + remat depths, the merge pass only where a chunk's grid
           does not fill the card (none), each backward pass 26 x chunks,
           B, C1, C2 once per chunk) and no plain call;
  train_verify  float32 at full width on a short batch (one sequence
           split over 3 chunks, one packed chunk, a non-zero remat table):
           the chunked step with the plan's remat table launches the
           attention forward 26 x chunks + the remat depths times, and
           it, the same step with the table zeroed, and one unchunked
           forward and backward per sequence agree (loss and gradients
           within 1e-5 relative);
  train_hymba  hymba-1.5b at full width (32 hybrid layers: attention and a
           mamba mixer side by side), bf16 with a float32 AdamW master, 2
           steps of the same github batches of 8 x 16384 planned for one
           H100 (one chunk per sequence group, stage-aware remat): per step
           loss, tokens, wall time, tokens/s, peak memory beside the plan's
           estimate, solve seconds; every loss finite, every step's peak
           at or under the estimate, every kernel launched exactly as the
           plan predicts (attention forward, its tile ranges and each of
           the selective scan D's three passes 32 x chunks + remat depths,
           no merge pass, each attention backward pass and each of D''s
           four 32 x chunks, B, C1, C2 once per chunk) and no plain call;
  train_verify_hymba  float32 at full width: one 3,000-token sequence in 3
           chunks whose split slices (1,060 and 997 tokens) leave pad rows
           in front of the KV and SSM carries, a non-zero remat table: the
           step with the table zeroed equals it bit for bit, and it equals
           one unchunked forward and backward per sequence (loss 1e-5
           relative; each gradient leaf within 1e-4 of its largest value,
           as is the same corpus packed without a split); two planted
           carry faults (pad rows resetting the SSM state, the state's
           gradient dropped at the hand-off) must exceed those limits;
  train_pipeline  the pipelined step (``launch/train.train`` with
           ``d_p`` stages, every stage on this card, each planned with the
           card's memory over the stages), bf16 at full width, on the train
           phase's github batches: (a) gemma3-1b at 2x1 under the planner's
           own schedule (interleaved-1f1b, v pinned from step 0), 2 steps;
           (b) gemma3-1b at 4x1 (zero-bubble-h1, split backward), 1 step;
           (c) hymba-1.5b at 2x1 on 16 of its 32 layers (PIPE_LAYERS:
           cut to keep the script in its time), 1 step under its own
           schedule and 1 with gpipe-1f1b forced. Per step: loss, tokens, wall time, tokens/s,
           each stage's estimate, the card's peak, the hand-offs and their
           bytes, the bubble share; every loss finite, the card's peak at
           or under the sum of its stages' estimates, each stage's kernel
           launches as the plan predicts (its layers x chunks + its remat
           depths; the merge pass where a chunk's keys split; B, C1, C2
           once per chunk on the last stage; the split's W launches none
           of the port's kernels) and no plain call;
  train_pipeline_verify  float32 hymba-1.5b at full width at 2x1: the
           verify phases' sequences (one of 3,000 tokens over 3 chunks,
           pad rows in front of the KV and SSM carries), a remat table
           non-zero on both stages; gpipe-1f1b, interleaved-1f1b (the
           planner's v) and zero-bubble-h1 (split backward) each against
           one unchunked forward and backward per sequence at
           train_verify_hymba's limits; the split equals the fused
           backward and the remat table a zeroed one, bit for bit; three
           planted faults (the stream gradient stage 1 hands stage 0
           dropped for one chunk, the last stage's tied-embedding gradient
           dropped, a stream run through the wrong virtual stage) must fall
           outside the limits;
  serve_moe  olmoe-1b-7b at full width and depth (16 layers of attention
           and a 64-expert top-8 MoE block), bf16, random weights from
           --seed, served as serve serves gemma3-1b (the same trace and
           engine): every request completes, A's forward and its tile
           ranges launch 16 times per engine step, the merge pass never
           (32 query tiles x 16 heads fill the card), the plain attention
           never. With each MoE phase a "moe" line: the expert products
           issued, the host syncs that read the group sizes, the non-empty
           experts of each layer (fewest, most), the smallest top-k margin
           (the k-th router logit less the (k+1)-th) over every routed row;
  serve_mesh_moe  olmoe-1b-7b at full width and depth at 1x2 (expert
           parallelism inside the engine: each rank routes every row to
           its 32 experts), bf16, serve's first 8 requests with 16 new
           tokens, gated as serve_mesh; verify_mesh at 1x2 in float32 as
           above;
  verify_moe  that engine in float32 on the first 2 requests against
           one_shot_generate;
  train_moe  olmoe-1b-7b at full width cut to 4 layers (TRAIN_LAYERS: 16
           layers' states take 125 GB), bf16 with a float32 AdamW master,
           2 steps on the train phase's batches: every loss finite, every
           step's peak at or under the plan's estimate, every kernel
           launched as the plan predicts, no plain call;
  train_verify_moe  float32, the same 4 layers, the verify sequences (K =
           3; a 0.7 GB budget, under which the ILP remats [2, 0, 4]
           layers): the chunked step's launches as planned; the
           step with the table zeroed and one unchunked forward and
           backward per sequence within train_verify's 1e-5 (loss and
           each gradient leaf, relative), with the (token, layer) picks
           that differ from the chunked step's and each run's smallest
           margin; a planted router fault (the (k+1)-th pick in place of
           the k-th) must fall outside the limit;
  kernel_mla  kernels A and A′ at deepseek-v2-lite's MLA widths (16 query
           heads, each its own KV head after the latent expansion; q/k 192,
           v 128: ``flash_*_kernel<192, 128>``, nothing padded to a wider
           head), as the attention backward cases above: bf16 on
           train_mla's largest chunk of step 0, float32 on
           train_verify_mla's largest chunk with its carry in front (each
           held to its plain version at TOL, launched again for the same
           bits, its planted faults outside; the bound counts 2·192 + 2·128
           operations a live pair for the forward, 4·192 + 2·128 for dq,
           4·192 + 4·128 for dk/dv; SDPA's EFFICIENT_ATTENTION backend as
           the yardstick where it takes Dv != Dk); the forward with no
           gradient at generate_mla's longest one-shot forward (515 rows:
           split keys and the merge pass); B, C1, C2 at deepseek's head
           (D 2048, V 102400) on both chunks' targets;
  train_mla  deepseek-v2-lite at full width cut to 4 of 27 layers
           (TRAIN_LAYERS), bf16 with a float32 AdamW master, 2 steps on the
           train phase's batches: every loss finite, every step's peak at
           or under the plan's estimate, launches as planned (A and A′ once
           per layer per chunk, B, C1, C2 once per chunk), no plain call,
           a "moe" line;
  train_verify_mla  float32, the same 4 layers, the verify sequences (one
           of 3,000 tokens over 3 chunks: the latent carry and its gradient
           hand-off; table [2, 0, 4]), as train_verify_moe: the zeroed
           table and one unchunked forward and backward per sequence within
           1e-5, flipped picks and margins reported; two planted faults
           (the latent carry's gradient dropped for one chunk, the scores
           scaled by 1/sqrt(Dh) in place of 1/sqrt(Dh + rr)) must fall
           outside;
  generate_mla  deepseek-v2-lite at full width and depth (27 layers), bf16,
           random weights from --seed made layer by layer in bf16:
           ``one_shot_generate`` on the first 2 requests of serve's trace
           (its vocabulary), prompts cut to 512 tokens, 4 new tokens each:
           every id in the vocabulary, A's forward, its tile ranges (and
           the merge pass, where the keys split) 27 times a forward, no
           plain call; then the pipelined prefill and decode
           (``DecodeStepBuilder``, 1x1) on the same prompts and weights,
           its ids held to those one-shot ids under the near-tie rule (the
           bf16 one-shot's margins), its launches as ``_decode_expected``;
  kernel_dense  kernels A and A′ at the widths the remaining decoder
           families and the reduced configs need, as the attention
           backward cases above: (160, 160) on train_stablelm's largest
           chunk of step 0 (bf16, 32 query and 8 KV heads) and on
           train_verify_stablelm's largest chunk with its carry (float32);
           (32, 32) on fig11's 1,024-token sequence and (16, 16) on fig13's
           largest chunk (4 query, 2 KV heads; bf16 and float32; the keys
           split and merged); bf16 A′ on random 1,024-row sequences at
           widths 16 and 64 (RANDOM_BWD_CASES: the draws that a bf16
           Delta took furthest out); the forward with no gradient and the merge
           pass alone at (160, 160) on a 256-row step; B, C1, C2 at
           qwen3-4b's, qwen2-vl-7b's and stablelm-12b's heads (D 2,560,
           3,584, 5,120: C1 and C2 in clusters of 7, 8 and 14 CTAs) on
           each train phase's largest chunk of step 0 (bf16), and float32
           on train_verify_stablelm's chunk; C1's and C2's cluster
           occupancy (``cudaOccupancyMaxActiveClusters``) at every hidden
           width of the registry (the phase fails where it is 0);
  train_qwen3, train_stablelm, train_vl  qwen3-4b (qk-norm), stablelm-12b
           (heads of 160, untied head) and qwen2-vl-7b (M-RoPE at text
           positions, untied head) at full width, cut to the most layers
           whose plans for train's batches the planner estimates under 72
           GB (TRAIN_LAYERS: 15 of 36, 4 of 40, 5 of 28), bf16 with a
           float32 AdamW master, 2 steps on the train phase's batches:
           every loss finite, every step's peak at or under the plan's
           estimate, launches as planned, no plain call;
  train_verify_qwen3, train_verify_stablelm, train_verify_vl  float32 at
           5, 3 and 3 layers (VERIFY_LAYERS: cut from the train phases' 15,
           4 and 5 to keep the script in its time) on
           the verify sequences (one of 3,000 tokens
           over 3 chunks, a packed chunk, a non-zero remat table): launches
           as planned; the step with the table zeroed bitwise equal; one
           unchunked forward and backward per sequence: the loss within
           1e-5 relative, each gradient leaf within 3e-5 of its largest
           value (DENSE_GRAD_LIMIT: the float32 floor, which the same
           corpus packed with no split also reads, sits at 1e-5 at these
           widths), the no-split run held to the same; the chunked and the
           unchunked run each within the same limits of a float64 witness
           (plain float64 attention and cross-entropy, no kernel); a
           planted fault outside them
           (qwen3-4b: the k-norm dropped; stablelm-12b: the KV carry's
           gradient dropped at the hand-off; qwen2-vl-7b: the M-RoPE table
           built from each chunk's row index);
  split_vl  qwen2-vl-7b at full width, float32, train_vl's depth: one
           sequence of 256 patch embeddings from the vision stub (a 16 x 16
           grid) in place of token embeddings at ``mrope_positions_stub``'s
           3-D positions, then 1,792 text tokens, as two chunks with the KV
           carry (cut inside the image span) against the unchunked forward,
           within 1e-5 relative; at text positions on the image span, and
           with its h and w position rows swapped, outside it;
  serve_qwen3  qwen3-4b at full width and depth (36 layers), bf16, served
           as serve serves gemma3-1b: every request completes, A's forward
           and its tile ranges 36 times per engine step;
  generate_dense  stablelm-12b (40 layers) and qwen2-vl-7b (28) at full
           width and depth, bf16, made layer by layer, as generate_mla:
           ``one_shot_generate`` on serve's first 2 requests cut to 512
           prompt tokens, 4 new tokens each; ids in the vocabulary,
           launches as predicted, no plain call;
  kernel_encdec  kernels A and A′ in the encoder-decoder's modes at
           seamless-m4t-v2's heads (16 query and 16 KV heads of 64), as the
           attention backward cases above with causal = 0: non-causal on
           train_encdec's largest chunk of step 0 (the encoder: the frames'
           own segments and positions; bf16) and on train_verify_encdec's
           largest chunk (float32); cross-attention from that train chunk's
           tokens to memory rows of the same segments at zero positions,
           S < T, S = T and S > T (half, as many and 1.5 times each
           segment's rows; bf16); the faults a causal limit (the encoder's)
           and a dropped KV tile; every pass visits exactly the tile pairs
           that hold a live pair; B, C1, C2 at (D 1,024, V 256,206) on both
           chunks' targets; then at a rank's shapes, as train_encdec_sp's
           largest step-0 chunk gives them to the rank of 2 with the most
           live rows: A and A′ for the encoder (its frame block against
           every rank's frames, non-causal), the decoder's self-attention
           (its token block against every rank's tokens, causal) and
           cross-attention (against the gathered memory, zero positions),
           and B, C1, C2 on the second vocabulary block (128,103 rows at
           offset 128,103) on that chunk's targets;
  train_encdec  seamless-m4t-v2 at full width and depth (24 encoder + 24
           decoder layers) through the stage-split pipeline, bf16 with a
           float32 AdamW master, every stage on this card, each sequence
           with as many frames as tokens from the audio stub: a step at
           2x1 under gpipe-1f1b on train's batches, then one step at 4x1
           under zero-bubble-h1 (the split backward) on 7 sequences (8 are
           estimated over 72 GB at 4x1): per step tokens/s, frames, each
           stage's estimate and the card's peak, launches per stage,
           solve_s; every loss finite, every peak at or under its plan's
           estimate, every stage's launches as its plan predicts (A and A′
           once per encoder layer, twice per decoder layer, per chunk; B,
           C1, C2 once per chunk on the last stage), no plain call;
  train_verify_encdec  float32 at full width, 2 + 2 layers, 4 sequences
           (2,550 tokens) at d_p 2 (gpipe-1f1b) and 4 (zero-bubble-h1), a
           remat table whose encoder and decoder rows differ: launches as
           planned; the pipelined step and the whole-batch step (one
           unchunked ``EncDecLM.loss`` a sequence) within 1e-5 (loss and
           each gradient leaf), each within 1e-5 of a float64 witness (plain
           float64 attention and cross-entropy, no kernel); at d_p 4 a
           causal encoder and the memory's gradient dropped at the last
           decoder stage fall outside; then the sequence-parallel and
           pod axes: 2x2 under gpipe-1f1b (ZeRO-3 per_tick), 2x2 under
           zero-bubble-h1 (per_step), 4x2 under gpipe-1f1b, 2 pods of 2x1
           and 2 pods of 2x2 (the plan's pipeline cut in two, one a pod),
           each within 1e-5 of the 2x1 step and of the float64 witness,
           launches as planned; the 2x2 step twice, the same bits; at 2x2
           each rank's cross-attention over its own rank's frames only,
           and a rank's memory gradient dropped on its way back to the
           encoder, fall outside;
  train_encdec_sp  seamless-m4t-v2 at full width and depth at 2x2
           (allgather_kv over both ranks of each stage, ZeRO-3 per_tick),
           bf16 with a float32 AdamW master, 2 steps under gpipe-1f1b on
           train's batches, each sequence with as many frames as tokens:
           per step tokens/s, the collectives' and the memory gathers'
           bytes, each rank's rows for A (queries, keys; frames) and B
           (tokens, vocabulary rows); every loss finite, each stage's
           launches as its plan predicts (per rank), no plain call, the
           card's peak at or under the sum of its ranks' estimates, each
           rank's owned state at or under the charge of the parameters its
           stage holds plus its whole leaves and its share of the
           parameters the planner's count leaves out;
  train_restart  gemma3-1b at full width on 8 of 26 layers
           (RESTART_LAYERS: cut to keep the script in its time), bf16,
           1x1, the
           train phase's batches: steps 0-3 with a checkpoint after steps
           1 and 3 (``ckpt/checkpoint.py`` under ``build/``, which needs
           twice the state free; step 1's is written while steps 2-3
           update the state in place), then a new trainer restored from
           step 1's checkpoint runs steps 2-3: the restored parameters,
           master, moments and step equal the state step 2 started from
           bit for bit, steps 2-3 give the uninterrupted losses and final
           state bit for bit, and a restore keeping the new trainer's own
           master and zero moments (the planted fault) fails the first
           gate; the checkpoint's bytes, the seconds each ``save`` blocks
           the loop (the second reuses the pinned buffers), each write's
           seconds and GB/s, the restore's seconds; launches as planned;
  train_elastic  ``launch/elastic.run``: gemma3-1b at full width on 13
           of its 26 layers (ELASTIC_LAYERS: cut to keep the script in its
           time), 2x1 -> 1x1 -> 2x1 on this card, 2 steps a phase, the
           2x1 phases under zero-bubble-h1 (one virtual stage at both
           depths: a checkpoint moves only between runs of one v), one
           checkpoint and telemetry directory, ``--replan observe``: each
           re-staged restore equals the state saved bit for bit, the loss
           continues, the shrink phase has the ``elastic`` trigger and the
           grow phase none with a calibration of version >= 1, peaks under
           the plans, launches as planned;
  train_replan  gemma3-1b at full width on 2 layers, 2x1, batches of 8 x
           4096, 12 steps, four runs: ``--replan off``, ``observe``,
           ``auto`` (inline jobs, a probe every step, stage 2 reported
           2.5x slow from step 3, cooldown 4) and a replay of the auto
           run's plan journal: observe equals off and the replay the auto
           run, losses and plans bit for bit; no re-plan job failed; the
           triggers, swaps, hysteresis rejects and the adopted
           calibration's deltas from the copied cost model; each run's
           largest step peak over its plan's estimate (printed, not gated
           at this cut: ``phase_train_replan``);
  kernel_sp  the kernels at the shapes a sequence-parallel rank gives
           them, as the cases above (tolerance, faults, bitwise repeat,
           times and bounds), bf16: A and A′ as rank 1 of train_sp's
           step-0 chunk with the most context (allgather_kv: half the
           chunk's query rows at their own positions against the carry and
           every rank's keys; gemma3-1b global layer) and as a ulysses rank
           of train_sp_ulysses (every row of step 0's largest chunk, 8 of
           qwen3-4b's 32 query heads, 2 of its 8 KV heads); B, C1, C2 on
           hymba-1.5b's second vocabulary block (16,000 of 32,001 rows,
           offset 16,001) on train_sp_hymba's largest chunk's targets, most
           of them outside the block; gated D and D′ on rank 1's half of
           that chunk (a non-zero h0, dh0 checked);
  train_sp, train_sp_ulysses, train_sp_hymba, train_sp_per_step,
  train_pods  the sequence-parallel axis through ``launch/train.train``
           (``--mesh PxS --sp-policy --sp-degree``), bf16 with a float32
           AdamW master, 2 steps on the train phase's batches, every stage
           and rank on this card, each rank owning its ZeRO-3 shards of
           its stage's parameters, gradient sums and AdamW state (gathered
           per layer and chunk: ``per_tick``), each rank planned with the
           card's memory over the pods, stages and ranks: gemma3-1b at
           full depth 2x2 (allgather_kv, the only policy at 2 with one KV
           head), qwen3-4b at TRAIN_LAYERS' 15 at 1x4 (ulysses: 8 query and
           2 KV heads a rank), hymba-1.5b at full depth 1x2 (allgather_kv,
           the SSM prefix scan and conv halo), gemma3-1b 2x2 gathering once
           a step (``per_step``), gemma3-1b at full depth on 2 pods of a
           1x2 pipeline (each planned with half the card), 2 steps with the
           plain all-reduce over the pods, then 2 through the int8 one.
           Gates: finite losses, each stage's launches as the plan predicts
           (``_expected_sp_launches``, summed over the pods), no plain
           call, the card's peak at or under the sum of its ranks'
           estimates, each rank's owned state at or under the planner's
           charge (``m_model_states``) plus its leaves kept whole on every
           rank and its share of what the planner's parameter count omits,
           the pods' parameters equal. Per step: tokens/s, the plan's SP
           point, the rows a rank gives A (queries, keys, heads) and B
           (tokens, vocabulary rows), the collectives' count and bytes,
           each rank's owned GB beside its charge, the gathers' and
           reduce-scatters' GB and the most gathered GB alive at once
           beside the largest layer's and stage's;
  train_sp_verify  float32, full width, 2 layers, the verify sequences
           (one over 3 chunks, a remat table from a tight budget): the SP
           step against the whole-batch 1x1 step on the same plan's chunks
           within 1e-5 (loss and each gradient leaf, relative) for
           gemma3-1b 1x2 (allgather_kv), gemma3-1b 1x4 at degree 2 (replica
           groups), qwen3-4b 1x2 (ulysses), hymba-1.5b 1x2, olmoe-1b-7b 1x2
           (ulysses and expert parallelism), deepseek-v2-lite 1x2
           (allgather_kv over latent rows); two runs bit for bit; launches
           as planned; planted faults outside the limit (the CE's lse
           summed, the conv halo from the rank's own rows, the fold
           skipping a rank's a_prod: ``_sp_fault``); hymba's mixer on a
           chunk whose pad rows fill its last rank against the unsharded
           mixer; ZeRO-3 (``_zero3_verify``): gemma3-1b, hymba-1.5b,
           olmoe-1b-7b (ulysses) and deepseek-v2-lite at 1x2, 2x2
           (zero-bubble-h1) and 1x4, ``per_tick`` and ``per_step``, each
           within 1e-5 of the 1x1 step, each arch's 1x2 repeat bit for bit,
           and hymba at 1x3 (most leaves whole on every rank) with its
           gradient norm against the 1x1 step's; 2 pods plain within 1e-5,
           2 pods through the int8 all-reduce within the quantisation bound
           ``n_pods * scale / 2``, also summed over 8 rounds with the error
           fed back; planted faults outside (a gather in the wrong rank
           order, a reduce-scatter keeping each rank's own product, whole
           leaves counted d_s times in the norm, the error feedback
           dropped: ``_zero3_fault``);
  kernel_decode  kernel A as a rank of a decode step runs it (the op with
           its log-sum-exp, ``ops.attention_with_lse``): 8 queries, one a
           sequence, against a rank's 8 x 576 cache rows of hymba-1.5b's
           2x2 decode (25 / 5 heads of 64, bf16), mid-decode and with no
           live row (exact zeros, lse -inf), 16 x 1,088 rows (its 1x1),
           deepseek-v2-lite's (192, 128) over 2 x 576 expanded latent rows,
           hymba's 1x1 in float32; against the plain attention and lse,
           bitwise repeat, faults (the causal limit one off), the op's time
           beside the bytes bound (the cache read once), the plain version
           and SDPA's;
  decode_hymba, decode_falcon_mamba  the pipelined prefill and
           fixed-batch decode (``runtime/serve_step.DecodeStepBuilder``) at
           full width and depth in bf16, random weights from --seed:
           hymba-1.5b (32 layers) on 16 prompts of 1,024 tokens of the
           "github" trace (seed 0), 16 new tokens each, at 1x1 and 2x2 on
           this card (2 stages, 2 SP ranks, n_micro 2, bm 8);
           falcon-mamba-7b (64 layers) on 8 such prompts at 1x1. Per run:
           the prefill's seconds (the batch's TTFT), decode tokens/s and
           TPOT, the peak memory, the state's bytes beside
           ``decode_state_bytes`` (a gate), the launches of the prefill and
           of the decode against ``_decode_expected`` (a gate: A's forward
           and tile ranges, the merge pass, D's passes); every id in the
           vocabulary, no plain call;
  decode_verify  float32 at full width and depth, 2 prompts of 1,024
           tokens, 8 new tokens: hymba-1.5b at 1x1 and 2x2, falcon-mamba-7b
           at 1x1, the ids held to ``one_shot_generate`` under
           ``verify_against_one_shot``'s near-tie rule and the state after
           the last step to ``forward_chunk``'s carry over the same
           sequences (``DECODE_STATE_LIMIT``); planted faults caught: the
           reference's residual (attention term dropped) on hymba, two
           sequences' SSM states swapped on falcon-mamba;
  decode_encdec  seamless-m4t-v2 in float32 at full width and depth (24 +
           24 layers), 2 requests of 256 tokens with 512 frames each from
           the audio stub (--seed), 8 new tokens, at 1x1 and 2x2 (the
           frames in blocks over the ranks): the ids held to the
           teacher-forced ``EncDecLM.encode`` and ``decode`` greedy under
           the near-tie rule; launches and the state's bytes as above;
  dryrun   (run right after build, while nothing else holds the card's
           memory) the port's dry-run (``launch/dryrun``, the H100's
           ``ClusterSpec``) on three production cells: hymba-1.5b
           train_4k at 16x16, gemma3-1b decode_32k on two pods of 16x16,
           seamless-m4t-v2 train_4k at 16x16. On the meta device each cell
           is planned, each rank's holding sized through the port's own
           constructors and each unit traced (train: the plan's largest
           chunk through the last stage, and through the stage with the
           largest estimate; decode: one tick of the first stage); then
           each unit is built on this card from random bf16 weights
           (--seed), all its ranks on the card, its stage's tensors only
           (the others stay on meta), and run once. Gates per unit: each
           rank's holding equals the dry-run's to the byte; each kernel's
           launches equal the trace's calls and no plain call; the
           counted collectives equal the trace's (count and bytes); the
           outputs, carries and gradients the trace's shapes and dtypes;
           the card's peak (``max_memory_allocated`` after a reset, less
           what was allocated before) within DRYRUN_PEAK_TOL of the
           trace's;
  kernels  every kernel of the port with its launch counts on every path
           above (the verify phases' chunked step: the float32 forward, B,
           C1 and C2 run only there).

The last two lines are the kernels JSON and the device JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet, dense): operations per second by the
# inputs' type, and HBM3 bytes per second
H100_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
H100_BYTES_PER_S = 3.35e12
# bf16: a few units of the output's last place (its values are O(0.03) to
# O(1)); float32: the JAX package's kernel-test tolerance
TOL = {"bfloat16": dict(rtol=1e-2, atol=4e-3),
       "float32": dict(rtol=2e-5, atol=2e-5)}


class PhaseError(RuntimeError):
    pass


def _nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise PhaseError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# D's kernels, then D''s (the wrappers' KERNELS; main() checks they agree)
SCAN_KERNELS = ("mamba_scan_fwd_summary_kernel", "mamba_scan_fwd_carry_kernel",
                "mamba_scan_fwd_emit_kernel", "mamba_scan_bwd_summary_kernel",
                "mamba_scan_bwd_carry_kernel", "mamba_scan_bwd_tile_kernel",
                "mamba_scan_reduce_kernel")
KERNEL_NAMES = ("flash_fwd_kernel", "flash_fwd_mma_kernel",
                "flash_combine_kernel", "flash_bwd_dkdv_kernel",
                "flash_bwd_dq_kernel", "flash_bwd_tiles_kernel",
                "ce_fwd_mma_kernel", "ce_bwd_dh_mma_kernel",
                "ce_bwd_dw_mma_kernel", "ce_fwd_kernel", "ce_bwd_kernel",
                *SCAN_KERNELS)
# the tensor-core kernels and the selective scan's: a spill in any of
# their instantiations fails the build phase
NO_SPILL = ("flash_fwd_mma_kernel", "flash_bwd_dkdv_kernel<bf16",
            "flash_bwd_dq_kernel<bf16", "ce_fwd_mma_kernel",
            "ce_bwd_dh_mma_kernel", "ce_bwd_dw_mma_kernel", *SCAN_KERNELS)


def _ptxas_summary(log: str):
    """One line per compiled kernel: name, dtype, head dim or variant,
    registers, shared memory, stack and spills (from ``nvcc -Xptxas -v``)."""
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kind = next((k for k in KERNEL_NAMES if k in ln), "?")
            # the tensor-core kernels take bf16 only
            dt = "bf16" if "bfloat16" in ln or "_mma_" in kind else "f32"
            # the attention kernels' (key, value) widths: one number where
            # they are equal, "192,128" for MLA's
            ints = re.findall(r"Li(\d+)E", ln)
            if len(ints) == 2 and ints[0] == ints[1]:
                ints = ints[:1]
            var = ",".join(ints) if ints else (
                "dw" if "Lb1E" in ln else "dh" if "Lb0E" in ln else "")
            if kind in SCAN_KERNELS and "Lb1E" in ln:
                var += ",gated"
            # a template's mangled name goes on with "I" (its arguments)
            name = (f"{kind}<{dt}{',' + var if var else ''}>"
                    if kind + "I" in ln else kind)
        elif "spill" in ln:
            spill = ln.strip()
        elif "ptxas info" in ln and "Used" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
    return out


# a call that takes this long is timed once after its warm-up: its launch
# jitter is small beside it (a cut to keep the script in its time)
ENOUGH_MS = 100.0
# a warm-up call that takes this long is the timing itself: its one-time
# costs (the first call's allocations and heuristics) are small beside it
# (a cut to keep the script in its time)
LONG_MS = 1000.0


def _cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` calls after ``warmup``
    (CUDA events); one call when the first takes ENOUGH_MS or more; the
    first warm-up call alone when it takes LONG_MS or more."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    for i in range(warmup):
        if i == 0:
            torch.cuda.synchronize()
            a.record()
        fn()
        if i == 0:
            b.record()
            torch.cuda.synchronize()
            if a.elapsed_time(b) >= LONG_MS:
                return a.elapsed_time(b)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    first = a.elapsed_time(b)
    if iters <= 1 or first >= ENOUGH_MS:
        return first
    a.record()
    for _ in range(iters - 1):
        fn()
    b.record()
    torch.cuda.synchronize()
    return (first + a.elapsed_time(b)) / iters


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def _engine_like(rng, segments, n_items, cap_t, Hq, Hkv, D, dtype, dev,
                 window=0, Dv=None):
    """Inputs shaped like one engine step: ``segments`` = [(ctx, n_tok)]
    placed first-fit into ``n_items`` items of ``cap_t`` tokens; the KV
    buffer holds every segment's context rows (with a window, only the
    last ``window - 1``, as the engine gathers them), then all chunk
    rows. q and k are ``D`` wide, v ``Dv`` (default ``D``)."""
    import numpy as np
    import torch
    T = n_items * cap_t
    seg = np.full(T, -1, np.int32)
    pos = np.zeros(T, np.int32)
    fill = [0] * n_items
    ctx_seg, ctx_pos = [], []
    for g, (ctx, n) in enumerate(segments):
        i = next(i for i in range(n_items) if fill[i] + n <= cap_t)
        a = i * cap_t + fill[i]
        seg[a:a + n] = g
        pos[a:a + n] = np.arange(ctx, ctx + n)
        fill[i] += n
        lo = max(0, ctx - window + 1) if window > 0 else 0
        ctx_seg.append(np.full(ctx - lo, g, np.int32))
        ctx_pos.append(np.arange(lo, ctx, dtype=np.int32))
    kseg = np.concatenate(ctx_seg + [seg])
    kpos = np.concatenate(ctx_pos + [pos])
    pad = (-len(kseg)) % 32
    kseg = np.concatenate([kseg, np.full(pad, -2, np.int32)])
    kpos = np.concatenate([kpos, np.zeros(pad, np.int32)])
    S = len(kseg)

    def mk(*shape):
        x = torch.randn(shape, generator=rng, device=dev, dtype=torch.float32)
        return x.to(dtype)
    meta = [torch.from_numpy(a).to(dev) for a in (seg, kseg, pos, kpos)]
    return mk(T, Hq, D), mk(S, Hkv, D), mk(S, Hkv, Dv or D), meta


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _within(got, want, dtype) -> tuple:
    """(max |got - want|, whether every element is within TOL)."""
    tol = TOL[_dtype_name(dtype)]
    err = (got.float() - want.float()).abs()
    ok = bool((err <= tol["atol"] + tol["rtol"] * want.float().abs()).all())
    return float(err.max()), ok


def _bound(flops, nbytes, dtype):
    t_ops = flops / H100_FLOPS[_dtype_name(dtype)]
    t_bytes = nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def _mutants(window, seg_kv, pos_q):
    """Inputs under which the kernel computes what a kernel with one of
    these faults would: a causal or window limit one off, one live KV tile
    of segment 0's context (the one just before its chunk) dropped."""
    n0 = int((seg_kv != 0).nonzero()[0])    # segment 0's context rows
    seg_drop = seg_kv.clone()
    seg_drop[n0 - 32:n0] = -2
    out = {"causal off by one": dict(pos_q=pos_q - 1),
           "one KV tile dropped": dict(seg_kv=seg_drop)}
    if window > 0:
        out["window + 1"] = dict(window=window + 1)
        out["window - 1"] = dict(window=window - 1)
    return out


def _kernel_case(name, segments, Hq, Hkv, D, window, dtype, dev, seed,
                 n_items=4, cap_t=512, Dv=None):
    """The attention op with no gradient (the serving paths') on
    :func:`_engine_like`'s inputs against the plain attention; ``Dv``: the
    value width, if not ``D``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import kv_splits
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, meta = _engine_like(gen, segments, n_items, cap_t, Hq, Hkv, D,
                                 dtype, dev, window, Dv)
    Dv = v.shape[2]
    seg_q, seg_kv, pos_q, pos_kv = meta
    args = dict(q=q, k=k, v=v, seg_q=seg_q, seg_kv=seg_kv, pos_q=pos_q,
                pos_kv=pos_kv, window=window)
    got = ops.flash_attention(**args)
    want = ref.flash_attention_reference(**args)
    max_err, ok = _within(got, want, dtype)
    zeros_ok = int(torch.count_nonzero(got[seg_q < 0])) == 0
    # the op launched twice more must give the same bits
    again = [ops.flash_attention(**args) for _ in range(2)]
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, got) for a in again)
    del again
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split = kv_splits(-(-q.shape[0] // 32) * 32, -(-k.shape[0] // 32) * 32,
                        Hq, n_sm, dtype)
    caught, missed = {}, []
    for fault, change in _mutants(window, seg_kv, pos_q).items():
        caught[fault], inside = _within(
            ops.flash_attention(**{**args, **change}), want, dtype)
        if inside:
            missed.append(fault)
    kernel_ms = _cuda_ms(lambda: ops.flash_attention(**args))
    plain_ms = _cuda_ms(lambda: ref.flash_attention_reference(**args),
                        iters=5, warmup=1)
    mask = ref.attention_mask(seg_q, seg_kv, pos_q, pos_kv, True, window)
    G = Hq // Hkv
    ke = k.repeat_interleave(G, dim=1).transpose(0, 1)[None]
    ve = v.repeat_interleave(G, dim=1).transpose(0, 1)[None]
    qe = q.transpose(0, 1)[None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = _cuda_ms(lambda: sdpa(qe, ke, ve, attn_mask=mask),
                          iters=5, warmup=1)
    pairs = int(mask.sum()) * Hq
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, got)) + \
        sum(t.numel() * 4 for t in meta)
    # Q K^T (2 D flops a live pair), P V (2 Dv)
    bound_ms, bound_by = _bound((2.0 * D + 2.0 * Dv) * pairs, nbytes, dtype)
    rec = dict(case=name, dtype=_dtype_name(dtype), T=q.shape[0],
               S=k.shape[0], Hq=Hq, Hkv=Hkv, D=D, Dv=Dv, window=window,
               live_pairs=pairs, n_split=n_split, max_abs_err=max_err,
               tol=TOL[_dtype_name(dtype)], within_tol=ok,
               masked_rows_zero=zeros_ok, bitwise_repeat=bitwise,
               faults_max_abs_err=caught,
               faults_within_tol=missed, kernel_ms=kernel_ms,
               kernel_ms_is="the op: pad, tile ranges (bf16), forward "
                            "kernel, merge pass where n_split > 1",
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by)
    del ke, ve, mask
    if not (ok and zeros_ok):
        raise PhaseError(f"kernel disagrees with the plain version: {rec}")
    if not bitwise:
        raise PhaseError(f"two launches of the forward differ: {rec}")
    if missed:
        raise PhaseError(f"the tolerance does not catch {missed}: {rec}")
    return rec


def _combine_case(name, segments, Hq, Hkv, D, window, dtype, dev, seed,
                  n_items=4, cap_t=512):
    """The merge pass alone, on the split pass's partial states of one
    engine-step case, against :func:`ref.combine_partials`."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_combine_cuda,
                                                     kv_splits)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, meta = _engine_like(gen, segments, n_items, cap_t, Hq, Hkv, D,
                                 dtype, dev, window)
    padded = ops.pad_for_kernel(q, k, v, *meta)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split = kv_splits(padded[0].shape[0], padded[1].shape[0], Hq, n_sm,
                        dtype)
    ws_ml, ws_acc = flash_attention_cuda.partials(
        *padded, n_split=n_split, window=window,
        tiles=ops._fwd_tiles(padded, True, window))
    got = flash_combine_cuda(ws_ml, ws_acc, dtype)
    want = ref.combine_partials(ws_ml, ws_acc, dtype)
    max_err, ok = _within(got, want, dtype)
    # a merge that loses one split: split 0's sums zeroed
    lost = ws_ml.clone()
    lost[0, ..., 1] = 0
    fault_err, missed = _within(flash_combine_cuda(lost, ws_acc, dtype),
                                want, dtype)
    live = int((ws_ml[..., 1] > 0).sum())
    kernel_ms = _cuda_ms(lambda: flash_combine_cuda(ws_ml, ws_acc, dtype))
    plain_ms = _cuda_ms(lambda: ref.combine_partials(ws_ml, ws_acc, dtype),
                        iters=5, warmup=1)
    # reads every (m, l) and the live splits' acc rows, writes the output;
    # a multiply-add per live element
    nbytes = ws_ml.numel() * 4 + live * D * 4 + got.numel() * \
        got.element_size()
    bound_ms, bound_by = _bound(2.0 * live * D, nbytes, torch.float32)
    rec = dict(case=name, dtype=_dtype_name(dtype), T=q.shape[0],
               n_split=n_split, live_partials=live, max_abs_err=max_err,
               tol=TOL[_dtype_name(dtype)], within_tol=ok,
               faults_max_abs_err={"one split dropped": fault_err},
               faults_within_tol=["one split dropped"] if missed else [],
               kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=bound_ms, bound_by=bound_by)
    if not ok:
        raise PhaseError(f"merge disagrees with the plain version: {rec}")
    if missed:
        raise PhaseError(f"the tolerance does not catch a lost split: {rec}")
    return rec


def phase_kernel(dev):
    import torch
    # one gemma3-1b engine step: a long prompt's last chunk, a middle
    # chunk, two short prompts, twelve decode streams, padding
    dec = [(500 + 300 * i, 1) for i in range(12)]
    gemma = [(3584, 512), (1024, 512), (0, 300), (800, 200)] + dec
    llama = [(1024, 512), (0, 512), (256, 400), (0, 500)] + dec[:4]
    bf16, f32 = torch.bfloat16, torch.float32
    attn = [
        _kernel_case("gemma3-1b global", gemma, 4, 1, 256, 0, bf16, dev, 1),
        _kernel_case("gemma3-1b local", gemma, 4, 1, 256, 512, bf16, dev, 2),
        _kernel_case("llama3.2-3b", llama, 24, 8, 128, 0, bf16, dev, 3),
        _kernel_case("gemma3-1b global", gemma, 4, 1, 256, 0, f32, dev, 4),
        _kernel_case("gemma3-1b local", gemma, 4, 1, 256, 512, f32, dev, 5),
    ]
    merge = [
        _combine_case("gemma3-1b global", gemma, 4, 1, 256, 0, bf16, dev, 1),
        _combine_case("gemma3-1b global", gemma, 4, 1, 256, 0, f32, dev, 4),
    ]
    return attn, merge


def _close_scaled(got, want, dtype) -> tuple:
    """(max |got - want|, within TOL[dtype] with atol scaled by max |want|):
    for gradients and cross-entropy outputs, sums of many terms of both
    signs whose size varies by case."""
    tol = TOL[_dtype_name(dtype)]
    got, want = got.detach().float(), want.detach().float()
    scale = float(want.abs().max()) or 1.0
    err = (got - want).abs()
    ok = bool((err <= tol["atol"] * scale + tol["rtol"] * want.abs()).all())
    return float(err.max()), ok


def _train_chunk(gen, C, pieces, Hq, Hkv, D, dtype, dev):
    """Inputs shaped like one training chunk: ``C`` context rows of
    segment 0 (the carry), 64 stale carry rows beyond the context length
    (seg -1), then the chunk: ``pieces[0]`` rows continuing segment 0 at
    position C, the other pieces packed short sequences, padding to a
    multiple of 64."""
    import numpy as np
    import torch
    T = -(-sum(pieces) // 64) * 64
    seg = np.full(T, -1, np.int32)
    pos = np.zeros(T, np.int32)
    a = 0
    for g, n in enumerate(pieces):
        seg[a:a + n] = g
        pos[a:a + n] = np.arange(n) + (C if g == 0 else 0)
        a += n
    stale = 64
    kseg = np.concatenate([np.zeros(C, np.int32),
                           np.full(stale, -1, np.int32), seg])
    kpos = np.concatenate([np.arange(C + stale, dtype=np.int32), pos])

    def mk(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)
    S = len(kseg)
    meta = [torch.from_numpy(x).to(dev) for x in (seg, kseg, pos, kpos)]
    return mk(T, Hq, D), mk(S, Hkv, D), mk(S, Hkv, D), mk(T, Hq, D), meta


def _plan_chunk(gen, seg, pos, Hq, Hkv, D, dtype, dev, ctx_len=0, cap=0,
                Dv=None):
    """Inputs shaped like one of a plan's chunks: its own seg and pos rows
    as queries and keys, random q, k (``D`` wide), v and output gradient
    (``Dv`` wide, default ``D``). With a carry of ``cap`` rows its keys are
    laid out as the model's attention lays them out: the carry in front
    (rows at positions 0..cap-1, the first ``ctx_len`` of segment 0, the
    rest dead), then the chunk's rows."""
    import numpy as np
    import torch

    def mk(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)
    T = len(seg)
    rows = np.arange(cap, dtype=np.int32)
    kseg = np.concatenate([np.where(rows < ctx_len, 0, -1).astype(np.int32),
                           seg])
    kpos = np.concatenate([rows, pos])
    S, Dv = len(kseg), Dv or D
    meta = [torch.from_numpy(x).to(dev) for x in (seg, kseg, pos, kpos)]
    return mk(T, Hq, D), mk(S, Hkv, D), mk(S, Hkv, Dv), mk(T, Hq, Dv), meta


def _attn_widths(spec):
    """``(Hq, Hkv, Dk, Dv)`` as a model's attention hands kernel A its
    heads: MLA expands its latent rows to one KV head per query head, keys
    ``Dh + rr`` wide and values ``Dh``."""
    if spec.kv_lora_rank > 0:
        return (spec.n_heads, spec.n_heads, spec.head_dim + spec.qk_rope_dim,
                spec.head_dim)
    return spec.n_heads, spec.n_kv_heads, spec.head_dim, spec.head_dim


# the plain versions run over blocks of this many rows, so that their
# materialised [Hq, rows, S] scores or [rows, V] logits fit the card at a
# training chunk's length; a case of at most this many rows is one block
ATTN_ROW_BLOCK = 4096
CE_ROW_BLOCK = 8192


def _plain_attention(q, k, v, seg_q, seg_kv, pos_q, pos_kv, dout, window,
                     row_block=ATTN_ROW_BLOCK, causal=True, ms=None):
    """(out, lse, dq, dk, dv) of the plain attention, over blocks of query
    rows: ``ref.flash_attention_reference``, ``ref.flash_attention_lse``
    and ``ref.flash_attention_grad`` of each block (rows are independent;
    dk and dv are the blocks' sum, in float32). ``ms``: a dict that takes
    the CUDA-event milliseconds of the forward and lse (``"fwd"``) and of
    the gradient (``"grad"``), summed over the blocks (the plain versions'
    times, from this run: a cut, no second run to time them; the ``ref``
    functions compute in float32 whatever their inputs' dtype)."""
    import torch

    from repro_torch.kernels import ref
    outs, lses, dqs, dk, dv = [], [], [], 0.0, 0.0
    events = []
    for a in range(0, q.shape[0], row_block):
        b = slice(a, a + row_block)
        rows = (seg_q[b], seg_kv, pos_q[b], pos_kv)
        kw = dict(window=window, causal=causal)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
            if ms is not None else None
        if ev:
            ev[0].record()
        outs.append(ref.flash_attention_reference(q[b], k, v, *rows, **kw))
        lses.append(ref.flash_attention_lse(q[b], k, *rows, **kw))
        if ev:
            ev[1].record()
        gq, gk, gv = ref.flash_attention_grad(q[b], k, v, *rows, dout[b],
                                              **kw)
        if ev:
            ev[2].record()
            events.append(ev)
        dqs.append(gq)
        dk, dv = dk + gk.float(), dv + gv.float()
    if ms is not None:
        torch.cuda.synchronize()
        ms["fwd"] = sum(e[0].elapsed_time(e[1]) for e in events)
        ms["grad"] = sum(e[1].elapsed_time(e[2]) for e in events)
    return (torch.cat(outs), torch.cat(lses, dim=1), torch.cat(dqs),
            dk.to(k.dtype), dv.to(v.dtype))


def _attn_bwd_case(name, inputs, drop, window, dtype, dev, seed,
                   row_block=ATTN_ROW_BLOCK, causal=True):
    """The attention backward (both passes), the forward's output and its
    lse on one training chunk made by ``inputs(gen, dtype)``, against
    autograd of the plain attention in float32 (over blocks of
    ``row_block`` query rows). ``drop``: the KV rows of one live tile, for
    the dropped-tile fault. ``causal=False`` (the encoder-decoder's
    encoder and cross-attention): the faults are a causal limit where the
    positions are not all zero (the encoder's; at cross-attention's zero
    positions it changes nothing) and the dropped tile, and each pass
    must visit exactly the tile pairs that hold a live pair."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import (BWD_BLOCK,
                                                     flash_attention_cuda,
                                                     flash_bwd_dkdv_cuda,
                                                     flash_bwd_dq_cuda,
                                                     flash_bwd_tiles_cuda,
                                                     FWD_KERNELS, kv_splits,
                                                     tile_counts)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout, meta = inputs(gen, dtype)
    (T, Hq, Dk), (Hkv, Dv) = q.shape, v.shape[1:]
    seg_q, seg_kv, pos_q, pos_kv = meta

    def grads(seg_kv=seg_kv, pos_q=pos_q, window=window, causal=causal):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = ops.flash_attention(qq, kk, vv, seg_q, seg_kv, pos_q, pos_kv,
                                  window=window, causal=causal)
        out.backward(dout)
        return qq.grad, kk.grad, vv.grad

    def err_of(got):
        errs = [_close_scaled(g, w, dtype) for g, w in zip(got, want)]
        return max(e for e, _ in errs), all(ok for _, ok in errs)
    plain_t = {}
    want_out, want_lse, *want = _plain_attention(
        q.float(), k.float(), v.float(), *meta, dout.float(), window,
        row_block, causal, ms=plain_t)
    max_err, ok = err_of(grads())
    padded = ops.pad_for_kernel(q, k, v, *meta)
    # the forward as the train step runs it: the tile ranges (bf16), then
    # the forward kernel with lse (and the merge pass where the keys split)
    fwd_tiles = ops._fwd_tiles(padded, causal, window)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    fwd_split = kv_splits(padded[0].shape[0], padded[1].shape[0], Hq, n_sm,
                          dtype)

    def forward():
        return flash_attention_cuda(*padded, window=window, with_lse=True,
                                    tiles=fwd_tiles, causal=causal)
    out, lse = forward()
    out_err, out_ok = _within(out[:T], want_out, dtype)
    live, got_lse = torch.isfinite(want_lse), lse[:, :T]
    lse_err = float((got_lse[live] - want_lse[live]).abs().max())
    lse_ok = bool(torch.equal(torch.isfinite(got_lse), live)) and \
        lse_err <= TOL["float32"]["atol"] + TOL["float32"]["rtol"] * float(
            want_lse[live].abs().max())
    del got_lse
    # the forward launched twice more must give the same bits
    fwd_runs = [forward() for _ in range(2)]
    torch.cuda.synchronize()
    fwd_bitwise = all(torch.equal(o2, out) and torch.equal(l2, lse)
                      for o2, l2 in fwd_runs)
    del fwd_runs
    # faults: a causal limit one off, a live KV tile dropped, a window one
    # off; each must take the gradients and the forward's output outside
    # the tolerance
    seg_drop = seg_kv.clone()
    seg_drop[drop] = -2
    faults = {"one KV tile dropped": dict(seg_kv=seg_drop)}
    if causal:
        faults["causal off by one"] = dict(pos_q=pos_q - 1)
    elif bool((pos_q != 0).any()):
        faults["causal limit"] = dict(causal=True)
    if window > 0:
        faults["window + 1"] = dict(window=window + 1)
        faults["window - 1"] = dict(window=window - 1)
    caught, missed, fwd_caught = {}, [], {}
    for fault, change in faults.items():
        caught[fault], inside = err_of(grads(**change))
        fargs = dict(seg_kv=seg_kv, pos_q=pos_q, window=window,
                     causal=causal) | change
        fwd_caught[fault], fwd_inside = _within(ops.flash_attention(
            q, k, v, seg_q, fargs["seg_kv"], fargs["pos_q"], pos_kv,
            window=fargs["window"], causal=fargs["causal"]), want_out, dtype)
        if inside or fwd_inside:
            missed.append(fault)
    del want_out, want_lse
    pm = [t.contiguous() for t in padded[3:]]
    do = ops.pad_rows(dout, 32).contiguous()
    # the passes as the op runs them: the tile ranges, the dq pass (it
    # writes Delta), then the dk/dv pass; each timed alone, then both passes
    # launched twice more for the bitwise repeat check. The ranges and
    # summaries must equal their plain version's.
    # (every timed function below has run on these inputs already, the
    # library's backward excepted: no warm-up launch)
    block = BWD_BLOCK[dtype]
    tiles_ms = _cuda_ms(lambda: flash_bwd_tiles_cuda(
        *pm, window=window, block=block, causal=causal), iters=5, warmup=0)
    tiles = flash_bwd_tiles_cuda(*pm, window=window, block=block,
                                 causal=causal)
    plain_tiles, tiles_plain_ms = _timed(lambda: ref.flash_attention_tiles(
        *pm, window=window, block=block, causal=causal))
    tiles_err = max(int((getattr(tiles, n).long() - w.long()).abs().max())
                    for n, w in zip(("kv_range", "q_range", "q_summary",
                                     "kv_summary"), plain_tiles))
    del plain_tiles
    bwd_args = (*padded[:3], out, do, lse, *pm)
    bwd_kw = dict(window=window, delta=torch.empty_like(lse), tiles=tiles,
                  causal=causal)
    ms = {"dq": _cuda_ms(lambda: flash_bwd_dq_cuda(*bwd_args, **bwd_kw),
                         iters=3, warmup=0),
          "dkdv": _cuda_ms(lambda: flash_bwd_dkdv_cuda(*bwd_args, **bwd_kw),
                           iters=3, warmup=0)}
    runs = []
    for _ in range(2):
        kw = dict(bwd_kw, delta=torch.empty_like(lse))
        runs.append((flash_bwd_dq_cuda(*bwd_args, **kw),
                     *flash_bwd_dkdv_cuda(*bwd_args, **kw), kw["delta"]))
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(*runs))
    del runs
    # the plain versions' times: their run for the tolerance above
    plain_ms, fwd_plain_ms = plain_t["grad"], plain_t["fwd"]
    # live pairs, and the tile pairs (per head) that hold one at the passes'
    # tile size, over blocks of query rows
    S = k.shape[0]
    n_kv = -(-S // block)
    pairs, live_tiles = 0, 0
    for a in range(0, T, 64 * block):
        b = slice(a, a + 64 * block)
        mask = ref.attention_mask(seg_q[b], seg_kv, pos_q[b], pos_kv, causal,
                                  window)
        pairs += int(mask.sum()) * Hq
        rows = mask.shape[0]
        mask = torch.nn.functional.pad(
            mask, (0, n_kv * block - S, 0, -(-rows // block) * block - rows))
        live_tiles += int(mask.view(-1, block, n_kv, block).any(3).any(1)
                          .sum())
        del mask
    tiles_walked = {p: dict(c, live=live_tiles) for p, c in
                    tile_counts(tiles, window=window, causal=causal).items()}
    # without a causal limit or a window a tile pair whose summaries meet
    # holds a live pair (a packed tile's segments are a run of ids): each
    # pass visits exactly the live tile pairs
    untight = {p: c for p, c in tiles_walked.items()
               if not causal and window == 0 and c["visited"] != live_tiles}
    # per live (query, key, head), products of 2 Dk flops (S = Q K^T, dQ =
    # dS K, dK = dS^T Q) or 2 Dv flops (dP = dO V^T, O = P V, dV = P^T dO):
    # the backward as a whole needs S recomputed, dP, dV, dQ, dK (6 Dk +
    # 4 Dv); the dk/dv pass alone S, dP, dV, dK (4 Dk + 4 Dv), the dq pass
    # alone S, dP, dQ (4 Dk + 2 Dv). Bytes: q, k, v, out, dout, lse and the
    # metadata read once, the pass's gradients written once.
    size = {n: t.numel() * t.element_size() for n, t in
            (("q", q), ("k", k), ("v", v), ("o", dout))}
    common = size["q"] + 2 * size["o"] + size["k"] + size["v"] + \
        lse.numel() * 4 + sum(t.numel() * 4 for t in meta)
    bounds = {"all": _bound((6.0 * Dk + 4.0 * Dv) * pairs, common + size["q"]
                            + size["k"] + size["v"], dtype),
              "dkdv": _bound((4.0 * Dk + 4.0 * Dv) * pairs,
                             common + size["k"] + size["v"], dtype),
              "dq": _bound((4.0 * Dk + 2.0 * Dv) * pairs, common + size["q"],
                           dtype)}
    # the ranges' kernel: the four metadata vectors read once, the ranges
    # and summaries written once (its pair tests are a few per tile)
    n_tiles = -(-T // block) + -(-S // block)
    bounds["tiles"] = _bound(0.0, sum(t.numel() * 4 for t in pm)
                             + 24 * n_tiles, dtype)
    # the forward as the train step runs it (split pass and merge pass,
    # writing lse): S = Q K^T (2 Dk flops per live pair) and O = P V (2
    # Dv); q, k, v and the metadata read once, out and lse written once
    bounds["fwd"] = _bound((2.0 * Dk + 2.0 * Dv) * pairs, size["q"]
                           + size["o"] + size["k"] + size["v"]
                           + lse.numel() * 4
                           + sum(t.numel() * 4 for t in meta), dtype)
    fwd_ms = _cuda_ms(forward, iters=3, warmup=0)
    bound_ms, bound_by = bounds["all"]
    kernel_ms = ms["dkdv"] + ms["dq"]
    # the library yardstick: scaled_dot_product_attention with the boolean
    # mask on its memory-efficient backend (no materialised scores), forward
    # and backward, K and V repeated over the GQA group
    library_ms, library_why = None, None
    G = Hq // Hkv
    mask = ref.attention_mask(seg_q, seg_kv, pos_q, pos_kv, causal, window)
    qe = q.transpose(0, 1)[None].detach().requires_grad_(True)
    ke, ve = (t.repeat_interleave(G, dim=1).transpose(0, 1)[None]
              .detach().requires_grad_(True) for t in (k, v))
    de = dout.transpose(0, 1)[None]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            o = sdpa(qe, ke, ve, attn_mask=mask)
        torch.autograd.grad(o, (qe, ke, ve), de)
    def library_fwd():
        with torch.no_grad(), sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            sdpa(qe, ke, ve, attn_mask=mask)
    try:
        library_ms = _cuda_ms(library, iters=2, warmup=1)
    except (RuntimeError, torch.OutOfMemoryError) as e:
        library_why = f"{type(e).__name__}: {str(e).splitlines()[0][:240]}"
    library_fwd_ms = None
    if library_why is None:
        library_fwd_ms = _cuda_ms(library_fwd, iters=3, warmup=0)
    del mask, qe, ke, ve, de
    torch.cuda.empty_cache()
    rec = dict(case=name, dtype=_dtype_name(dtype), T=q.shape[0],
               S=k.shape[0], Hq=Hq, Hkv=Hkv, D=Dk, Dv=Dv, window=window,
               causal=causal,
               live_pairs=pairs, max_abs_err=max_err, lse_max_abs_err=lse_err,
               out_max_abs_err=out_err, tol=TOL[_dtype_name(dtype)],
               within_tol=ok and lse_ok and out_ok,
               faults_max_abs_err=caught, faults_within_tol=missed,
               kernel_ms=kernel_ms, kernel_ms_covers="dk/dv pass + dq pass",
               kernel_ms_dkdv=ms["dkdv"], kernel_ms_dq=ms["dq"],
               bound_ms_dkdv=bounds["dkdv"][0],
               bound_by_dkdv=bounds["dkdv"][1], bound_ms_dq=bounds["dq"][0],
               bound_by_dq=bounds["dq"][1], plain_ms=plain_ms,
               plain_is=f"autograd of the plain attention: dq, dk, dv at "
                        f"once, over blocks of {row_block} query rows (its "
                        f"run for the tolerance, on the inputs in float32, "
                        f"as ref computes)",
               library_ms=library_ms,
               library_is=("scaled_dot_product_attention with the boolean "
                           "mask on the EFFICIENT_ATTENTION backend, forward "
                           "and backward under autograd (K, V repeated over "
                           "the GQA group)" if library_ms is not None else
                           f"no single call: the EFFICIENT_ATTENTION "
                           f"backend refused the case, nothing padded "
                           f"({library_why})"),
               tiles_ms=tiles_ms, tiles_plain_ms=tiles_plain_ms,
               tiles_max_abs_err=tiles_err, tiles_bound_ms=bounds["tiles"][0],
               tiles_bound_by=bounds["tiles"][1],
               tiles_ms_is="flash_bwd_tiles_kernel: both passes' tile "
                           "ranges and summaries, once per backward op; "
                           "plain: ref.flash_attention_tiles (the mask, one "
                           "cold run)",
               tiles=tiles_walked, bwd_block=block, bitwise_repeat=bitwise,
               fwd_kernel=FWD_KERNELS[dtype], fwd_ms=fwd_ms,
               fwd_n_split=fwd_split, fwd_bitwise_repeat=fwd_bitwise,
               fwd_faults_max_abs_err=fwd_caught, fwd_plain_ms=fwd_plain_ms,
               fwd_bound_ms=bounds["fwd"][0],
               fwd_bound_by=bounds["fwd"][1], fwd_library_ms=library_fwd_ms,
               fwd_ms_is="the attention forward as the train step runs it, "
                         "with lse, on the op's tile ranges (bf16; their "
                         "kernel is tiles_ms): the forward kernel, and "
                         "flash_combine_kernel where the keys are split "
                         "(fwd_n_split > 1); fwd_plain_ms: ref's output and "
                         "lse over blocks of query rows (its run for the "
                         "tolerance); fwd_library_ms: "
                         "scaled_dot_product_attention forward on the "
                         "EFFICIENT_ATTENTION backend with the same boolean "
                         "mask (null: no single call, library_is says why)",
               bound_ms=bound_ms, bound_by=bound_by)
    if not (ok and lse_ok and out_ok):
        raise PhaseError(f"attention backward disagrees with the plain "
                         f"version: {rec}")
    if not (bitwise and fwd_bitwise):
        raise PhaseError(f"two launches of the forward or the backward "
                         f"passes differ: {rec}")
    if tiles_err:
        raise PhaseError(f"flash_bwd_tiles_kernel disagrees with its plain "
                         f"version: {rec}")
    if untight:
        raise PhaseError(f"a backward pass visits tile pairs that hold no "
                         f"live pair: {untight}; {rec}")
    if missed:
        raise PhaseError(f"the tolerance does not catch {missed}: {rec}")
    if "train chunk" in name and dtype == torch.bfloat16 and fwd_split != 1:
        raise PhaseError(f"the forward splits the keys of a train chunk "
                         f"(a workspace and a merge pass): {rec}")
    return rec


CE_HEADS = {"gemma3-1b": (1152, 262144), "llama3.2-3b": (3072, 128256),
            "hymba-1.5b": (1600, 32001), "olmoe-1b-7b": (2048, 50304),
            "deepseek-v2-lite": (2048, 102400),
            "qwen3-4b": (2560, 151936), "qwen2-vl-7b": (3584, 152064),
            "stablelm-12b": (5120, 100352),
            "seamless-m4t-v2": (1024, 256206)}
# the cross-entropy wrapper of each function (cross_entropy.KERNELS names
# the kernel it launches by dtype)
CE_WRAPPER = {"B": "fwd", "C1": "dh", "C2": "dw"}
CE_T = 8192
# the train phases: github batches of 8 sequences of up to 16,384 tokens
# (2 steps: room for the sequence-parallel phases in the script's time;
# every gate still runs on each step)
TRAIN_BATCH, TRAIN_CONTEXT, TRAIN_STEPS = 8, 16384, 2
# the train phases cut olmoe-1b-7b to 4 of its 16 layers, every width
# kept: 16 layers' states take 125 GB, 4 take 34 GB of the card's 80;
# deepseek-v2-lite to 4 of its 27 (states 49.7 GB; the plan's estimates for
# train's batches 68.1 / 65.7 / 64.3 GB; 27 layers' states take 291 GB).
# The dense families: each at the most layers whose plans for train's
# three batches the planner estimates under 72 GB (of the card's 80): qwen3-
# 4b 15 of 36 (41.3 GB of states; 70.7 / 72.0 / 71.0 GB; at 16 step 0's is
# 72.5; 36 layers' states take 79.4), stablelm-12b 4 of 40 (38.5 GB; 68.7 /
# 64.9 / 62.5; at 5 step 2's is 72.6), qwen2-vl-7b 5 of 28 (40.6 GB; 69.8 /
# 71.1 / 71.7; at 6 step 0's is 72.7)
TRAIN_LAYERS = {"olmoe-1b-7b": 4, "deepseek-v2-lite": 4, "qwen3-4b": 15,
                "stablelm-12b": 4, "qwen2-vl-7b": 5}


def _arch(name):
    """``name``'s config as the train phases run it (:data:`TRAIN_LAYERS`
    cuts the depth)."""
    from repro_torch.configs import get_arch
    cfg = get_arch(name)
    return cfg.with_layers(TRAIN_LAYERS[name]) if name in TRAIN_LAYERS \
        else cfg


def _plain_ce(key, h, w, tgt, lse, g):
    """The plain version of B, C1 or C2 (``ref``) over blocks of
    CE_ROW_BLOCK tokens: rows are independent in B and C1; C2 is the sum
    of its blocks in float32 (the plain version upcasts its inputs and
    casts its result to w's dtype)."""
    import torch

    from repro_torch.kernels import ref
    blocks = [slice(a, a + CE_ROW_BLOCK)
              for a in range(0, h.shape[0], CE_ROW_BLOCK)]
    if key == "B":
        parts = [ref.cross_entropy_fwd_plain(h[b], w, tgt[b])
                 for b in blocks]
        return tuple(torch.cat(x) for x in zip(*parts))
    if key == "C1":
        return torch.cat([ref.cross_entropy_bwd_dh_plain(
            h[b], w, tgt[b], lse[b], g[b]) for b in blocks])
    wf = w.float()
    return sum(ref.cross_entropy_bwd_dw_plain(h[b].float(), wf, tgt[b],
                                              lse[b], g[b])
               for b in blocks).to(w.dtype)


def _ce_case(arch, dtype, dev, seed, targets=None, case=None, shard=None):
    """Kernels B, C1 and C2 on one chunk against their plain versions
    (materialised logits in float32): ``targets`` (int32, -1 on rows
    without a target) as the train step feeds them, each valid row's loss
    weighted 1 / n_valid, named ``case``; else CE_T random targets
    weighted 1 / CE_T. Two targets are moved into the last vocab tile.
    ``shard = (offset, rows)``: the head's vocabulary block of a
    sequence-parallel rank (``runtime/sp.row_blocks``), the targets
    shifted by its offset as ``sp.sharded_ce`` shifts them (most then fall
    outside the block and must match none of its rows)."""
    import torch

    from repro_torch.kernels.cross_entropy import (KERNELS, VOCAB_TILE,
                                                   ce_bwd_dh_cuda,
                                                   ce_bwd_dw_cuda,
                                                   ce_fwd_cuda,
                                                   d_slice_width,
                                                   vocab_splits)
    D, V = CE_HEADS[arch]
    gen = torch.Generator(device=dev).manual_seed(seed)
    if targets is None:
        tgt = torch.randint(0, V, (CE_T,), generator=gen, device=dev,
                            dtype=torch.int32)
    else:
        tgt = targets.to(dev, torch.int32).clone()
    T = tgt.shape[0]
    case = case or f"{arch} head, {T} random targets"
    valid = (tgt >= 0).float()
    if shard is not None:
        off, V = shard
        tgt = torch.where(tgt >= 0, tgt - off, tgt)
    h = torch.randn((T, D), generator=gen, device=dev).to(dtype)
    w = (torch.randn((V, D), generator=gen, device=dev) * 0.02).to(dtype)
    tgt[0], tgt[1] = V - 1, V - 2        # targets in the last vocab tile
    #                                      (V - 1 alone there at V = 32001)
    valid[:2] = 1.0
    g = valid / valid.sum()
    lse_p, tl_p = _plain_ce("B", h, w, tgt, None, None)
    f32 = torch.float32
    recs = {}
    # faults: a target shifted by one; the last vocab tile dropped
    shifted = tgt + 1
    w_cut = w[:V - VOCAB_TILE]

    # lse is held to an absolute limit (its values are ~log V; a dropped
    # tile moves it by ~1e-4)
    lse_tol = TOL["float32"]["atol"]

    def fwd_check(out):
        lse, tl = out
        e_tl, ok_tl = _close_scaled(tl, tl_p, f32)
        e_lse = float((lse - lse_p).abs().max())
        return max(e_tl, e_lse), ok_tl and e_lse <= lse_tol
    plain = {key: functools.partial(_plain_ce, key, h, w, tgt, lse_p, g)
             for key in ("B", "C1", "C2")}
    kern = {"B": lambda t=tgt, ww=w: ce_fwd_cuda(h, ww, t),
            "C1": lambda t=tgt, ww=w: ce_bwd_dh_cuda(h, ww, t, lse_p, g),
            "C2": lambda t=tgt, ww=w: ce_bwd_dw_cuda(h, ww, t, lse_p, g)}
    names = {key: KERNELS[which][dtype] for key, which in CE_WRAPPER.items()}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    eb = 2 if dtype == torch.bfloat16 else 4
    in_bytes = (T * D + V * D) * eb + T * 4
    for key in ("B", "C1", "C2"):
        # the plain version timed on the run that gives the reference (it
        # takes 0.1-2 s; timing a second run cost the script ~20 s)
        want, plain_ms = _timed(plain[key])

        def check(out, want=want, key=key):
            if key == "B":
                return fwd_check(out)
            if key == "C2" and out.shape[0] != want.shape[0]:
                out = torch.cat([out, torch.zeros_like(want[out.shape[0]:])])
            return _close_scaled(out, want, dtype)
        got = kern[key]()
        max_err, ok = check(got)
        # the same launch again must give the same bits (no kernel has
        # atomics on its outputs; B's split merge runs in split order)
        again = kern[key]()
        bitwise = all(torch.equal(a, b) for a, b in
                      zip(got if key == "B" else (got,),
                          again if key == "B" else (again,)))
        del got, again
        caught, missed = {}, []
        for fault, out in (("target shifted by one", kern[key](t=shifted)),
                           ("one vocab tile dropped", kern[key](ww=w_cut))):
            caught[fault], inside = check(out)
            if inside:
                missed.append(fault)
        # both have run on these inputs already: no warm-up launch
        kernel_ms = _cuda_ms(kern[key], iters=2, warmup=0)
        library_ms = library_bf16_ms = library_bf16_why = None
        if key == "B":      # the materialised-logits yardsticks
            library_ms = _cuda_ms(lambda: torch.logsumexp(
                h.float() @ w.float().T, dim=-1), iters=1, warmup=1)
            if dtype == torch.bfloat16:
                # cuBLAS's bf16 tensor-core path with float32 output
                # (aten::mm.dtype, CUDA only)
                try:
                    library_bf16_ms = _cuda_ms(lambda: torch.logsumexp(
                        torch.mm(h, w.T, out_dtype=torch.float32), -1),
                        iters=1, warmup=1)
                except (TypeError, RuntimeError, NotImplementedError) as e:
                    library_bf16_why = (f"{type(e).__name__}: "
                                        f"{str(e).splitlines()[0][:200]}")
        products = 1 if key == "B" else 2     # C1/C2: logits, contraction
        out_bytes = {"B": 8 * T, "C1": T * D * eb, "C2": V * D * eb}[key]
        extra = 0 if key == "B" else 8 * T    # lse, g
        bound_ms, bound_by = _bound(2.0 * T * V * D * products,
                                    in_bytes + extra + out_bytes, dtype)
        rec = dict(name=names[key], kernel=key, case=case,
                   dtype=_dtype_name(dtype), T=T, D=D, V=V,
                   d_slices=(-(-D // d_slice_width(D, dtype))
                             if key != "B" else None),
                   vocab_splits=(vocab_splits(T, V, n_sm, dtype)
                                 if key == "B" else None),
                   max_abs_err=max_err, tol=TOL[_dtype_name(dtype)],
                   within_tol=ok, faults_max_abs_err=caught,
                   faults_within_tol=missed, bitwise_repeat=bitwise,
                   kernel_ms=kernel_ms, plain_ms=plain_ms,
                   plain_is=f"ref's plain version over blocks of "
                            f"{CE_ROW_BLOCK} tokens, the run that gives "
                            f"the reference",
                   library_ms=library_ms,
                   library_is=("h.float() @ W.float().T + logsumexp, "
                               "logits materialised" if key == "B" else None),
                   library_bf16_ms=library_bf16_ms,
                   library_bf16_is=(
                       None if key != "B" or dtype != torch.bfloat16 else
                       "logsumexp(torch.mm(h, W.T, out_dtype=float32))"
                       if library_bf16_why is None else
                       f"not timed: {library_bf16_why}"),
                   bound_ms=bound_ms, bound_by=bound_by)
        del want
        if not ok:
            raise PhaseError(f"{key} disagrees with the plain version: {rec}")
        if not bitwise:
            raise PhaseError(f"two launches of {key} differ: {rec}")
        if missed:
            raise PhaseError(f"the tolerance does not catch {missed}: {rec}")
        recs[key] = rec
    return recs


def _plan_chunks(corpus, plan):
    """The plan's chunks as the step feeds them to the model:
    ``[(chunk, targets, seg, pos)]`` (numpy rows), the largest first."""
    from repro_torch.data.batching import materialize_plan
    from repro_torch.runtime.train_step import chunk_arrays
    chunks = [c for p in plan.pipelines for c in p.chunks]
    batch = materialize_plan(plan, corpus)
    order = sorted(range(len(chunks)), key=lambda i: -chunks[i].tokens)
    return [(chunks[k], *chunk_arrays(batch, k, chunks[k].tokens)[1:])
            for k in order]


def _train_chunks(seed, arch="gemma3-1b"):
    """Step 0's chunks in ``arch``'s train phase (:func:`_plan_chunks`)."""
    from repro_torch.core import ClusterSpec, CostModel
    from repro_torch.launch.train import plan_step
    cfg = _arch(arch)
    chunks = _plan_chunks(*plan_step(CostModel(cfg.spec, ClusterSpec()),
                                     _train_loop(seed), 0))
    if chunks[0][0].context:
        raise PhaseError(f"step 0's largest chunk continues a sequence; "
                         f"its kernel cases need the carry rows: "
                         f"{chunks[0][0]}")
    return chunks


# the verify phases' activation budget beside the model states: 2 GB,
# under which the ILP checkpoints layers of some chunks (gemma3-1b: [23,
# 0, 26]); olmoe-1b-7b's and deepseek-v2-lite's 4 layers hold the whole
# batch's activations in 1.6 and 1.8 GB, so their budget is 0.7 GB (table
# [2, 0, 4] for both)
VERIFY_BUDGET = {"olmoe-1b-7b": 0.7e9, "deepseek-v2-lite": 0.7e9}
# the float32 verify phases' depth where it is cut below TRAIN_LAYERS' (so
# that the script fits its time with the ZeRO-3 phases): each plan keeps a
# 3-chunk split, a packed chunk and a non-zero remat table
VERIFY_LAYERS = {"qwen3-4b": 5, "stablelm-12b": 3, "qwen2-vl-7b": 3}


def _verify_plan(arch, seed):
    """The float32 verify phases' batch for ``arch``: ``(cfg, corpus,
    plan)``, four sequences of 3,000, 900, 500 and 300 random tokens split
    over K = 3 chunks, under an activation budget (VERIFY_BUDGET, else 2
    GB) so that the ILP checkpoints layers of some chunks."""
    import numpy as np

    from repro_torch.core import (ClusterSpec, CostModel, PlannerConfig,
                                  plan_batch)
    cfg = _arch(arch)
    if arch in VERIFY_LAYERS:
        cfg = cfg.with_layers(VERIFY_LAYERS[arch])
    rng = np.random.default_rng(seed)
    lens = [3000, 900, 500, 300]
    corpus = {i: rng.integers(0, cfg.spec.vocab, n).astype(np.int32)
              for i, n in enumerate(lens)}
    cm = CostModel(cfg.spec, ClusterSpec())
    plan = plan_batch(cm, lens, PlannerConfig(
        fixed_k=3, bucket_rounding=64, remat_mode="stage_aware",
        capacity_bytes=cm.m_model_states(1) + VERIFY_BUDGET.get(arch, 2e9)))
    return cfg, corpus, plan



def _verify_attn_case(arch, phase, seed, dev):
    """``_attn_bwd_case``'s arguments for the largest chunk of ``arch``'s
    float32 verify plan as the step feeds it to a global attention layer:
    the chunk's seg and pos, its carry's live rows in front of its keys
    (``models/attention``: the carry holds its sequence's rows so far),
    and the last context tile as the dropped tile."""
    cfg, corpus, plan = _verify_plan(arch, seed)
    chunk, _, seg, pos = _plan_chunks(corpus, plan)[0]
    if not chunk.context:
        raise PhaseError(f"{phase}'s largest chunk has no carry: {chunk}")
    Hq, Hkv, Dk, Dv = _attn_widths(cfg.spec)

    def inputs(gen, dtype):
        return _plan_chunk(gen, seg, pos, Hq, Hkv, Dk, dtype, dev,
                           chunk.context, chunk.context, Dv=Dv)
    name = f"{phase} chunk ({chunk.tokens} tokens, carry {chunk.context})"
    return name, inputs, slice(chunk.context - 32, chunk.context)


def phase_kernel_training(dev, seed):
    """The attention backward and B, C1, C2: first at the shapes of the
    train phase's largest chunk of step 0 (gemma3-1b, bf16, the chunk's
    own segments, positions and targets), then on chunks with context rows
    and on both archs' heads at CE_T tokens, bf16 and float32; the
    attention and B, C1, C2 in float32 at the largest chunk of each
    float32 verify phase (gemma3-1b's and hymba-1.5b's, the chunk's own
    metadata with its carry and its own targets), the only train paths
    that launch the float32 kernels."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    chunk, tgt, seg, pos = _train_chunks(seed)[0]
    name = f"gemma3-1b train chunk ({chunk.tokens} tokens)"
    a0 = int((seg >= 0).argmax())           # a live tile inside segment 0
    plan_rows = slice(a0 + 1024, a0 + 1056)

    def from_plan(gen, dtype):
        return _plan_chunk(gen, seg, pos, 4, 1, 256, dtype, dev)

    def with_context(C, pieces, Hq, Hkv, D):
        return lambda gen, dtype: _train_chunk(gen, C, pieces, Hq, Hkv, D,
                                               dtype, dev)
    gemma = with_context(12288, (3072, 600, 400), 4, 1, 256)
    llama = with_context(4096, (1536, 300, 200), 24, 8, 128)
    # the dropped tile: 32 rows inside segment 0, or with context rows the
    # last context tile before the chunk
    bwd = []
    for args in ((f"{name} global", from_plan, plan_rows, 0, bf16),
                 (f"{name} local", from_plan, plan_rows, 512, bf16),
                 ("gemma3-1b global", gemma, slice(12288 - 32, 12288), 0,
                  bf16),
                 ("gemma3-1b local", gemma, slice(12288 - 32, 12288), 512,
                  bf16),
                 ("llama3.2-3b", llama, slice(4096 - 32, 4096), 0, bf16),
                 ("gemma3-1b global", gemma, slice(12288 - 32, 12288), 0,
                  f32),
                 # the float32 forward and backward at the verify phases'
                 # chunks, the train paths that launch them
                 (*_verify_attn_case("gemma3-1b", "train_verify", seed, dev),
                  0, f32),
                 (*_verify_attn_case("hymba-1.5b", "train_verify_hymba",
                                     seed, dev), 0, f32)):
        bwd.append(_attn_bwd_case(*args, dev, 11 + len(bwd)))
        print(f"[kernel] attention backward {json.dumps(bwd[-1])}",
              flush=True)
        torch.cuda.empty_cache()
    ce = [_ce_case("gemma3-1b", bf16, dev, 19, targets=torch.from_numpy(tgt),
                   case=name)]
    for rec in ce[-1].values():
        print(f"[kernel] cross-entropy {json.dumps(rec)}", flush=True)
    torch.cuda.empty_cache()
    for i, (arch, dt) in enumerate([("gemma3-1b", bf16), ("gemma3-1b", f32),
                                    ("llama3.2-3b", bf16),
                                    ("llama3.2-3b", f32)]):
        ce.append(_ce_case(arch, dt, dev, 20 + i))
        for rec in ce[-1].values():
            print(f"[kernel] cross-entropy {json.dumps(rec)}", flush=True)
        torch.cuda.empty_cache()
    for i, (arch, phase) in enumerate((("gemma3-1b", "train_verify"),
                                       ("hymba-1.5b", "train_verify_hymba"))):
        v_chunk, v_tgt = _plan_chunks(*_verify_plan(arch, seed)[1:])[0][:2]
        ce.append(_ce_case(arch, f32, dev, 24 + i,
                           targets=torch.from_numpy(v_tgt),
                           case=f"{phase} chunk ({v_chunk.tokens} tokens)"))
        for rec in ce[-1].values():
            print(f"[kernel] cross-entropy {json.dumps(rec)}", flush=True)
        torch.cuda.empty_cache()
    return bwd, ce


def _timed(fn):
    """(fn(), its ms by CUDA events): one cold run, for the plain
    versions that take seconds."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def _scan_stage_ms(fwd, bwd):
    """ms of each selective-scan kernel on one call's arguments (``fwd``,
    ``bwd``: the wrappers' prepared calls, D's outputs feeding D'), by CUDA
    events, and of D and D' whole. The summary, emit, per-tile and
    reduction passes run alone (each rewrites only its own outputs); a
    carry pass turns the summaries into its output in place, so each of
    its runs follows a summary pass and its own events bracket it alone.
    D runs whole last, so that D' reads its carried checkpoints."""
    import torch

    def ms(call, *names):
        return _cuda_ms(lambda: [call.launch(n) for n in names], iters=10,
                        warmup=2)

    def after(call, first, name, iters=10, warmup=2):
        for _ in range(warmup):
            call.launch(first)
            call.launch(name)
        evs = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
               for _ in range(iters)]
        for a, b in evs:
            call.launch(first)
            a.record()
            call.launch(name)
            b.record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in evs) / iters
    out = {}
    for call, names in ((fwd, SCAN_KERNELS[:3]), (bwd, SCAN_KERNELS[3:])):
        out[names[0]] = ms(call, names[0])
        out[names[1]] = after(call, names[0], names[1])
        for n in names[2:]:
            out[n] = ms(call, n)
    out["D'"] = ms(bwd, *SCAN_KERNELS[3:])
    out["D"] = ms(fwd, *SCAN_KERNELS[:3])
    return out


def _scan_bounds(T, DI, DS, e, gated):
    """``{kernel or function: (bound_ms, bound_by)}`` of the selective
    scan at ``T x DI x DS``; ``e`` gives the bytes per element of delta
    (gated: dt_pre), xs, z (0 ungated), y (gated: out), dy (gated: dout),
    D''s ``[T, DI]`` gradients together, and B (as of C).

    The functions' bounds (``D``, ``D'``), which the kernels line gives
    each of their kernels as ``bound_ms``, count only their own inputs and
    outputs (no checkpoints, no partials) and 8 and 16 operations per
    cell, plus the prologue's and the epilogue's about 15 and 20 per (row,
    channel) when gated. Each kernel's entry here is this design's bound
    for that pass (``design_bound_ms``), not the function's: what the pass
    itself reads and writes (the summaries, checkpoints and partials
    between the passes too) and its own float32 operations per (row,
    channel, state): summary 5 (d A, exp, the input, the update), emit 7
    (and y), the reverse summary 5, the per-tile pass 21 (the states
    recomputed once, and 16 for the gradient), a carry 4 per tile and
    state, the reduction one add per partial."""
    import torch
    d, x, z, y, dy, grads, bc = (e[k] for k in ("delta", "xs", "z", "y",
                                                 "dy", "grads", "B"))
    nT, groups = -(-T // 64), -(-DI // 128)
    cells, rc, st, tds = T * DI * DS, T * DI, nT * DI * DS, T * DS
    small = 4 * DI * DS + 2 * T + (8 * DI if gated else 0)  # A, flags, ...
    g_f, g_b = (15 * rc, 20 * rc) if gated else (0, 0)
    carry = (4 * st, 4 * (2 * st + nT * DI + 2 * DI * DS))
    work = {
        "mamba_scan_fwd_summary_kernel": (
            5 * cells, (d + x) * rc + tds * bc + small + 4 * (st + nT * DI)),
        "mamba_scan_fwd_carry_kernel": carry,
        "mamba_scan_fwd_emit_kernel": (
            7 * cells + g_f, (d + x + z + y) * rc + 2 * tds * bc + small
            + 4 * st),
        "mamba_scan_bwd_summary_kernel": (
            5 * cells, (d + z + dy) * rc + tds * bc + small
            + 4 * (st + nT * DI)),
        "mamba_scan_bwd_carry_kernel": carry,
        "mamba_scan_bwd_tile_kernel": (
            21 * cells + g_b, (d + x + z + dy + grads) * rc + 2 * tds * bc
            + small + 4 * (3 * st + groups * 2 * tds
                           + (2 * nT * DI if gated else 0))),
        "mamba_scan_reduce_kernel": (
            groups * 2 * tds + st, 4 * (groups * 2 * tds + st + 2 * tds
                                        + DI * DS)),
        "D": (8 * cells + g_f, (d + x + z + y) * rc + 2 * tds * bc + small
              + 4 * DI * DS),
        "D'": (16 * cells + g_b, (d + x + z + dy + grads) * rc
               + 2 * tds * bc + 4 * 2 * tds + small + 4 * 3 * DI * DS)}
    return {k: _bound(ops, nbytes, torch.float32)
            for k, (ops, nbytes) in work.items()}


def _scan_case(name, T, DI, DS, reset_rows, xs_dtype, dev, seed):
    """Kernel D (``mamba_scan_fwd_*_kernel``) and D'
    (``mamba_scan_bwd_*_kernel``, ``mamba_scan_reduce_kernel``) of the
    ungated scan on one chunk against the plain scan and its stepwise
    reverse pass (``ref``), on the same inputs: delta, B and C float32 and
    xs in ``xs_dtype``, a sequence start at each of ``reset_rows``, a
    non-zero h0, random output gradients on y and h_last. Both sides
    compute in float32 from the same values, so every case is held to the
    float32 tolerance. Faults fed to the kernels, each of which must fall
    outside it in D and in D': the resets shifted by one row, h0 dropped
    (where row 0 continues the carry), the last time tile dropped. D and
    D' launched again give the same bits."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.kernels.mamba_scan import (SCAN_TILE,
                                                mamba_scan_bwd_cuda,
                                                mamba_scan_fwd_cuda)
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=f32)
    delta = torch.nn.functional.softplus(rnd(T, DI))
    xs = rnd(T, DI).to(xs_dtype)
    B, C = rnd(T, DS), rnd(T, DS)
    A = -torch.exp(rnd(DI, DS) * 0.3)
    h0, dy, dh = rnd(DI, DS), rnd(T, DI), rnd(DI, DS)
    reset_np = np.zeros(T, np.int32)
    reset_np[np.asarray(reset_rows, np.int64)] = 1
    reset = torch.from_numpy(reset_np).to(dev)

    def kernels(reset=reset, h0=h0, rows=T):
        sl = slice(0, rows)
        y, hl, ck = ops.mamba_scan_fwd(delta[sl], xs[sl], B[sl], C[sl], A,
                                       reset[sl], h0)
        dd, dx, dB, dC, dA, dh0 = ops.mamba_scan_bwd(
            delta[sl], xs[sl], B[sl], C[sl], A, reset[sl], h0, ck, dy[sl],
            dh)

        def full(t):            # rows a faulty kernel never wrote: zeros
            return torch.cat([t, t.new_zeros((T - rows, t.shape[1]))])
        return [full(y), hl], [full(dd), full(dx), full(dB), full(dC), dA,
                               dh0]

    def err_of(got, want):
        errs = [_close_scaled(g, w, f32) for g, w in zip(got, want)]
        return max(e for e, _ in errs), all(ok for _, ok in errs)
    want_f, plain_ms = _timed(lambda: list(ref.mamba_scan_reference(
        delta, xs, B, C, A, reset, h0)))
    (_, *want_g), plain_ms_bwd = _timed(lambda: ref.mamba_scan_grad(
        delta, xs, B, C, A, reset, h0, dy, dh))
    got_f, got_g = kernels()
    f_err, f_ok = err_of(got_f, want_f)
    g_err, g_ok = err_of(got_g, want_g)
    again_f, again_g = kernels()
    bitwise = all(torch.equal(a, b) for a, b in zip(got_f + got_g,
                                                    again_f + again_g))
    del again_f, again_g
    faults = {"resets shifted by one row": dict(reset=torch.roll(reset, 1)),
              "last time tile dropped": dict(rows=T - SCAN_TILE)}
    if reset_np[0] == 0:
        faults["h0 dropped"] = dict(h0=torch.zeros_like(h0))
    caught, missed = {}, []
    for fault, change in faults.items():
        ff, gg = kernels(**change)
        (ef, in_f), (eg, in_g) = err_of(ff, want_f), err_of(gg, want_g)
        caught[fault] = {"D": ef, "D'": eg}
        if in_f or in_g:
            missed.append(fault)
    del got_f, got_g, want_f, want_g
    # the kernels alone, pass by pass
    ins = (delta, xs, B, C, A, reset != 0)
    fwd, (_, _, ck) = mamba_scan_fwd_cuda.prepare(*ins, h0)
    fwd.run()
    bwd, _ = mamba_scan_bwd_cuda.prepare(*ins, ck, dy, dh)
    ms = _scan_stage_ms(fwd, bwd)
    del fwd, bwd, ck
    bounds = _scan_bounds(T, DI, DS, dict(
        delta=4, xs=xs.element_size(), z=0, y=4, dy=4, grads=8, B=4),
        gated=False)
    rec = dict(case=name, dtype=f"delta/B/C float32, xs "
               f"{_dtype_name(xs_dtype)}", T=T, DI=DI, DS=DS,
               resets=int(reset_np.sum()), row0_continues=bool(
                   reset_np[0] == 0),
               max_abs_err=f_err, bwd_max_abs_err=g_err, tol=TOL["float32"],
               within_tol=f_ok and g_ok, bitwise_repeat=bitwise,
               faults_max_abs_err=caught, faults_within_tol=missed,
               kernel_ms=ms["D"], kernel_ms_bwd=ms["D'"], kernel_ms_by=ms,
               plain_ms=plain_ms, plain_ms_bwd=plain_ms_bwd,
               plain_is="ref.mamba_scan_reference (one step at a time) and "
                        "ref.mamba_scan_grad (a stepwise reverse pass, "
                        "checked against jax.grad in tests/test_torch_ssm.py)"
                        ", one run",
               bound_covers="D, D' (and each of their kernels): the "
                            "function's own inputs and outputs (no "
                            "checkpoints, no partials); design_bound_ms_by: "
                            "what each pass of this design reads and writes",
               library_ms=None, library_is="no single call",
               bound_ms=bounds["D"][0], bound_by=bounds["D"][1],
               bound_ms_bwd=bounds["D'"][0], bound_by_bwd=bounds["D'"][1],
               design_bound_ms_by={k: v[0] for k, v in bounds.items()},
               design_bound_by_by={k: v[1] for k, v in bounds.items()})
    if not (f_ok and g_ok):
        raise PhaseError(f"the scan kernels disagree with the plain "
                         f"version: {rec}")
    if missed:
        raise PhaseError(f"the tolerance does not catch {missed}: {rec}")
    if not bitwise:
        raise PhaseError(f"the scan kernels differ on a repeat: {rec}")
    return rec


def _gated_scan_case(name, seg, pos, DI, DS, dtype, dev, seed):
    """The mixer's fused scan (D and D' gated: softplus prologue, skip and
    gate epilogue) on one chunk against its plain version
    (``ref.mamba_scan_gated`` and ``_grad``, float32 math rounded where
    the mixer rounds), on the same inputs in ``dtype``: the chunk's own
    live rows (``seg >= 0``) and sequence starts, and its last 37 rows as
    pad rows (as a split slice leaves them before the carry), ``dt_pre``
    around the mixer's softplus bias, B, C and z as row slices of their
    projections (as the mixer passes them), a non-zero h0, random output
    gradients. Outputs in ``dtype`` (out, d_pre, d_xc, dz) are held to
    its tolerance (a float32 difference can flip a bf16 rounding), the
    float32 ones (h_last, dB, dC, dA, d_bias, d_dskip, dh0) to the float32
    tolerance. Faults fed to the kernels, each of which must fall outside
    those: the skip dropped (d_skip 0), pad rows not made neutral (live
    ignored). D and D' launched again give the same bits."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.kernels.mamba_scan import (Gate, mamba_scan_bwd_cuda,
                                                mamba_scan_fwd_cuda)
    T = len(seg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=f32)
    live_np = np.asarray(seg) >= 0
    live_np[-37:] = False
    reset_np = (np.asarray(pos) == 0) & live_np
    case = dict(dt_pre=(rnd(T, DI) - 2.0).to(dtype), xc=rnd(T, DI).to(dtype),
                B=rnd(T, 4 + 2 * DS).to(dtype)[:, 4:4 + DS],
                C=rnd(T, 4 + 2 * DS).to(dtype)[:, 4 + DS:],
                z=rnd(T, 2 * DI).to(dtype)[:, DI:], dt_bias=rnd(DI) * 0.5,
                A=-torch.exp(rnd(DI, DS) * 0.3), d_skip=rnd(DI),
                live=torch.from_numpy(live_np).to(dev),
                reset=torch.from_numpy(reset_np).to(dev), h0=rnd(DI, DS))
    dout, dh = rnd(T, DI).to(dtype), rnd(DI, DS)

    def kernels(**change):
        c = {**case, **change}
        out, hl, ck = ops.mamba_scan_gated_fwd(**c)
        grads = ops.mamba_scan_gated_bwd(**c, ckpt=ck, dout=dout, dh_last=dh)
        return [out, hl], list(grads)

    def err_of(got, want):
        errs = [_close_scaled(g, w, dtype if g.dtype == dtype else f32)
                for g, w in zip(got, want)]
        return max(e for e, _ in errs), all(ok for _, ok in errs)
    want_f, plain_ms = _timed(lambda: list(ref.mamba_scan_gated(**case)))
    want_g, plain_ms_bwd = _timed(lambda: list(ref.mamba_scan_gated_grad(
        **case, dout=dout, dh_last=dh)))
    got_f, got_g = kernels()
    f_err, f_ok = err_of(got_f, want_f)
    g_err, g_ok = err_of(got_g, want_g)
    again_f, again_g = kernels()
    bitwise = all(torch.equal(a, b) for a, b in zip(got_f + got_g,
                                                    again_f + again_g))
    del got_f, got_g, again_f, again_g
    faults = {"skip dropped": dict(d_skip=torch.zeros_like(case["d_skip"])),
              "pad rows not made neutral": dict(
                  live=torch.ones_like(case["live"]))}
    caught, missed = {}, []
    for fault, change in faults.items():
        ff, gg = kernels(**change)
        (ef, in_f), (eg, in_g) = err_of(ff, want_f), err_of(gg, want_g)
        caught[fault] = {"D": ef, "D'": eg}
        if in_f or in_g:
            missed.append(fault)
    del want_f, want_g
    gate = Gate(bias=case["dt_bias"], live=case["live"], z=case["z"],
                d_skip=case["d_skip"])
    ins = [case[k] for k in ("dt_pre", "xc", "B", "C", "A", "reset")]
    fwd, (_, _, ck) = mamba_scan_fwd_cuda.prepare(*ins, case["h0"], gate=gate)
    fwd.run()
    bwd, _ = mamba_scan_bwd_cuda.prepare(*ins, ck, dout, dh, gate=gate)
    ms = _scan_stage_ms(fwd, bwd)
    del fwd, bwd, ck
    e = case["xc"].element_size()
    bounds = _scan_bounds(T, DI, DS, dict(
        delta=e, xs=e, z=e, y=e, dy=e, grads=3 * e, B=e), gated=True)
    rec = dict(case=name, dtype=f"gated, every [T, *] input "
               f"{_dtype_name(dtype)}", T=T, DI=DI, DS=DS,
               pad_rows=int((~live_np).sum()), resets=int(reset_np.sum()),
               max_abs_err=f_err, bwd_max_abs_err=g_err,
               tol={"rounded outputs": TOL[_dtype_name(dtype)],
                    "float32 outputs": TOL["float32"]},
               within_tol=f_ok and g_ok, bitwise_repeat=bitwise,
               faults_max_abs_err=caught, faults_within_tol=missed,
               kernel_ms=ms["D"], kernel_ms_bwd=ms["D'"], kernel_ms_by=ms,
               plain_ms=plain_ms, plain_ms_bwd=plain_ms_bwd,
               plain_is="ref.mamba_scan_gated and ref.mamba_scan_gated_grad "
                        "(the plain scan and its stepwise reverse pass with "
                        "the prologue and epilogue in float32), one run",
               bound_covers="D, D' (and each of their kernels): dt_pre, "
                            "xc, z, B, C (and dout) read once in their "
                            "dtype, out (and the gradients) written once; "
                            "design_bound_ms_by: what each pass of this "
                            "design reads and writes",
               library_ms=None, library_is="no single call",
               bound_ms=bounds["D"][0], bound_by=bounds["D"][1],
               bound_ms_bwd=bounds["D'"][0], bound_by_bwd=bounds["D'"][1],
               design_bound_ms_by={k: v[0] for k, v in bounds.items()},
               design_bound_by_by={k: v[1] for k, v in bounds.items()})
    if not (f_ok and g_ok):
        raise PhaseError(f"the gated scan kernels disagree with the plain "
                         f"version: {rec}")
    if missed:
        raise PhaseError(f"the tolerance does not catch {missed}: {rec}")
    if not bitwise:
        raise PhaseError(f"the gated scan kernels differ on a repeat: {rec}")
    return rec


def phase_kernel_ssm(dev, seed):
    """hymba-1.5b's kernels at its train phase's shapes (step 0's largest
    chunk: 16,384 rows, its own sequence starts): the ungated D and D' (DI
    3200, DS 16) with float32 delta, B, C and bf16 xs and all in float32;
    D and D' on step 0's most packed chunk with row 0 continuing a carry
    (so h0 counts); D and D' at falcon-mamba-7b's width (DI 8192, DS 16,
    8,192 rows, bf16 xs as its bf16 mixer would feed them); the gated D
    and D' (the mixer's fused scan, as the train step runs it) on the
    largest chunk in bf16 and on train_verify_hymba's largest chunk in
    float32; the attention forward and backward at hymba's heads (25 query
    heads, 5 KV heads of 64) and B, C1, C2 with its head (D 1600, V 32001:
    one target in the last, ragged vocab tile) on the largest chunk,
    bf16."""
    import numpy as np
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    chunks = _train_chunks(seed, "hymba-1.5b")
    big, tgt, seg, pos = chunks[0]
    name = f"hymba-1.5b train chunk ({big.tokens} tokens)"

    def starts(seg, pos):
        return np.flatnonzero((pos == 0) & (seg >= 0))
    packed = max(chunks, key=lambda c: len(starts(c[2], c[3])))
    p_seg, p_pos = packed[2], packed[3]
    p_starts = starts(p_seg, p_pos)
    carried = p_starts[p_starts > 0]
    scan = []
    for args in (
            (f"{name}, its sequence starts", len(seg), 3200, 16,
             starts(seg, pos), bf16),
            (f"{name}, its sequence starts", len(seg), 3200, 16,
             starts(seg, pos), f32),
            (f"hymba-1.5b packed chunk ({packed[0].tokens} tokens, "
             f"{len(p_starts)} sequences), row 0 continuing a carry",
             len(p_seg), 3200, 16, carried, f32),
            ("falcon-mamba-7b width, 8,192 rows of that packed chunk, row 0 "
             "continuing a carry", 8192, 8192, 16, carried[carried < 8192],
             bf16)):
        scan.append(_scan_case(*args, dev, 31 + len(scan)))
        print(f"[kernel] selective scan {json.dumps(scan[-1])}", flush=True)
        torch.cuda.empty_cache()
    _, v_corpus, v_plan = _verify_plan("hymba-1.5b", seed)
    v_chunk, _, v_seg, v_pos = _plan_chunks(v_corpus, v_plan)[0]
    gated = []
    for args in ((f"{name}, its sequences, gated", seg, pos, 3200, 16, bf16),
                 (f"train_verify_hymba chunk ({v_chunk.tokens} tokens), "
                  f"gated", v_seg, v_pos, 3200, 16, f32)):
        gated.append(_gated_scan_case(*args, dev, 37 + len(gated)))
        print(f"[kernel] selective scan {json.dumps(gated[-1])}", flush=True)
        torch.cuda.empty_cache()
    a0 = int((seg >= 0).argmax())

    def from_plan(gen, dtype):
        return _plan_chunk(gen, seg, pos, 25, 5, 64, dtype, dev)
    attn = _attn_bwd_case(f"{name} global", from_plan,
                          slice(a0 + 1024, a0 + 1056), 0, bf16, dev, 41,
                          row_block=1024)
    print(f"[kernel] attention backward {json.dumps(attn)}", flush=True)
    torch.cuda.empty_cache()
    ce = _ce_case("hymba-1.5b", bf16, dev, 42, targets=torch.from_numpy(tgt),
                  case=name)
    for rec in ce.values():
        print(f"[kernel] cross-entropy {json.dumps(rec)}", flush=True)
    torch.cuda.empty_cache()
    return scan, gated, attn, ce


# ---------------------------------------------------------------------------
# serve / verify phases
# ---------------------------------------------------------------------------

def _requests(trace, max_new=None):
    from repro_torch.serve.engine import Request
    return [Request(req_id=i, prompt=t["prompt"],
                    max_new_tokens=max_new or t["max_new_tokens"],
                    arrival=t["arrival"]) for i, t in enumerate(trace)]


def _econf(trace, max_new):
    from repro_torch.serve.engine import EngineConfig
    page_sz = 16
    longest = max(len(t["prompt"]) for t in trace)
    pp = -(-(longest + max_new) // page_sz)
    return EngineConfig(n_items=4, cap_t=512, n_pages=6 * pp,
                        page_sz=page_sz, pages_per_seq=pp, k=1)


def phase_serve(dev, cfg, params32, trace):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (FWD_KERNELS,
                                                     flash_attention_cuda,
                                                     flash_bwd_tiles_cuda,
                                                     flash_combine_cuda,
                                                     kv_splits)
    from repro_torch.models.model import tree_map
    from repro_torch.serve.engine import ServeEngine
    params = tree_map(lambda a: a.to(torch.bfloat16), params32)
    econf = _econf(trace, 32)
    # the engine's steps split their keys (the merge pass) where their
    # query tiles x heads do not fill the card: gemma3-1b's 4 heads, not
    # olmoe-1b-7b's 16
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    split = kv_splits(econf.n_items * econf.cap_t, econf.n_pages *
                      econf.page_sz, cfg.spec.n_heads, n_sm) > 1
    # warm-up (cuBLAS handles, the kernel's first launch): one request
    warm = ServeEngine(cfg, econf, params=params,
                       param_dtype=torch.bfloat16, device=dev)
    warm.run(_requests(trace[:1], max_new=2))
    del warm
    eng = ServeEngine(cfg, econf, params=params, param_dtype=torch.bfloat16,
                      device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mma = FWD_KERNELS[torch.bfloat16]
    flash_attention_cuda.launches = 0
    flash_attention_cuda.by_kernel[mma] = 0
    flash_combine_cuda.launches = 0
    flash_bwd_tiles_cuda.launches = 0
    ops.flash_attention.plain_calls = 0
    results = eng.run(_requests(trace))
    launches = flash_attention_cuda.launches
    mma_launches = flash_attention_cuda.by_kernel[mma]
    merges = flash_combine_cuda.launches
    ranges = flash_bwd_tiles_cuda.launches
    plain = ops.flash_attention.plain_calls
    st = eng.stats()
    rec = dict(completed=st["completed"], requests=len(trace),
               steps=st["steps"], tokens_per_s=st["tokens_per_s"],
               wall_s=st["wall_s"], ttft_s_p50=st["ttft_s_p50"],
               ttft_s_p95=st["ttft_s_p95"], tpot_s_p50=st["tpot_s_p50"],
               tpot_s_p95=st["tpot_s_p95"],
               prefill_tokens_fed=st["prefill_tokens_fed"],
               emitted_tokens=st["emitted_tokens"],
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               flash_launches=launches, flash_mma_launches=mma_launches,
               flash_launches_expected=cfg.spec.n_layers * st["steps"],
               tile_range_launches=ranges, combine_launches=merges,
               merge_pass_expected=split, plain_attention_calls=plain)
    bad = [r for r in results.values() if len(r.output_ids) != 32]
    if st["completed"] != len(trace) or bad:
        raise PhaseError(f"not every request completed: {rec}")
    want = cfg.spec.n_layers * st["steps"]
    if launches != want or mma_launches != want or ranges != want \
            or (merges > 0) != split or plain != 0:
        raise PhaseError(f"serve path did not run on the kernel: {rec}")
    return rec


def phase_verify(dev, cfg, params32, trace):
    import torch

    from repro_torch.serve.engine import ServeEngine, verify_against_one_shot
    sub = trace[:2]
    eng = ServeEngine(cfg, _econf(sub, 8), params=params32,
                      param_dtype=torch.float32, device=dev)
    res = eng.run(_requests(sub, max_new=8))
    ok, lines = verify_against_one_shot(
        cfg, params32, [t["prompt"] for t in sub],
        [res[i].output_ids for i in range(len(sub))], 8,
        compute_dtype=torch.float32, device=dev)
    if not ok:
        raise PhaseError("; ".join(lines))
    return lines


# ---------------------------------------------------------------------------
# train / train_verify phases
# ---------------------------------------------------------------------------

class _KernelCount:
    """The launches of one ``__global__`` kernel behind a wrapper that
    launches several (a cross-entropy wrapper, one kernel per dtype; a
    selective-scan wrapper, one kernel per pass), from its ``by_kernel``,
    read and zeroed as a wrapper's ``launches``."""

    def __init__(self, wrapper, kernel):
        self.wrapper, self.kernel = wrapper, kernel

    @property
    def launches(self):
        return self.wrapper.by_kernel[self.kernel]

    @launches.setter
    def launches(self, n):
        self.wrapper.by_kernel[self.kernel] = n


def _train_counters():
    from repro_torch.kernels import ops
    from repro_torch.kernels.cross_entropy import (KERNELS, ce_bwd_dh_cuda,
                                                   ce_bwd_dw_cuda,
                                                   ce_fwd_cuda)
    from repro_torch.kernels.flash_attention import (FWD_KERNELS,
                                                     flash_attention_cuda,
                                                     flash_bwd_dkdv_cuda,
                                                     flash_bwd_dq_cuda,
                                                     flash_bwd_tiles_cuda,
                                                     flash_combine_cuda)
    from repro_torch.kernels.mamba_scan import (mamba_scan_bwd_cuda,
                                                mamba_scan_fwd_cuda)
    ce = {name: _KernelCount(w, name)
          for w in (ce_fwd_cuda, ce_bwd_dh_cuda, ce_bwd_dw_cuda)
          for name in KERNELS[w.which].values()}
    scan = {name: _KernelCount(w, name)
            for w in (mamba_scan_fwd_cuda, mamba_scan_bwd_cuda)
            for name in w.KERNELS}
    fwd = {name: _KernelCount(flash_attention_cuda, name)
           for name in FWD_KERNELS.values()}
    return {**fwd, "flash_combine_kernel": flash_combine_cuda,
            "flash_bwd_dkdv_kernel": flash_bwd_dkdv_cuda,
            "flash_bwd_dq_kernel": flash_bwd_dq_cuda,
            "flash_bwd_tiles_kernel": flash_bwd_tiles_cuda,
            **ce, **scan,
            "plain_attention": ops.flash_attention,
            "plain_cross_entropy": ops.fused_cross_entropy,
            "plain_mamba_scan": ops.mamba_scan}


def _expected_launches(cfg, plan, depths, dtype=None):
    """Launches of one chunked step as its ``plan`` predicts (``depths``:
    each chunk's remat depth): per layer and chunk one attention forward
    (and one more per remat'd layer, whose forward runs again in the
    backward) with its tile-range launch (the forward computes the ranges
    and hands them to the backward), one of each attention backward pass;
    for bf16 no merge pass (a training chunk's forward runs unsplit); the
    same for the selective scan on mamba layers (each of D's three passes
    as the forward, each of D''s four as the backward); B, C1, C2 once
    per chunk, through the kernels of the step's ``dtype`` (default bf16);
    no plain call."""
    import torch

    from repro_torch.kernels.cross_entropy import KERNELS
    from repro_torch.kernels.flash_attention import FWD_KERNELS
    from repro_torch.kernels.mamba_scan import (mamba_scan_bwd_cuda,
                                                mamba_scan_fwd_cuda)
    from repro_torch.models.config import LayerKind
    dtype = dtype or torch.bfloat16
    L, n_chunks, depth = cfg.spec.n_layers, len(depths), sum(depths)
    attn = cfg.layer_kind != LayerKind.MAMBA
    ssm = cfg.spec.ssm_state > 0
    fwd, bwd = L * n_chunks + depth, L * n_chunks
    ce = {name: 0 for names in KERNELS.values() for name in names.values()}
    for names in KERNELS.values():
        ce[names[dtype]] += n_chunks
    attn_fwd = {name: 0 for name in FWD_KERNELS.values()}
    attn_fwd[FWD_KERNELS[dtype]] = fwd if attn else 0
    out = {**attn_fwd,
           "flash_bwd_dkdv_kernel": bwd if attn else 0,
           "flash_bwd_dq_kernel": bwd if attn else 0,
           "flash_bwd_tiles_kernel": fwd if attn else 0,
           **{n: fwd if ssm else 0 for n in mamba_scan_fwd_cuda.KERNELS},
           **{n: bwd if ssm else 0 for n in mamba_scan_bwd_cuda.KERNELS},
           **ce, "plain_attention": 0,
           "plain_cross_entropy": 0, "plain_mamba_scan": 0}
    if dtype == torch.bfloat16:
        out["flash_combine_kernel"] = 0
    return out


def _read_counts(ctr):
    return {k: (c.plain_calls if k.startswith("plain") else c.launches)
            for k, c in ctr.items()}


def _zero_counts(ctr):
    for k, c in ctr.items():
        if k.startswith("plain"):
            c.plain_calls = 0
        else:
            c.launches = 0


def _train_loop(seed):
    from repro_torch.launch.train import TrainConfig
    return TrainConfig(steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                       context=TRAIN_CONTEXT, seed=seed,
                       compute_dtype="bfloat16")


def phase_train(dev, seed, arch="gemma3-1b"):
    import math

    import torch

    from repro_torch.launch.train import train
    from repro_torch.runtime.train_step import remat_depths
    cfg = _arch(arch)
    L = cfg.spec.n_layers
    ctr = _train_counters()
    steps_out, expected = [], {}

    def on_step(step, plan, corpus, trainer):
        if expected:
            steps_out[-1]["launches"] = _read_counts(ctr)
        n = plan.n_chunks
        depths = remat_depths(plan, L)
        expected.clear()
        expected.update(_expected_launches(cfg, plan, depths))
        steps_out.append({"expected": dict(expected),
                          "remat_depths": sum(depths), "remat_table": depths,
                          "chunks": n,
                          "chunk_tokens": [c.tokens for p in plan.pipelines
                                           for c in p.chunks]})
        _zero_counts(ctr)
    lines = []
    _, hist = train(cfg, _train_loop(seed), device=dev, on_step=on_step,
                    log=lines.append)
    steps_out[-1]["launches"] = _read_counts(ctr)
    recs = []
    for h, st, ln in zip(hist, steps_out, lines):
        rec = dict(h, **st)
        recs.append(rec)
        print(f"[train] {ln}", flush=True)
        if not math.isfinite(h["loss"]):
            raise PhaseError(f"non-finite loss: {rec}")
        # a peak above the plan's own estimate is a wrong plan
        if h["peak_mem_gb"] > h["plan_peak_mem_gb"]:
            raise PhaseError(f"peak memory {h['peak_mem_gb']:.2f} GB above "
                             f"the plan's estimate "
                             f"{h['plan_peak_mem_gb']:.2f} GB: {rec}")
        bad = {k: (st["launches"][k], v) for k, v in st["expected"].items()
               if st["launches"][k] != v}
        if bad:
            raise PhaseError(f"launch counts differ from the plan's "
                             f"(got, expected): {bad}; {rec}")
    torch.cuda.empty_cache()
    return recs


# the float32 verify phases' limit on the loss's and each gradient leaf's
# relative difference (train_verify's and train_verify_moe's)
VERIFY_LIMIT = 1e-5


def phase_train_verify(dev, seed):
    """float32, full width: the chunked step with the plan's remat table ==
    the same step with the table zeroed == one unchunked forward/backward
    per sequence (loss and every gradient within VERIFY_LIMIT relative)."""
    import torch

    from repro_torch.models import DecoderLM
    from repro_torch.models.model import tree_leaves
    from repro_torch.runtime.train_step import ChunkedTrainer, remat_depths
    cfg, corpus, plan = _verify_plan("gemma3-1b", seed)
    chunks = [c for p in plan.pipelines for c in p.chunks]
    if max(s.n_chunks for s in plan.sequences) < 3 or not any(
            c.kind.value == "hybrid" for c in chunks) or not any(
            plan.ckpt_table()[0]):
        raise PhaseError(f"the verify plan lacks a 3-chunk split, a packed "
                         f"chunk or remat: {plan.ckpt_table()}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tr = ChunkedTrainer(cfg, DecoderLM(cfg).init(gen, device=dev), device=dev,
                        compute_dtype=torch.float32)
    # the remat'd layers' forwards run again in the backward: the attention
    # forward launches 26 x chunks + the sum of the remat depths
    ctr = _train_counters()
    L, n = cfg.spec.n_layers, len(chunks)
    expected = _expected_launches(cfg, plan, remat_depths(plan, L),
                                  torch.float32)
    _zero_counts(ctr)
    runs = {"plan table": tr.loss_and_grads(plan, corpus)}
    launches = {k: v for k, v in _read_counts(ctr).items() if k in expected}
    if launches != expected:
        raise PhaseError(f"launch counts with remat (got, expected): "
                         f"{launches}, {expected}")
    runs["table zeroed"] = tr.loss_and_grads(plan, corpus,
                                             remat_policy="none")
    runs["unchunked"] = tr.sequence_loss_and_grads(corpus)
    base = runs["plan table"]
    out = {"chunks": [(c.kind.value, c.context, c.tokens) for c in chunks],
           "remat_table": plan.ckpt_table()[0], "launches": launches,
           "loss": base.loss}
    for name, r in runs.items():
        if name == "plan table":
            continue
        worst = 0.0
        for a, b in zip(tree_leaves(r.grads), tree_leaves(base.grads)):
            worst = max(worst, float((a - b).abs().max()) /
                        max(float(b.abs().max()), 1e-30))
        rel_loss = abs(r.loss - base.loss) / abs(base.loss)
        out[name] = {"loss": r.loss, "loss_rel_diff": rel_loss,
                     "grad_max_rel_diff": worst}
        if rel_loss > VERIFY_LIMIT or worst > VERIFY_LIMIT or \
                r.n_valid != base.n_valid:
            raise PhaseError(f"{name} differs from the chunked step: {out}")
    del runs, base, tr
    torch.cuda.empty_cache()
    return out


# train_verify_hymba's gradient limit, relative to each leaf's largest
# value. Fixed between the sound readings on the H100 (3.9e-5 for the
# 3-chunk step, 4.2e-5 for the same corpus packed with no split: float32
# rounding of repacked rows through 32 layers) and the planted carry
# faults', which the phase measures and requires above it. It is not the
# 1e-5 that gemma3-1b's float32 step meets (7.7e-6).
HYMBA_GRAD_LIMIT = 1e-4


@contextlib.contextmanager
def _carry_fault(trainer, fault):
    """The trainer with one carry fault planted (undone on exit):
    ``"pad rows reset the state"`` runs the mixer with pad rows taken as
    live rows (position 0: they reset the state and enter the conv tail,
    as the reference's mixer does); ``"dh dropped at the hand-off"``
    detaches the SSM state each chunk hands on, so its gradient never
    reaches the chunk that produced it."""
    from repro_torch.models import model as model_mod
    patched = []
    if fault == "pad rows reset the state":
        mixer = model_mod.mamba_apply

        def faulty(cfg, p, x, *, seg, **kw):
            return mixer(cfg, p, x, seg=seg.clamp(min=0), **kw)
        patched.append((model_mod, "mamba_apply", mixer))
        model_mod.mamba_apply = faulty
    elif fault == "dh dropped at the hand-off":
        fwd = trainer.model.forward_chunk

        def faulty(*a, **kw):
            hidden, out = fwd(*a, **kw)
            if out is not None and out.ssm_h is not None:
                out = out._replace(ssm_h=[
                    None if h is None else h.detach().requires_grad_(True)
                    for h in out.ssm_h])
            return hidden, out
        trainer.model.forward_chunk = faulty
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        for obj, attr, orig in patched:
            setattr(obj, attr, orig)
        trainer.model.__dict__.pop("forward_chunk", None)


def phase_train_verify_hymba(dev, seed):
    """hymba-1.5b in float32 at full width: one sequence of 3,000 tokens
    split over 3 chunks whose split slices (1,060 and 997 tokens) are not
    multiples of 64 rows, so pad rows sit in front of the KV and
    ``(h, conv_tail)`` carries, and a non-zero remat table.

    * The step with the table zeroed equals it bit for bit (every kernel
      is deterministic).
    * It equals one unchunked forward and backward per sequence: the loss
      within 1e-5 relative; every gradient leaf within
      :data:`HYMBA_GRAD_LIMIT` relative to its largest value. The same
      corpus planned with no split (K = 1: no carry, no pad rows in front
      of one) is held to the same limits, and its reading shows the
      float32 floor of the comparison.
    * Each planted carry fault (:func:`_carry_fault`) moves the loss or a
      gradient leaf beyond those limits."""
    import torch

    from repro_torch.core import (ClusterSpec, CostModel, PlannerConfig,
                                  plan_batch)
    from repro_torch.models import DecoderLM
    from repro_torch.models.model import tree_leaves
    from repro_torch.runtime.train_step import ChunkedTrainer, remat_depths
    cfg, corpus, plan = _verify_plan("hymba-1.5b", seed)
    chunks = [c for p in plan.pipelines for c in p.chunks]
    if max(s.n_chunks for s in plan.sequences) < 3 or not any(
            c.has_dependents and c.tokens % 64 for c in chunks) or not any(
            plan.ckpt_table()[0]):
        raise PhaseError(f"the verify plan lacks a 3-chunk split with pad "
                         f"rows before a carry, or remat: "
                         f"{[(c.context, c.tokens) for c in chunks]} "
                         f"{plan.ckpt_table()}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tr = ChunkedTrainer(cfg, DecoderLM(cfg).init(gen, device=dev), device=dev,
                        compute_dtype=torch.float32)
    ctr = _train_counters()
    L, n = cfg.spec.n_layers, len(chunks)
    expected = _expected_launches(cfg, plan, remat_depths(plan, L),
                                  torch.float32)
    _zero_counts(ctr)
    base = tr.loss_and_grads(plan, corpus)
    base_n_valid = base.n_valid
    launches = {k: v for k, v in _read_counts(ctr).items() if k in expected}
    if launches != expected:
        raise PhaseError(f"launch counts with remat (got, expected): "
                         f"{launches}, {expected}")
    out = {"chunks": [(c.kind.value, c.context, c.tokens) for c in chunks],
           "remat_table": plan.ckpt_table()[0], "launches": launches,
           "loss": base.loss}
    zeroed = tr.loss_and_grads(plan, corpus, remat_policy="none")
    same = zeroed.loss == base.loss and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(zeroed.grads),
                                          tree_leaves(base.grads)))
    out["table zeroed"] = {"loss": zeroed.loss, "bitwise_equal": same}
    del zeroed
    if not same:
        raise PhaseError(f"the remat-zeroed step is not bitwise equal: {out}")
    whole = tr.sequence_loss_and_grads(corpus)
    names = _leaf_names(tr.params)

    def against_whole(run):
        """The loss's relative difference from ``whole``, the largest over
        leaves of max |g - g_whole| / max |g_whole|, that leaf, and
        whether both are within the limits."""
        worst, leaf = 0.0, 0
        for i, (a, b) in enumerate(zip(tree_leaves(run.grads),
                                       tree_leaves(whole.grads))):
            r = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 1e-30)
            if r > worst:
                worst, leaf = r, i
        rel = abs(run.loss - whole.loss) / abs(whole.loss)
        return {"loss": run.loss, "loss_rel_diff": rel,
                "grad_max_rel_diff": worst,
                "grad_max_rel_diff_leaf": names[leaf],
                "within": rel <= 1e-5 and worst <= HYMBA_GRAD_LIMIT}
    packed = plan_batch(CostModel(cfg.spec, ClusterSpec()),
                        [len(v) for v in corpus.values()], PlannerConfig(
                            fixed_k=1, bucket_rounding=64,
                            remat_mode="stage_aware"))
    if any(c.has_dependents or c.context
           for p in packed.pipelines for c in p.chunks):
        raise PhaseError("the K = 1 plan splits a sequence")
    out["unchunked"] = {"loss": whole.loss,
                        "grad_limit": HYMBA_GRAD_LIMIT,
                        "chunked": against_whole(base)}
    del base
    out["unchunked"]["K = 1, no split"] = dict(
        against_whole(tr.loss_and_grads(packed, corpus)),
        plan=[[c.tokens for c in p.chunks] for p in packed.pipelines])
    faults = {}
    for fault in ("pad rows reset the state", "dh dropped at the hand-off"):
        with _carry_fault(tr, fault):
            faults[fault] = against_whole(tr.loss_and_grads(plan, corpus))
    out["planted carry faults"] = faults
    sound = [out["unchunked"]["chunked"],
             out["unchunked"]["K = 1, no split"]]
    if not all(r["within"] for r in sound) or \
            whole.n_valid != base_n_valid:
        raise PhaseError(f"the unchunked step differs from the chunked "
                         f"step: {out}")
    missed = [f for f, r in faults.items() if r["within"]]
    if missed:
        raise PhaseError(f"the limits do not catch {missed}: {out}")
    del whole, tr
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the pipeline executor: train_pipeline, train_pipeline_verify

# (tag, arch, stages, schedule pinned or None for the planner's, steps)
PIPE_RUNS = (("a", "gemma3-1b", 2, None, 2),
             ("b", "gemma3-1b", 4, None, 1),
             ("c", "hymba-1.5b", 2, None, 1),
             ("c", "hymba-1.5b", 2, "gpipe-1f1b", 1))
# hymba-1.5b's layers in train_pipeline's runs: 16 of 32, to keep the
# script in its time
PIPE_LAYERS = {"hymba-1.5b": 16}


@contextlib.contextmanager
def _per_stage(ctr, tally):
    """Attributes every launch counted in ``ctr`` to the stage whose
    action made it: ``tally[p][name]``."""
    from repro_torch.runtime.executor import PipelineExecutor
    run = PipelineExecutor._run

    def counted(self, p, a):
        before = _read_counts(ctr)
        run(self, p, a)
        t = tally.setdefault(p, dict.fromkeys(before, 0))
        for k, n in _read_counts(ctr).items():
            t[k] += n - before[k]
    PipelineExecutor._run = counted
    try:
        yield
    finally:
        PipelineExecutor._run = run


def _expected_stage_launches(cfg, plan, d_p, dtype, n_sm, cm,
                             policy="stage-aware"):
    """Each stage's launches in one pipelined step of ``plan`` (its
    schedule and ``v``; the cost model ``cm`` the trainer orders
    interleaved stages by): per virtual stage and chunk one attention
    forward with its tile ranges per layer and per remat'd layer (the
    plan's depth, or all of the block's layers where the order remats a
    forward past the stage's budget: ``program.stage_programs``), a merge
    pass
    where the bf16 forward splits the chunk's keys
    (``flash_attention.kv_splits``), one of each backward pass per layer;
    the same for the selective scan's passes on mamba layers; B, C1, C2
    once per chunk on the last stage; the split's W runs cuBLAS products
    only (no kernel of the port); no plain call."""
    import torch

    from repro_torch.kernels.flash_attention import BLOCK_KV, kv_splits
    from repro_torch.models.config import LayerKind
    from repro_torch.runtime.sharding import stage_blocks
    from repro_torch.runtime.train_step import _rows, stage_remat
    from repro_torch.core.schedule import get_schedule
    from repro_torch.runtime.program import stage_programs
    from repro_torch.runtime.train_step import _table
    v = plan.v_stages
    blocks = stage_blocks(d_p, cfg.spec.n_layers, v)
    depths = stage_remat(plan, cfg.spec.n_layers, d_p, v, policy)
    table, base = _table(plan, d_p, policy), 0
    for pipe in plan.pipelines:
        n = pipe.n_chunks
        programs = stage_programs(
            pipe, d_p, v=v, cm=cm, depths=[r[base:base + n] for r in table],
            split=get_schedule(plan.schedule, v).split_bwd)
        for p, prog in enumerate(programs):
            for a in prog:
                if a.remat:
                    depths[p][a.vstage][base + a.chunk] = \
                        len(blocks[p][a.vstage])
        base += n
    split = []              # per chunk: does its bf16 forward split?
    for c in (c for pipe in plan.pipelines for c in pipe.chunks):
        T = _rows(c.tokens)     # keys: the carry's live rows, then T
        S = -(-(c.context + T) // BLOCK_KV) * BLOCK_KV
        split.append(dtype == torch.bfloat16 and kv_splits(
            T, S, cfg.spec.n_heads, n_sm) > 1)
    n = plan.n_chunks
    out = []
    for p in range(d_p):
        one = {}
        for kind in ("fwd", "bwd", "combine"):
            one[kind] = sum(
                len(blocks[p][j]) + (depths[p][j][k] if kind != "bwd"
                                     else 0)
                for j in range(v) for k in range(n)
                if kind != "combine" or split[k])
        exp = _expected_launches(cfg, plan, [0] * n, dtype)
        attn = cfg.layer_kind != LayerKind.MAMBA
        ssm = cfg.spec.ssm_state > 0
        for k in exp:
            if k.startswith("plain"):
                continue
            if k.startswith("ce_"):
                exp[k] = exp[k] if p == d_p - 1 else 0
            elif k.startswith("mamba_scan"):
                bwd = k.startswith("mamba_scan_bwd") or \
                    k == "mamba_scan_reduce_kernel"
                exp[k] = (one["bwd"] if bwd else one["fwd"]) if ssm else 0
            elif k in ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"):
                exp[k] = one["bwd"] if attn else 0
            elif k == "flash_combine_kernel":
                exp[k] = one["combine"] if attn else 0
            elif exp[k]:                    # the forward and its ranges
                exp[k] = one["fwd"] if attn else 0
        out.append(exp)
    return out


def _check_stage_launches(tally, expected, what):
    for p, exp in enumerate(expected):
        got = tally.get(p, {})
        bad = {k: (got.get(k, 0), n) for k, n in exp.items()
               if got.get(k, 0) != n}
        if bad:
            raise PhaseError(f"{what}: stage {p} launch counts differ from "
                             f"the plan's (got, expected): {bad}")


def trainer_cm(d_p, cfg, d_s=1, n_pods=1):
    """The cost model ``launch/train.train`` plans ``d_p`` stages of
    ``d_s`` sequence-parallel ranks (of each of ``n_pods`` pods) on this
    card with (the card's memory over the pods, stages and ranks)."""
    from repro_torch.core import ClusterSpec, CostModel
    cl = ClusterSpec()
    return CostModel(cfg.spec, cl.with_(
        d_p=d_p, d_s=d_s, hbm_bytes=cl.hbm_bytes / (d_p * d_s * n_pods)))


def phase_train_pipeline(dev, seed):
    """The pipelined step at full width in bf16, every stage on this card:
    :data:`PIPE_RUNS` through ``launch/train.train`` (``--mesh Px1``)."""
    import math

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    recs, totals = [], {}
    for tag, arch, d_p, sched, steps in PIPE_RUNS:
        cfg = get_arch(arch)
        if arch in PIPE_LAYERS:
            cfg = cfg.with_layers(PIPE_LAYERS[arch])
        loop = _train_loop(seed)
        loop.steps, loop.d_p, loop.schedule = steps, d_p, sched
        ctr = _train_counters()
        tally, expected, lines = {}, [], []

        def on_step(step, plan, corpus, trainer):
            if expected:
                _check_stage_launches(tally, expected[-1],
                                      f"({tag}) step {step - 1}")
            expected.append(_expected_stage_launches(
                cfg, plan, d_p, torch.bfloat16, n_sm, trainer_cm(d_p, cfg)))
            for t in tally.values():
                for k, n in t.items():
                    totals[k] = totals.get(k, 0) + n
            tally.clear()
            _zero_counts(ctr)
        with _per_stage(ctr, tally):
            trainer, hist = train(cfg, loop, device=dev, on_step=on_step,
                                  log=lines.append)
        _check_stage_launches(tally, expected[-1], f"({tag}) last step")
        for t in tally.values():
            for k, n in t.items():
                totals[k] = totals.get(k, 0) + n
        for ln in lines:
            print(f"[train_pipeline] ({tag}) {arch} {ln}", flush=True)
        for h, exp in zip(hist, expected):
            rec = dict(h, run=tag, arch=arch, mesh=f"{d_p}x1",
                       stage_launches=exp)
            recs.append(rec)
            if not math.isfinite(h["loss"]):
                raise PhaseError(f"non-finite loss: {rec}")
            if h["card_peak_mem_gb"][0] > h["card_plan_mem_gb"][0]:
                raise PhaseError(
                    f"the card's peak {h['card_peak_mem_gb'][0]} GB is above "
                    f"the sum of its stages' estimates "
                    f"{h['card_plan_mem_gb'][0]} GB: {rec}")
        del trainer
        torch.cuda.empty_cache()
    return recs, totals


def _pipeline_fault(fault):
    """A planted pipeline fault (undone on exit): ``"stream gradient
    dropped"`` zeroes the first gradient stage 1 hands to stage 0;
    ``"tied gradient dropped"`` drops the last stage's tied-embedding
    gradient before the sum; ``"wrong virtual stage"`` runs the stream
    meant for stage 0's virtual stage 1 through its virtual stage 0
    (chunk 0 only)."""
    import torch

    from repro_torch.runtime.executor import PipelineExecutor
    from repro_torch.runtime.pipeline import PipelineStage
    from repro_torch.runtime.train_step import PipelineTrainer
    if fault == "stream gradient dropped":
        obj, name = PipelineExecutor, "_send_grad"
        orig, sent = obj._send_grad, []

        def faulty(self, s, k, g):
            if s % self.d_p == 1 and not sent:
                sent.append(k)
                g = torch.zeros_like(g)
            orig(self, s, k, g)
    elif fault == "tied gradient dropped":
        obj, name = PipelineTrainer, "_sum_tied"
        orig = obj._sum_tied

        def faulty(self, accs):
            accs[-1][self.tied[1]].zero_()
            orig(self, accs)
    elif fault == "wrong virtual stage":
        obj, name = PipelineStage, "forward"
        orig = obj.forward

        def faulty(self, k, j, x):
            if self.p == 0 and j == 1 and k == 0:
                blocks = self.blocks
                self.blocks = [blocks[0], blocks[0]] + blocks[2:]
                try:
                    return orig(self, k, j, x)
                finally:
                    self.blocks = blocks
            return orig(self, k, j, x)
    else:
        raise ValueError(fault)

    @contextlib.contextmanager
    def planted():
        setattr(obj, name, faulty)
        try:
            yield
        finally:
            setattr(obj, name, orig)
    return planted()


def _pipeline_verify_plans(cfg, seed):
    """train_pipeline_verify's corpus (the verify phases' four sequences)
    and its ``2x1`` plans, ``(corpus, cm, {schedule: plan})``: the planner's
    own pick and each backend pinned, K = 3, a 2 GB activation budget per
    stage, so that the ILP remats layers on both stages."""
    import numpy as np

    from repro_torch.core import (ClusterSpec, CostModel, PlannerConfig,
                                  plan_batch)
    rng = np.random.default_rng(seed)
    lens = [3000, 900, 500, 300]
    corpus = {i: rng.integers(0, cfg.spec.vocab, n).astype(np.int32)
              for i, n in enumerate(lens)}
    cm = CostModel(cfg.spec, ClusterSpec(d_p=2, hbm_bytes=40e9))
    budget = max(cm.m_model_states(p) for p in (1, 2)) + 2e9
    plans = {s: plan_batch(cm, lens, PlannerConfig(
        fixed_k=3, bucket_rounding=64, remat_mode="stage_aware",
        capacity_bytes=budget, schedule=s))
        for s in ("gpipe-1f1b", "interleaved-1f1b", "zero-bubble-h1")}
    return corpus, cm, plans


def phase_train_pipeline_verify(dev, seed):
    """hymba-1.5b in float32 at full width on ``2x1``: one sequence of
    3,000 tokens over 3 chunks with pad rows in front of the KV and SSM
    carries, a non-zero remat table on both stages. Each schedule
    (gpipe-1f1b; interleaved-1f1b at the planner's v; zero-bubble-h1 with
    the split backward) against one unchunked forward and backward per
    sequence at train_verify_hymba's limits (loss 1e-5 relative, each
    gradient leaf within 1e-4 of its largest value); the split backward
    equals the fused one and the remat table a zeroed one bit for bit;
    three planted faults must fall outside the limits."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import DecoderLM
    from repro_torch.models.model import tree_leaves
    from repro_torch.runtime.pipeline import PipelineGeometry
    from repro_torch.runtime.train_step import ChunkedTrainer, PipelineTrainer
    cfg = get_arch("hymba-1.5b")
    corpus, cm, plans = _pipeline_verify_plans(cfg, seed)
    base = plans["zero-bubble-h1"]
    chunks = [c for p in base.pipelines for c in p.chunks]
    if max(s.n_chunks for s in base.sequences) < 3 or not any(
            c.has_dependents and c.tokens % 64 for c in chunks) or not all(
            any(row) for row in base.ckpt_table()):
        raise PhaseError(f"the verify plan lacks a 3-chunk split with pad "
                         f"rows before a carry, or remat on both stages: "
                         f"{[(c.context, c.tokens) for c in chunks]} "
                         f"{base.ckpt_table()}")
    if any([(c.context, c.tokens) for q in p.pipelines for c in q.chunks]
           != [(c.context, c.tokens) for c in chunks] or p.ckpt_table() !=
           base.ckpt_table() for p in plans.values()):
        raise PhaseError("the pinned schedules change the verify plan")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = DecoderLM(cfg).init(gen, device=dev)
    tr = ChunkedTrainer(cfg, params, device=dev, compute_dtype=torch.float32)
    whole = tr.sequence_loss_and_grads(corpus)
    names = _leaf_names(tr.params)
    del tr
    torch.cuda.empty_cache()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ctr = _train_counters()

    def against_whole(run):
        worst, leaf = 0.0, 0
        for i, (a, b) in enumerate(zip(tree_leaves(run.grads),
                                       tree_leaves(whole.grads))):
            r = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 1e-30)
            if r > worst:
                worst, leaf = r, i
        rel = abs(run.loss - whole.loss) / abs(whole.loss)
        return {"loss": run.loss, "loss_rel_diff": rel,
                "grad_max_rel_diff": worst,
                "grad_max_rel_diff_leaf": names[leaf],
                "within": rel <= 1e-5 and worst <= HYMBA_GRAD_LIMIT
                and run.n_valid == whole.n_valid}

    def run(sched, split, policy="stage-aware", fault=None, count=False):
        plan = plans[sched]
        tr = PipelineTrainer(cfg, params, geometry=PipelineGeometry(
            d_p=2, schedule=sched, v_stages=plan.v_stages, split_bwd=split),
            cards=[dev], compute_dtype=torch.float32, cost_model=cm)
        tally = {}
        _zero_counts(ctr)
        with contextlib.ExitStack() as stack:
            stack.enter_context(_per_stage(ctr, tally))
            if fault:
                stack.enter_context(_pipeline_fault(fault))
            res = tr.loss_and_grads(plan, corpus, remat_policy=policy)
        if count:
            _check_stage_launches(tally, _expected_stage_launches(
                cfg, plan, 2, torch.float32, n_sm, cm, policy),
                f"{sched} split={split}")
        del tr
        return res, tally

    out = {"chunks": [(c.kind.value, c.context, c.tokens) for c in chunks],
           "remat_table": base.ckpt_table(), "loss": whole.loss,
           "grad_limit": HYMBA_GRAD_LIMIT,
           "v": plans["interleaved-1f1b"].v_stages}
    results, launches = {}, {}
    for sched, split in (("gpipe-1f1b", False), ("interleaved-1f1b", False),
                         ("zero-bubble-h1", True)):
        res, tally = run(sched, split, count=True)
        results[sched] = res
        for t in tally.values():
            for k, n in t.items():
                launches[k] = launches.get(k, 0) + n
        out[sched] = dict(against_whole(res), **res.pipeline)
    out["launches"] = launches
    split = results["zero-bubble-h1"]
    fused, _ = run("zero-bubble-h1", False)
    zeroed, _ = run("zero-bubble-h1", True, policy="none")

    def bitwise(a, b):
        return a.loss == b.loss and all(
            torch.equal(x, y) for x, y in zip(tree_leaves(a.grads),
                                              tree_leaves(b.grads)))
    out["split equals fused"] = bitwise(split, fused)
    out["remat table equals zeroed"] = bitwise(split, zeroed)
    del fused, zeroed
    faults = {}
    for fault, sched in (("stream gradient dropped", "zero-bubble-h1"),
                         ("tied gradient dropped", "zero-bubble-h1"),
                         ("wrong virtual stage", "interleaved-1f1b")):
        res, _ = run(sched, sched == "zero-bubble-h1", fault=fault)
        faults[fault] = against_whole(res)
    out["planted faults"] = faults
    bad = [s for s in results if not out[s]["within"]]
    if bad or not out["split equals fused"] or \
            not out["remat table equals zeroed"]:
        raise PhaseError(f"the pipelined step differs ({bad}): {out}")
    missed = [f for f, r in faults.items() if r["within"]]
    if missed:
        raise PhaseError(f"the limits do not catch {missed}: {out}")
    del results, split, whole, params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the MoE family (olmoe-1b-7b): kernel cases at its shapes, serve_moe,
# verify_moe, train_moe, train_verify_moe

MOE = "olmoe-1b-7b"
# the plain attention's query rows per block at olmoe's 16 heads: its
# [16, rows, S] float32 scores on a 47k-row train chunk take 3 GB a tensor
MOE_ROW_BLOCK = 1024
def phase_kernel_moe(dev, seed):
    """Kernels A, A′, B, C1 and C2 at olmoe-1b-7b's shapes (16 query and
    16 KV heads of 128; head D 2,048, V 50,304): the attention backward
    and forward on train_moe's largest chunk of step 0 (bf16, its own
    segments and positions) and on train_verify_moe's largest chunk
    (float32, its carry in front); B, C1, C2 on those two chunks' targets
    and at CE_T random targets (bf16)."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    s = _arch(MOE).spec
    chunk, tgt, seg, pos = _train_chunks(seed, MOE)[0]
    name = f"{MOE} train chunk ({chunk.tokens} tokens)"
    # the dropped tile: 32 rows inside segment 0, past its first 32
    a0 = int((seg >= 0).argmax())
    n0 = int((seg == seg[a0]).sum())
    r = a0 + min(1024, n0 // 2 // 32 * 32)
    if n0 < 128:
        raise PhaseError(f"{name}: segment 0 has {n0} rows")

    def from_plan(gen, dtype):
        return _plan_chunk(gen, seg, pos, s.n_heads, s.n_kv_heads,
                           s.head_dim, dtype, dev)
    bwd = []
    for args in ((f"{name} global", from_plan, slice(r, r + 32), 0, bf16),
                 (*_verify_attn_case(MOE, "train_verify_moe", seed, dev),
                  0, f32)):
        bwd.append(_attn_bwd_case(*args, dev, 31 + len(bwd),
                                  row_block=MOE_ROW_BLOCK))
        print(f"[kernel] attention backward {json.dumps(bwd[-1])}",
              flush=True)
        torch.cuda.empty_cache()
    v_chunk, v_tgt = _plan_chunks(*_verify_plan(MOE, seed)[1:])[0][:2]
    ce = []
    for dtype, seed_, targets, case in (
            (bf16, 33, torch.from_numpy(tgt), name), (bf16, 34, None, None),
            (f32, 35, torch.from_numpy(v_tgt),
             f"train_verify_moe chunk ({v_chunk.tokens} tokens)")):
        ce.append(_ce_case(MOE, dtype, dev, seed_, targets=targets,
                           case=case))
        for rec in ce[-1].values():
            print(f"[kernel] cross-entropy {json.dumps(rec)}", flush=True)
        torch.cuda.empty_cache()
    return bwd, ce


@contextlib.contextmanager
def _moe_watch(picks=None):
    """The routed path over one phase. Yields a dict that holds, after the
    block: the expert products issued and the host syncs that read the
    group sizes (``moe.COUNTS``), the non-empty experts of each layer (the
    fewest and the most over its calls, in layer order), and the smallest
    top-k margin over every routed row (the k-th logit less the (k+1)-th).
    ``picks(router, ids)``, if given, sees every call's picks."""
    import torch

    from repro_torch.models import moe
    layers, low = {}, []

    def observe(router, logits, ids, sizes):
        k = ids.shape[1]
        top = torch.topk(logits, k + 1, dim=-1).values
        m = (top[:, k - 1] - top[:, k]).min()
        low[:] = [m if not low else torch.minimum(low[0], m)]
        n = sum(1 for x in sizes if x)
        lo, hi = layers.get(router.data_ptr(), (n, n))
        layers[router.data_ptr()] = (min(lo, n), max(hi, n))
        if picks is not None:
            picks(router, ids)
    before, out = dict(moe.COUNTS), {}
    with moe.observe_router(observe):
        yield out
    out.update({k: moe.COUNTS[k] - before[k] for k in before})
    out["nonempty_experts_per_layer"] = list(layers.values())
    out["min_topk_margin"] = float(low[0]) if low else None


@contextlib.contextmanager
def _recorded_picks(corpus, layer_of, out):
    """Every live row's expert picks while the block runs: ``out`` gets
    ``(layer, sequence ids, positions, picks sorted)`` per routed call
    (``layer_of``: router data pointer -> layer). A chunk's rows are
    matched to their sequences by their tokens at their positions;
    ``DecoderLM._layer`` (which a remat'd layer's recompute calls again)
    names the rows each call routes. Yields :func:`_moe_watch`'s dict."""
    import numpy as np

    from repro_torch.models import DecoderLM
    rows, cur = {}, [None]
    fwd, lay = DecoderLM.forward_chunk, DecoderLM._layer

    def forward_chunk(self, params, tokens, seg, pos, **kw):
        tok, sg, ps = (t.cpu().numpy() for t in (tokens, seg, pos))
        sid = np.full(len(sg), -1, np.int64)
        for g in np.unique(sg[sg >= 0]):
            r = sg == g
            hit = [i for i, t in corpus.items() if ps[r].max() < len(t)
                   and np.array_equal(t[ps[r]], tok[r])]
            if len(hit) != 1:
                raise PhaseError(f"segment {g}'s rows match sequences {hit}")
            sid[r] = hit[0]
        rows[id(seg)] = (seg, sid, ps)      # seg kept: its id stays unique
        return fwd(self, params, tokens, seg, pos, **kw)

    def layer(self, lparams, x, pos, seg, *rest):
        cur[0] = rows[id(seg)]
        return lay(self, lparams, x, pos, seg, *rest)

    def picks(router, ids):
        _, sid, ps = cur[0]
        live = sid >= 0
        out.append((layer_of[router.data_ptr()], sid[live], ps[live],
                    np.sort(ids.cpu().numpy(), axis=1)[live]))
    DecoderLM.forward_chunk, DecoderLM._layer = forward_chunk, layer
    try:
        with _moe_watch(picks) as watch:
            yield watch
    finally:
        DecoderLM.forward_chunk, DecoderLM._layer = fwd, lay


def _pick_table(records):
    """(keys, picks) of one run's records, one entry per (layer, sequence,
    position), keys sorted."""
    import numpy as np
    keys = np.concatenate([(la * 2 ** 20 + s) * 2 ** 24 + p
                           for la, s, p, _ in records])
    picks = np.concatenate([k for *_, k in records])
    keys, first = np.unique(keys, return_index=True)
    return keys, picks[first]


def _flips(a, b):
    """(token, layer) picks that differ between two runs' tables, and the
    pairs both hold."""
    import numpy as np
    _, ia, ib = np.intersect1d(a[0], b[0], assume_unique=True,
                               return_indices=True)
    return int((a[1][ia] != b[1][ib]).any(1).sum()), len(ia)


@contextlib.contextmanager
def _router_fault():
    """The router takes its (k+1)-th pick in place of its k-th (undone on
    exit)."""
    import torch

    from repro_torch.models import moe
    good = moe.route

    def shifted(logits, k):
        top, ids = torch.topk(logits, k + 1, dim=-1)
        keep = [*range(k - 1), k]
        return torch.softmax(top[:, keep], dim=-1), ids[:, keep]
    moe.route = shifted
    try:
        yield
    finally:
        moe.route = good


@contextlib.contextmanager
def _latent_carry_fault(trainer):
    """The trainer with the first latent carry it hands on detached (undone
    on exit): that carry's gradient never reaches the chunk that wrote
    it (``_carry_fault``'s pattern, for MLA's latent rows, one chunk)."""
    fwd, done = trainer.model.forward_chunk, []

    def faulty(*a, **kw):
        hidden, out = fwd(*a, **kw)
        if out is not None and out.k is not None and not done:
            done.append(True)
            out = out._replace(k=[t.detach().requires_grad_(True)
                                  for t in out.k])
        return hidden, out
    trainer.model.forward_chunk = faulty
    try:
        yield
    finally:
        trainer.model.__dict__.pop("forward_chunk", None)
    if not done:
        raise PhaseError("no chunk handed on a latent carry")


@contextlib.contextmanager
def _mla_scale_fault(trainer):
    """MLA's scores scaled by ``1/sqrt(Dh)``, the value width's, in place
    of ``1/sqrt(Dh + rr)`` (undone on exit)."""
    import math
    policy = trainer.model.attn_fn
    wrong = 1.0 / math.sqrt(trainer.model.cfg.spec.head_dim)

    def faulty(*a, scale, **kw):
        return policy(*a, scale=wrong, **kw)
    trainer.model.attn_fn = faulty
    try:
        yield
    finally:
        trainer.model.attn_fn = policy


# the planted faults of each routed arch's float32 verify phase: each must
# take the chunked step outside VERIFY_LIMIT
ROUTED_FAULTS = {
    "olmoe-1b-7b": {"planted router fault": lambda tr: _router_fault()},
    "deepseek-v2-lite": {
        "planted latent carry fault": _latent_carry_fault,
        "planted scale fault": _mla_scale_fault},
}


def phase_train_verify_moe(dev, seed, arch=MOE):
    """``arch`` (olmoe-1b-7b; deepseek-v2-lite as train_verify_mla) in
    float32 at full width, 4 layers, on the verify sequences (K = 3,
    VERIFY_BUDGET: a split over 3 chunks, a packed chunk, a non-zero remat
    table): the chunked step launches the kernels as its plan predicts;
    the same step with the table zeroed and one unchunked forward and
    backward per sequence agree with it within VERIFY_LIMIT (loss and each
    gradient leaf, relative); each planted fault of ROUTED_FAULTS (olmoe:
    the router's (k+1)-th pick in place of its k-th; deepseek: the latent
    carry's gradient dropped for one chunk, the scores scaled by
    ``1/sqrt(Dh)``) must fall outside it. Each run's smallest top-k margin
    and the (token, layer) picks that differ from the chunked step's are
    reported."""
    import torch

    from repro_torch.models import DecoderLM
    from repro_torch.models.model import tree_leaves
    from repro_torch.runtime.train_step import ChunkedTrainer, remat_depths
    cfg, corpus, plan = _verify_plan(arch, seed)
    chunks = [c for p in plan.pipelines for c in p.chunks]
    if max(s.n_chunks for s in plan.sequences) < 3 or not any(
            c.kind.value == "hybrid" for c in chunks) or not any(
            plan.ckpt_table()[0]):
        raise PhaseError(f"the verify plan lacks a 3-chunk split, a packed "
                         f"chunk or remat: {plan.ckpt_table()}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tr = ChunkedTrainer(cfg, DecoderLM(cfg).init(gen, device=dev), device=dev,
                        compute_dtype=torch.float32)
    L = cfg.spec.n_layers
    layer_of = {lp["moe"]["router"].data_ptr(): i
                for i, lp in enumerate(tr.params["layers"])}
    ctr = _train_counters()
    expected = _expected_launches(cfg, plan, remat_depths(plan, L),
                                  torch.float32)
    names = _leaf_names(tr.params)
    base = None

    def against_base(r):
        worst, leaf = 0.0, 0
        for i, (a, b) in enumerate(zip(tree_leaves(r.grads),
                                       tree_leaves(base.grads))):
            x = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 1e-30)
            if x > worst:
                worst, leaf = x, i
        rel = abs(r.loss - base.loss) / abs(base.loss)
        return {"loss": r.loss, "loss_rel_diff": rel,
                "grad_max_rel_diff": worst,
                "grad_max_rel_diff_leaf": names[leaf],
                "within": rel <= VERIFY_LIMIT and worst <= VERIFY_LIMIT
                and r.n_valid == base.n_valid}
    # each run is held to the chunked step as it ends and its gradients
    # dropped: three runs' float32 gradients (11 GB each at deepseek's 4
    # layers) do not fit beside the parameters and a fourth run
    _zero_counts(ctr)
    tables, watch, held, launches = {}, {}, {}, None
    for name, fn in (("plan table", lambda: tr.loss_and_grads(plan, corpus)),
                     ("table zeroed", lambda: tr.loss_and_grads(
                         plan, corpus, remat_policy="none")),
                     ("unchunked", lambda: tr.sequence_loss_and_grads(
                         corpus))):
        records = []
        with _recorded_picks(corpus, layer_of, records) as w:
            r = fn()
        if launches is None:
            launches = {k: v for k, v in _read_counts(ctr).items()
                        if k in expected}
        tables[name], watch[name] = _pick_table(records), w
        if base is None:
            base = r
        else:
            held[name] = against_base(r)
        del r
    n_tokens = sum(len(t) for t in corpus.values())
    out = {"chunks": [(c.kind.value, c.context, c.tokens) for c in chunks],
           "remat_table": plan.ckpt_table()[0], "launches": launches,
           "loss": base.loss, "limit": VERIFY_LIMIT,
           "moe": watch["plan table"]}
    for name in ("table zeroed", "unchunked"):
        flips, pairs = _flips(tables["plan table"], tables[name])
        out[name] = dict(held[name], flipped_picks=flips,
                         token_layers=pairs,
                         min_topk_margin=watch[name]["min_topk_margin"])
        if pairs != n_tokens * L:
            raise PhaseError(f"{name}: picks recorded for {pairs} (token, "
                             f"layer) pairs of {n_tokens * L}: {out}")
    faults = ROUTED_FAULTS[arch]
    for name, fault in faults.items():
        with fault(tr):
            out[name] = against_base(tr.loss_and_grads(plan, corpus))
    if launches != expected:
        raise PhaseError(f"launch counts with remat (got, expected): "
                         f"{launches}, {expected}")
    bad = [n for n in ("table zeroed", "unchunked") if not out[n]["within"]]
    if bad:
        raise PhaseError(f"{bad} differ from the chunked step: {out}")
    missed = [n for n in faults if out[n]["within"]]
    if missed:
        raise PhaseError(f"the limit does not catch {missed}: {out}")
    del base, tr
    torch.cuda.empty_cache()
    return out


def _leaf_names(tree, prefix=""):
    """Dotted names of a parameter tree's leaves in ``tree_leaves``
    order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}.{k}")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}[{i}]")]
    return [prefix]


# ---------------------------------------------------------------------------
# MLA: deepseek-v2-lite
# ---------------------------------------------------------------------------

MLA = "deepseek-v2-lite"


def phase_kernel_mla(dev, seed):
    """Kernels A and A′ at MLA's widths (16 query heads, each its own KV
    head after the latent expansion; keys 192 wide, values 128:
    ``flash_*_kernel<192, 128>``, nothing padded): the attention backward
    and forward on train_mla's largest chunk of step 0 (bf16, its own
    segments and positions) and on train_verify_mla's largest chunk
    (float32, its carry in front); B, C1, C2 at deepseek's head (D 2,048,
    V 102,400) on those two chunks' targets."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    Hq, Hkv, Dk, Dv = _attn_widths(_arch(MLA).spec)
    chunk, tgt, seg, pos = _train_chunks(seed, MLA)[0]
    name = f"{MLA} train chunk ({chunk.tokens} tokens)"
    # the dropped tile: 32 rows inside segment 0, past its first 32
    a0 = int((seg >= 0).argmax())
    n0 = int((seg == seg[a0]).sum())
    r = a0 + min(1024, n0 // 2 // 32 * 32)
    if n0 < 128:
        raise PhaseError(f"{name}: segment 0 has {n0} rows")

    def from_plan(gen, dtype):
        return _plan_chunk(gen, seg, pos, Hq, Hkv, Dk, dtype, dev, Dv=Dv)
    bwd = []
    for args in ((f"{name} global", from_plan, slice(r, r + 32), 0, bf16),
                 (*_verify_attn_case(MLA, "train_verify_mla", seed, dev),
                  0, f32)):
        bwd.append(_attn_bwd_case(*args, dev, 41 + len(bwd),
                                  row_block=MOE_ROW_BLOCK))
        print(f"[kernel] attention backward {json.dumps(bwd[-1])}",
              flush=True)
        torch.cuda.empty_cache()
    # generate_mla's longest forward: one sequence of the cut prompt and
    # the new ids but the last, no gradient; its 9 query tiles x 16 heads
    # do not fill the card, so the keys split and the merge pass runs
    n = GEN_PROMPT + GEN_NEW - 1
    fwd = _kernel_case(f"{MLA} one-shot forward ({n} rows)", [(0, n)], Hq,
                       Hkv, Dk, 0, bf16, dev, 45, n_items=1, cap_t=n, Dv=Dv)
    print(f"[kernel] {json.dumps(fwd)}", flush=True)
    v_chunk, v_tgt = _plan_chunks(*_verify_plan(MLA, seed)[1:])[0][:2]
    ce = []
    for dtype, seed_, targets, case in (
            (bf16, 43, torch.from_numpy(tgt), name),
            (f32, 44, torch.from_numpy(v_tgt),
             f"train_verify_mla chunk ({v_chunk.tokens} tokens)")):
        ce.append(_ce_case(MLA, dtype, dev, seed_, targets=targets,
                           case=case))
        for rec in ce[-1].values():
            print(f"[kernel] cross-entropy {json.dumps(rec)}", flush=True)
        torch.cuda.empty_cache()
    return bwd, fwd, ce


# generate_mla: the first requests of serve's trace (deepseek's
# vocabulary), their prompts cut to GEN_PROMPT tokens, GEN_NEW tokens each
GEN_REQUESTS, GEN_PROMPT, GEN_NEW = 2, 512, 4


def phase_generate(dev, seed, arch=MLA):
    """``arch`` at full width and depth (deepseek-v2-lite: 27 layers of MLA
    and a 64-expert top-6 MoE block with 2 shared experts; stablelm-12b:
    40 dense layers with heads of 160; qwen2-vl-7b: 28 with M-RoPE at text
    positions), bf16, random weights from ``seed`` made layer by layer in
    bf16 (31.6, ~24 and ~15 GB; a float32 copy beside them would not
    fit): ``one_shot_generate`` on GEN_REQUESTS requests, GEN_NEW tokens
    each. Every id lies in the vocabulary; each forward launches A's
    forward and its tile ranges once a layer (the merge pass once a layer
    where the keys split), no backward, no plain call."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import sample_request_trace
    from repro_torch.kernels.flash_attention import BLOCK_KV, BLOCK_Q, \
        kv_splits
    from repro_torch.models import DecoderLM
    from repro_torch.serve.engine import one_shot_generate
    cfg = get_arch(arch)
    s = cfg.spec
    trace = sample_request_trace("github", 16, 4096, s.vocab, seed=0,
                                 max_new_tokens=32)
    prompts = [list(t["prompt"][:GEN_PROMPT]) for t in trace[:GEN_REQUESTS]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = DecoderLM(cfg).init(gen, device=dev, dtype=torch.bfloat16)
    weights_gb = torch.cuda.memory_allocated(dev) / 1e9
    ctr = _train_counters()
    _zero_counts(ctr)
    t0 = time.perf_counter()
    ids = one_shot_generate(cfg, params, prompts, GEN_NEW,
                            compute_dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts(ctr)
    # one forward per new token over the prompt and the ids so far; its
    # keys split (the merge pass) where its query tiles x heads do not
    # fill the card
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = [len(p) + i for p in prompts for i in range(GEN_NEW)]
    merges = sum(kv_splits(-(-n // BLOCK_Q) * BLOCK_Q,
                           -(-n // BLOCK_KV) * BLOCK_KV, s.n_heads, n_sm) > 1
                 for n in rows)
    L = s.n_layers
    expected = {k: 0 for k in counts}
    expected.update({"flash_fwd_mma_kernel": L * len(rows),
                     "flash_bwd_tiles_kernel": L * len(rows),
                     "flash_combine_kernel": L * merges})
    rec = dict(layers=L, requests=len(prompts),
               prompt_tokens=[len(p) for p in prompts], new_tokens=GEN_NEW,
               forwards=len(rows), ids=ids, wall_s=wall,
               weights_gb=weights_gb,
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               launches={k: v for k, v in counts.items() if v})
    decode_counts = None
    if arch == MLA:
        # the pipelined prefill and decode on the same weights and prompts,
        # held to these one-shot ids under the near-tie rule (the margins
        # of the bf16 one-shot forward)
        from repro_torch.serve.engine import verify_against_one_shot
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        dec_ids, drec = _decode_run(dev, cfg, params, prompts, GEN_NEW,
                                    (1, 1), torch.bfloat16, ctr, n_sm)
        ok, lines = verify_against_one_shot(
            cfg, params, prompts, dec_ids, GEN_NEW,
            compute_dtype=torch.bfloat16, device=dev, reference=ids)
        drec.update(ids=dec_ids, ok=ok, lines=lines)
        rec["decode"] = drec
        decode_counts = {k: drec["launches_prefill"].get(k, 0)
                         + drec["launches_decode"].get(k, 0) for k in ctr}
        if not ok:
            raise PhaseError(f"the pipelined decode differs from the "
                             f"one-shot ids: {rec}")
    del params
    torch.cuda.empty_cache()
    if any(len(x) != GEN_NEW or not all(0 <= t < s.vocab for t in x)
           for x in ids):
        raise PhaseError(f"ids missing or outside the vocabulary: {rec}")
    bad = {k: (counts[k], v) for k, v in expected.items() if counts[k] != v}
    if bad:
        raise PhaseError(f"launch counts (got, expected): {bad}; {rec}")
    return rec, counts, decode_counts


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the remaining decoder families: qwen3-4b (qk-norm), stablelm-12b (heads of
# 160), qwen2-vl-7b (M-RoPE, the vision stub)
# ---------------------------------------------------------------------------

QWEN3, STABLELM, VL = "qwen3-4b", "stablelm-12b", "qwen2-vl-7b"
# the plain attention's query rows per block at stablelm's 32 heads: its
# [32, rows, S] float32 scores on a 47k-row train chunk take 3 GB a tensor
DENSE_ROW_BLOCK = 512


def _figure_chunks():
    """The reduced widths' attention shapes (4 query heads, 2 KV heads):
    fig11's longest measured sequence (1,024 tokens, one segment; llama3.2-3b
    reduced to heads of 32) and the largest chunk of fig13's step-0 plan
    (llama3.2-3b reduced to heads of 16: github batches of 6 x 512 at
    vocabulary 256, K = 2 on a 2 x 2 cluster; its own segments and
    positions, no carry, as fig13 runs its chunks). ``[(name, seg, pos, Dh,
    drop)]``, ``drop`` 32 rows of a live tile inside segment 0."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core import (ClusterSpec, CostModel, PlannerConfig,
                                  plan_batch)
    from repro_torch.data import sample_corpus_batch
    n = 1024
    out = [("fig11 sequence (1024 tokens)", np.zeros(n, np.int32),
            np.arange(n, dtype=np.int32), 32, slice(512, 544))]
    cfg = get_arch("llama3.2-3b").reduced(n_layers=2, d_model=64, n_heads=4,
                                          head_dim=16, vocab=256)
    corpus = sample_corpus_batch("github", 6, 512, cfg.spec.vocab, seed=0)
    plan = plan_batch(CostModel(cfg.spec, ClusterSpec(d_p=2, d_s=2)),
                      [len(v) for v in corpus.values()],
                      PlannerConfig(fixed_k=2, bucket_rounding=16))
    chunk, _, seg, pos = _plan_chunks(corpus, plan)[0]
    a0 = int((seg >= 0).argmax())
    n0 = int((seg == seg[a0]).sum())
    if n0 < 96:
        raise PhaseError(f"fig13's largest chunk: segment 0 has {n0} rows")
    r = a0 + n0 // 2 // 32 * 32
    out.append((f"fig13 chunk ({chunk.tokens} tokens)", seg, pos, 16,
                slice(r, r + 32)))
    return out


def _random_sequence(seed, Dh, dev, T=1024, Hq=4, Hkv=2):
    """``inputs(gen, dtype)`` of one ``T``-row sequence (one segment,
    positions 0..T-1): q, k, v and the output gradient drawn in that order
    by ``torch.randn`` from a CPU generator seeded with ``seed`` (the
    case's own generator is not used), cast to ``dtype``."""
    import torch

    def inputs(gen, dtype):
        g = torch.Generator().manual_seed(seed)
        shapes = ((T, Hq, Dh), (T, Hkv, Dh), (T, Hkv, Dh), (T, Hq, Dh))
        q, k, v, do = (torch.randn(sh, generator=g).to(dtype).to(dev)
                       for sh in shapes)
        seg = torch.zeros(T, dtype=torch.int32, device=dev)
        pos = torch.arange(T, dtype=torch.int32, device=dev)
        return q, k, v, do, [seg, seg, pos, pos]
    return inputs


# bf16 A′ on random 1,024-row sequences, (width, seed): the draws on which
# Delta taken from the bf16 output read 1.26x and 0.94x the bf16 TOL in a
# CPU emulation of the kernel's roundings (the exact Delta: 0.66x, 0.41x)
RANDOM_BWD_CASES = ((16, 4), (64, 1))


def phase_kernel_dense(dev, seed):
    """Kernels A and A′ at the widths this slice instantiated, as the
    attention backward cases above: (160, 160) on train_stablelm's largest
    chunk of step 0 (bf16; 32 query heads, 8 KV heads) and on
    train_verify_stablelm's largest chunk with its carry in front
    (float32); (32, 32) and (16, 16) at fig11's and fig13's reduced shapes
    (:func:`_figure_chunks`; bf16 and float32, the keys split and merged).
    The forward with no gradient at (160, 160) on a short step (256 query
    rows: split keys, the merge pass at value width 160) and the merge pass
    alone there. B, C1, C2 at the three heads (D 2,560 / V 151,936; 3,584 /
    152,064; 5,120 / 100,352) on each train phase's largest chunk of step
    0 (bf16; C1 and C2 in clusters of 7, 8 and 14 CTAs), and float32 on
    train_verify_stablelm's chunk; C1's and C2's cluster occupancy
    (``cudaOccupancyMaxActiveClusters``) at every head width of the
    registry."""
    import torch

    from repro_torch.configs import arch_names, get_arch
    from repro_torch.kernels.cross_entropy import (d_slice_width,
                                                   max_active_clusters)
    bf16, f32 = torch.bfloat16, torch.float32
    s = _arch(STABLELM).spec
    chunk, _, seg, pos = _train_chunks(seed, STABLELM)[0]
    name = f"{STABLELM} train chunk ({chunk.tokens} tokens)"
    a0 = int((seg >= 0).argmax())
    n0 = int((seg == seg[a0]).sum())
    r = a0 + min(1024, n0 // 2 // 32 * 32)
    if n0 < 128:
        raise PhaseError(f"{name}: segment 0 has {n0} rows")

    def from_plan(gen, dtype):
        return _plan_chunk(gen, seg, pos, s.n_heads, s.n_kv_heads,
                           s.head_dim, dtype, dev)
    cases = [(f"{name} global", from_plan, slice(r, r + 32), 0, bf16,
              DENSE_ROW_BLOCK),
             (*_verify_attn_case(STABLELM, "train_verify_stablelm", seed,
                                 dev), 0, f32, DENSE_ROW_BLOCK)]
    for tag, fseg, fpos, dh, drop in _figure_chunks():
        for dtype in (bf16, f32):
            cases.append((tag, lambda gen, dtype, fseg=fseg, fpos=fpos,
                          dh=dh: _plan_chunk(gen, fseg, fpos, 4, 2, dh, dtype,
                                             dev),
                          drop, 0, dtype, ATTN_ROW_BLOCK))
    for dh, s_ in RANDOM_BWD_CASES:
        cases.append((f"random 1024-row sequence (width {dh}, seed {s_})",
                      _random_sequence(s_, dh, dev), slice(512, 544), 0,
                      bf16, ATTN_ROW_BLOCK))
    bwd = []
    for *args, rows in cases:
        bwd.append(_attn_bwd_case(*args, dev, 51 + len(bwd), row_block=rows))
        print(f"[kernel] attention backward {json.dumps(bwd[-1])}",
              flush=True)
        torch.cuda.empty_cache()
    # a short step of stablelm's heads: 4 query tiles x 32 heads do not
    # fill the card, so the keys split and the merge pass runs at 160
    step = [(1536, 128), (0, 100)] + [(400 + 200 * i, 1) for i in range(8)]
    fwd = _kernel_case(f"{STABLELM} short step (256 rows)", step, s.n_heads,
                       s.n_kv_heads, s.head_dim, 0, bf16, dev, 61,
                       n_items=1, cap_t=256)
    print(f"[kernel] {json.dumps(fwd)}", flush=True)
    merge = _combine_case(f"{STABLELM} short step (256 rows)", step,
                          s.n_heads, s.n_kv_heads, s.head_dim, 0, bf16, dev,
                          61, n_items=1, cap_t=256)
    print(f"[kernel] merge pass {json.dumps(merge)}", flush=True)
    ce = []
    for i, arch in enumerate((QWEN3, VL, STABLELM)):
        c, tgt = _train_chunks(seed, arch)[0][:2]
        ce.append(_ce_case(arch, bf16, dev, 62 + i,
                           targets=torch.from_numpy(tgt),
                           case=f"{arch} train chunk ({c.tokens} tokens)"))
        for rec in ce[-1].values():
            print(f"[kernel] cross-entropy {json.dumps(rec)}", flush=True)
        torch.cuda.empty_cache()
    v_chunk, v_tgt = _plan_chunks(*_verify_plan(STABLELM, seed)[1:])[0][:2]
    ce.append(_ce_case(STABLELM, f32, dev, 65,
                       targets=torch.from_numpy(v_tgt),
                       case=f"train_verify_stablelm chunk ({v_chunk.tokens} "
                            f"tokens)"))
    for rec in ce[-1].values():
        print(f"[kernel] cross-entropy {json.dumps(rec)}", flush=True)
    torch.cuda.empty_cache()
    occupancy = {}
    for D in sorted({get_arch(a).spec.d_model for a in arch_names()}):
        width = d_slice_width(D)
        occupancy[str(D)] = {"slices": -(-D // width), "slice_width": width,
                             **{k: max_active_clusters(k, D, dev)
                                for k in ("dh", "dw")}}
    if not all(o[k] >= 1 for o in occupancy.values() for k in ("dh", "dw")):
        raise PhaseError(f"a C1 / C2 cluster cannot launch: {occupancy}")
    return bwd, fwd, merge, ce, occupancy


@contextlib.contextmanager
def _dense_fault(trainer, fault):
    """The trainer with one planted fault (undone on exit): ``"k-norm
    dropped"`` (qwen3-4b) skips the k-norm of every layer; ``"dKV dropped
    at the hand-off"`` detaches the KV carry each chunk hands on, so its
    gradient never reaches the chunk that produced it; ``"M-RoPE at
    chunk-local rows"`` (qwen2-vl-7b) builds each chunk's M-RoPE table from
    its row index in place of its tokens' positions."""
    import torch

    from repro_torch.models import attention as attn_mod
    model = trainer.model
    if fault == "k-norm dropped":
        norm = attn_mod.rms_norm
        k_norms = {id(lp["attn"]["k_norm"]) for lp in trainer.params["layers"]}

        def faulty(x, gamma, eps=1e-6):
            return x if id(gamma) in k_norms else norm(x, gamma, eps)
        attn_mod.rms_norm = faulty
    elif fault == "dKV dropped at the hand-off":
        fwd = model.forward_chunk

        def faulty(*a, **kw):
            hidden, out = fwd(*a, **kw)
            if out is not None:
                out = out._replace(**{f: [t.detach().requires_grad_(True)
                                          for t in getattr(out, f)]
                                      for f in ("k", "v")})
            return hidden, out
        model.forward_chunk = faulty
    elif fault == "M-RoPE at chunk-local rows":
        tables = model.rope_tables

        def faulty(pos, positions3=None):
            return tables(torch.arange(pos.shape[0], dtype=pos.dtype,
                                       device=pos.device))
        model.rope_tables = faulty
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        if fault == "k-norm dropped":
            attn_mod.rms_norm = norm
        for attr in ("forward_chunk", "rope_tables"):
            model.__dict__.pop(attr, None)


@contextlib.contextmanager
def _plain_float64():
    """The attention and cross-entropy dispatch of a model made inside it
    replaced by plain float64 versions (undone on exit): for the float64
    witness only, which no kernel takes. Attention: softmax over the
    packed-varlen mask (``ref.attention_mask``), a row with no live key
    0; cross-entropy: the full ``[T, V]`` logits, ``logsumexp`` minus the
    target's."""
    import torch

    from repro_torch.kernels import ops, ref

    def attention(q, k, v, seg_q, seg_kv, pos_q, pos_kv, *, causal=True,
                  window=0, scale=None):
        T, Hq, Dh = q.shape
        Hkv = k.shape[1]
        scale = scale if scale is not None else Dh ** -0.5
        qg = q.reshape(T, Hkv, Hq // Hkv, Dh)
        s = torch.einsum("tkgd,skd->kgts", qg, k) * scale
        m = ref.attention_mask(seg_q, seg_kv, pos_q, pos_kv, causal,
                               int(window))
        s = torch.where(m, s, torch.full_like(s, ref.NEG_INF))
        p = torch.where(m.any(dim=-1)[:, None], torch.softmax(s, dim=-1),
                        torch.zeros_like(s))
        return torch.einsum("kgts,skd->tkgd", p, v).reshape(T, Hq, -1)

    def cross_entropy(hidden, w, targets, valid):
        logits = hidden @ w.T
        tl = logits.gather(1, targets[:, None].long())[:, 0]
        vf = valid.to(hidden.dtype)
        return ((torch.logsumexp(logits, dim=-1) - tl) * vf).sum(), vf.sum()
    saved = ops.flash_attention, ops.fused_cross_entropy
    ops.flash_attention, ops.fused_cross_entropy = attention, cross_entropy
    try:
        yield
    finally:
        ops.flash_attention, ops.fused_cross_entropy = saved


def _float64_witness(cfg, params, corpus, dev):
    """The verify step's loss and gradients in float64, independent of the
    kernels: one forward and backward per sequence (as
    ``ChunkedTrainer.sequence_loss_and_grads``, every layer under
    checkpoint) through :func:`_plain_float64`'s attention and
    cross-entropy, float64 products and sums throughout (the port's norms,
    SwiGLU and rotary take their elementwise steps in float32: ~6e-8
    each). ``(loss, gradient leaves on the host)``, in the leaf order of
    ``ChunkedTrainer(cfg, params).params``."""
    import numpy as np
    import torch

    from repro_torch.models import DecoderLM
    from repro_torch.models.model import (tree_leaves, tree_map,
                                          unstack_layers)
    from repro_torch.runtime.train_step import ROW_MULTIPLE
    p64 = tree_map(lambda a: a.detach().to(dev, torch.float64, copy=True)
                   .requires_grad_(True), unstack_layers(params))
    n_valid = sum(max(len(t) - 1, 0) for t in corpus.values())
    total = 0.0
    with _plain_float64():
        model = DecoderLM(cfg)
        for sid in sorted(corpus):
            toks = np.asarray(corpus[sid], np.int64)
            n = len(toks)
            rows = -(-n // ROW_MULTIPLE) * ROW_MULTIPLE
            tgt = np.full(rows, -1, np.int64)
            tgt[:n - 1] = toks[1:]
            seg = np.full(rows, -1, np.int32)
            seg[:n] = 0
            pos = np.zeros(rows, np.int32)
            pos[:n] = np.arange(n)
            seg_t = torch.from_numpy(seg).to(dev)
            hidden, _ = model.forward_chunk(
                p64, torch.from_numpy(np.pad(toks, (0, rows - n))).to(dev),
                seg_t, torch.from_numpy(pos).to(dev),
                compute_dtype=torch.float64, remat=cfg.spec.n_layers)
            loss, _ = model.chunk_loss(p64, hidden,
                                       torch.from_numpy(tgt).to(dev), seg_t)
            (loss / n_valid).backward()
            total += float(loss.detach())
    grads = [p.grad.cpu() for p in tree_leaves(p64)]
    del p64
    return total / n_valid, grads


def _against_float64(run, witness, names):
    """The largest relative difference of ``run``'s loss and of any of its
    gradient leaves (max |diff| over the leaf's largest float64 value)
    from :func:`_float64_witness`'s, and that leaf's name."""
    loss64, grads64 = witness
    from repro_torch.models.model import tree_leaves
    worst, leaf = 0.0, 0
    for i, (a, w) in enumerate(zip(tree_leaves(run.grads), grads64)):
        w = w.to(a.device)
        r = float((a.double() - w).abs().max()) / max(float(w.abs().max()),
                                                      1e-300)
        if r > worst:
            worst, leaf = r, i
    return {"loss_rel_diff": abs(run.loss - loss64) / abs(loss64),
            "grad_max_rel_diff": worst, "grad_max_rel_diff_leaf": names[leaf]}


# the dense verify phases' limit on each gradient leaf's relative
# difference from one unchunked run per sequence. Set from the float32
# floor at these widths (the weight gradients' sums over 4,700 rows, taken
# per sequence or per chunk), read on the H100 three ways: the chunked
# step against the unchunked run 1.06e-5 to 1.14e-5; the same corpus
# packed into one chunk with no split (K = 1: no carry, no hand-off)
# 9.5e-6 to 1.09e-5; and each float32 run against the float64 witness
# (:func:`_float64_witness`, no kernel), which the phase reads and holds
# to the same limit (PERF.md §6). Two float32 runs each that far from
# the exact gradient can differ by the sum of the two. The faults read
# 0.80 and above. The loss keeps VERIFY_LIMIT (readings 7e-8).
DENSE_GRAD_LIMIT = 3e-5
DENSE_FAULTS = {QWEN3: "k-norm dropped",
                STABLELM: "dKV dropped at the hand-off",
                VL: "M-RoPE at chunk-local rows"}


def phase_train_verify_dense(dev, seed, arch):
    """``arch`` in float32 at full width and :data:`VERIFY_LAYERS`' depth
    (else the train phases'), on the verify sequences (one of 3,000 tokens over 3 chunks; a packed
    chunk; a non-zero remat table under the 2 GB budget):

    * the chunked step launches the kernels as its plan predicts;
    * the step with the table zeroed equals it bit for bit;
    * one unchunked forward and backward per sequence agrees with it: the
      loss within VERIFY_LIMIT, each gradient leaf within DENSE_GRAD_LIMIT
      relative to its largest value; the same corpus planned with no split
      (K = 1) is held to the same limits, and its reading shows the float32
      floor of the comparison;
    * the chunked step and the unchunked run each agree with the float64
      witness (:func:`_float64_witness`, no kernel) within the same limits:
      the floor read against an exact reference, not the program itself;
    * the planted fault of DENSE_FAULTS falls outside those limits."""
    import torch

    from repro_torch.core import (ClusterSpec, CostModel, PlannerConfig,
                                  plan_batch)
    from repro_torch.models import DecoderLM
    from repro_torch.models.model import tree_leaves
    from repro_torch.runtime.train_step import ChunkedTrainer, remat_depths
    cfg, corpus, plan = _verify_plan(arch, seed)
    chunks = [c for p in plan.pipelines for c in p.chunks]
    if max(s.n_chunks for s in plan.sequences) < 3 or not any(
            c.kind.value == "hybrid" for c in chunks) or not any(
            plan.ckpt_table()[0]):
        raise PhaseError(f"the verify plan lacks a 3-chunk split, a packed "
                         f"chunk or remat: {plan.ckpt_table()}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = DecoderLM(cfg).init(gen, device=dev)
    t0 = time.perf_counter()
    witness = _float64_witness(cfg, params, corpus, dev)
    witness_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    tr = ChunkedTrainer(cfg, params, device=dev, compute_dtype=torch.float32)
    del params
    ctr = _train_counters()
    expected = _expected_launches(cfg, plan, remat_depths(
        plan, cfg.spec.n_layers), torch.float32)
    _zero_counts(ctr)
    base = tr.loss_and_grads(plan, corpus)
    launches = {k: v for k, v in _read_counts(ctr).items() if k in expected}
    out = {"layers": cfg.spec.n_layers,
           "chunks": [(c.kind.value, c.context, c.tokens) for c in chunks],
           "remat_table": plan.ckpt_table()[0], "launches": launches,
           "loss": base.loss, "limit": VERIFY_LIMIT}
    if launches != expected:
        raise PhaseError(f"launch counts with remat (got, expected): "
                         f"{launches}, {expected}")
    zeroed = tr.loss_and_grads(plan, corpus, remat_policy="none")
    same = zeroed.loss == base.loss and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(zeroed.grads),
                                          tree_leaves(base.grads)))
    out["table zeroed"] = {"loss": zeroed.loss, "bitwise_equal": same}
    del zeroed
    if not same:
        raise PhaseError(f"the remat-zeroed step is not bitwise equal: {out}")
    whole = tr.sequence_loss_and_grads(corpus)
    names = _leaf_names(tr.params)

    def against_whole(run):
        worst, leaf = 0.0, 0
        for i, (a, b) in enumerate(zip(tree_leaves(run.grads),
                                       tree_leaves(whole.grads))):
            r = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 1e-30)
            if r > worst:
                worst, leaf = r, i
        rel = abs(run.loss - whole.loss) / abs(whole.loss)
        return {"loss": run.loss, "loss_rel_diff": rel,
                "grad_max_rel_diff": worst,
                "grad_max_rel_diff_leaf": names[leaf],
                "within": rel <= VERIFY_LIMIT and worst <= DENSE_GRAD_LIMIT
                and run.n_valid == whole.n_valid}
    out["unchunked"] = dict(against_whole(base), loss_unchunked=whole.loss,
                            grad_limit=DENSE_GRAD_LIMIT)
    out["float64 witness"] = {
        "seconds": witness_s, "loss": witness[0],
        "chunked step": _against_float64(base, witness, names),
        "unchunked": _against_float64(whole, witness, names)}
    del base
    # the float32 floor of the comparison: the same corpus planned with no
    # split (K = 1: no carry, no hand-off) against the same unchunked run
    packed = plan_batch(CostModel(cfg.spec, ClusterSpec()),
                        [len(v) for v in corpus.values()], PlannerConfig(
                            fixed_k=1, bucket_rounding=64,
                            remat_mode="stage_aware"))
    if any(c.has_dependents or c.context
           for p in packed.pipelines for c in p.chunks):
        raise PhaseError("the K = 1 plan splits a sequence")
    out["unchunked"]["K = 1, no split"] = dict(
        against_whole(tr.loss_and_grads(packed, corpus)),
        plan=[[c.tokens for c in p.chunks] for p in packed.pipelines])
    fault = DENSE_FAULTS[arch]
    with _dense_fault(tr, fault):
        out[fault] = against_whole(tr.loss_and_grads(plan, corpus))
    del whole, tr, witness
    torch.cuda.empty_cache()
    if not (out["unchunked"]["within"]
            and out["unchunked"]["K = 1, no split"]["within"]):
        raise PhaseError(f"the unchunked step differs from the chunked "
                         f"step: {out}")
    if any(r["loss_rel_diff"] > VERIFY_LIMIT
           or r["grad_max_rel_diff"] > DENSE_GRAD_LIMIT
           for k, r in out["float64 witness"].items() if k in (
               "chunked step", "unchunked")):
        raise PhaseError(f"a float32 run differs from the float64 "
                         f"witness: {out}")
    if out[fault]["within"]:
        raise PhaseError(f"the limit does not catch {fault!r}: {out}")
    return out


# split_vl: one sequence of an image span of SPLIT_GRID patches and
# SPLIT_TEXT text tokens, split at SPLIT_CUT (inside the image span)
SPLIT_GRID, SPLIT_TEXT, SPLIT_CUT = (16, 16), 1792, 200


def phase_split_vl(dev, seed):
    """qwen2-vl-7b at full width, float32, at the train phases' depth: one
    sequence whose first 256 rows are the vision stub's patch embeddings
    (a 16 x 16 grid, in place of the token embeddings) at
    ``mrope_positions_stub``'s 3-D positions, then 1,792 text tokens. Its
    forward as two chunks (the cut inside the image span) with the KV
    carry agrees with the unchunked forward within VERIFY_LIMIT (max |diff|
    over max |unchunked|); the same split at text positions on the image
    span, and with the h and w position rows swapped, falls outside it.
    No gradient: kernel A's float32 forward a layer a chunk, no plain
    call."""
    import torch

    from repro_torch.kernels.flash_attention import BLOCK_KV, kv_splits
    from repro_torch.models import DecoderLM
    from repro_torch.models.frontends import (mrope_positions_stub,
                                              vision_patch_stub)
    from repro_torch.models.model import layer_params
    cfg = _arch(VL)
    L = cfg.spec.n_layers
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = DecoderLM(cfg)
    params = model.init(gen, device=dev)
    n_patch = SPLIT_GRID[0] * SPLIT_GRID[1]
    T = n_patch + SPLIT_TEXT
    cuts = ((0, SPLIT_CUT), (SPLIT_CUT, T))
    pos3 = mrope_positions_stub(SPLIT_TEXT, n_patch, SPLIT_GRID, device=dev)
    seg = torch.zeros(T, dtype=torch.int32, device=dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev)
    tok = torch.randint(0, cfg.spec.vocab, (T,), generator=gen, device=dev)
    with torch.no_grad():
        x = model.embed(params, tok, torch.float32)
        x[:n_patch] = vision_patch_stub(cfg, gen, n_patch, device=dev,
                                        dtype=torch.float32)
    layers = [(layer_params(params, i), w)
              for i, w in enumerate(cfg.layer_windows())]
    ctr = _train_counters()
    _zero_counts(ctr)

    @torch.no_grad()
    def split(rows3):
        ctx = model.init_ctx(T, torch.float32, device=dev)
        outs = []
        for a, b in cuts:
            h, ctx = model.run_layers(
                layers, x[a:b], seg[a:b], pos[a:b], ctx=ctx, ctx_len=a,
                rope=model.rope_tables(pos[a:b], None if rows3 is None
                                       else rows3[:, a:b]))
            outs.append(h)
        return torch.cat(outs)
    with torch.no_grad():
        whole, _ = model.run_layers(layers, x, seg, pos,
                                    rope=model.rope_tables(pos, pos3))
    runs = {"chunked": split(pos3), "text positions": split(None),
            "h and w rows swapped": split(pos3[[0, 2, 1]])}
    counts = _read_counts(ctr)
    scale = float(whole.abs().max())
    rel = {k: float((h - whole).abs().max()) / scale for k, h in runs.items()}
    rec = dict(layers=L, tokens=T, image_patches=n_patch, cut=SPLIT_CUT,
               rel_diff=rel, limit=VERIFY_LIMIT,
               launches={k: v for k, v in counts.items() if v})
    del params, runs, whole, x
    torch.cuda.empty_cache()
    # the float32 forward runs its merge pass where its keys split: the
    # chunk's rows after C context rows, padded to BLOCK_KV
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def merges(C, rows):
        S = -(-(C + rows) // BLOCK_KV) * BLOCK_KV
        return int(kv_splits(rows, S, cfg.spec.n_heads, n_sm,
                             torch.float32) > 1)
    want = {k: 0 for k in counts}
    want.update({"flash_fwd_kernel": 7 * L,
                 "flash_combine_kernel": L * (merges(0, T) + 3 * sum(
                     merges(a, b - a) for a, b in cuts))})
    if counts != want:
        raise PhaseError(f"launch counts (got, expected): {counts}, {want}")
    if rel["chunked"] > VERIFY_LIMIT:
        raise PhaseError(f"the split forward differs from the whole: {rec}")
    missed = [k for k in ("text positions", "h and w rows swapped")
              if rel[k] <= VERIFY_LIMIT]
    if missed:
        raise PhaseError(f"the limit does not catch {missed}: {rec}")
    return rec


# ---------------------------------------------------------------------------
# the encoder-decoder: seamless-m4t-v2 at full width and depth through the
# stage-split pipeline (24 encoder + 24 decoder layers, 16 heads of 64,
# D 1,024, V 256,206, the tied head)

SEAMLESS = "seamless-m4t-v2"
# train_encdec's runs: (mesh, schedule, steps, sequences a batch). 4x1 on
# github batches of 8 is estimated at 80.2 GB on this card (24.4 + 20.3 +
# 17.3 + 18.2 GB), over the 72 GB the train phases hold their plans to:
# it takes 7 sequences (65.2 GB estimated). 2x1 runs one step since
# train_encdec_sp joined (2 before), to keep the script in its time;
# train_encdec_sp trains the same batches' steps 0 and 1 at 2x2
ENCDEC_RUNS = ((2, "gpipe-1f1b", 1, 8), (4, "zero-bubble-h1", 1, 7))
# train_verify_encdec: 2 encoder and 2 decoder layers at full width, four
# sequences in chunks of at most 1,280 tokens, and an activation budget
# per stage beside the model states under which the ILP remats a layer of
# some chunks on encoder and on decoder stages (tables [[1, 0, 0], [0, 1,
# 0]] at d_p 2 and [[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]] at 4)
ENCDEC_VERIFY_LENS = (1200, 700, 400, 250)
ENCDEC_VERIFY_RUNS = ((2, "gpipe-1f1b", 0.1e9), (4, "zero-bubble-h1",
                                                 0.05e9))


# train_encdec_sp: (d_p, d_s, schedule) at full width and depth, ZeRO-3
# per_tick (the reference's default), ENCDEC_SP_STEPS steps on train's
# batches
ENCDEC_SP = (2, 2, "gpipe-1f1b")
ENCDEC_SP_STEPS = 2
# train_verify_encdec's cases on the sequence-parallel and pod axes: (name,
# d_p, d_s, schedule, ZeRO-3 mode, pods), each planned with the 2x1 case's
# activation budget over its ranks
ENCDEC_VERIFY_SP = (("2x2", 2, 2, "gpipe-1f1b", "per_tick", 1),
                    ("2x2 zero-bubble-h1", 2, 2, "zero-bubble-h1",
                     "per_step", 1),
                    ("4x2", 4, 2, "gpipe-1f1b", "per_tick", 1),
                    ("2 pods of 2x1", 2, 1, "gpipe-1f1b", None, 2),
                    ("2 pods of 2x2", 2, 2, "gpipe-1f1b", "per_tick", 2))
ENCDEC_SP_FAULTS = ("cross-attention over its own rank's frames",
                    "a rank's memory gradient dropped")


def _encdec_sp_loop(seed):
    """train_encdec_sp's trainer settings (``launch/train.TrainConfig``)."""
    d_p, d_s, sched = ENCDEC_SP
    loop = _train_loop(seed)
    loop.steps, loop.d_p, loop.d_s, loop.schedule = ENCDEC_SP_STEPS, d_p, \
        d_s, sched
    return loop


def _encdec_sp_chunks(seed):
    """train_encdec_sp's step-0 chunks as the step cuts them for its ranks
    (rows a multiple of 64 d_s; the frames at the tokens' rows):
    ``[(chunk, targets, seg, pos)]`` over the whole chunk, the largest
    first."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.data.batching import materialize_plan
    from repro_torch.launch.train import plan_step
    from repro_torch.runtime.train_step import chunk_arrays
    loop = _encdec_sp_loop(seed)
    cfg = get_arch(SEAMLESS)
    corpus, plan = plan_step(trainer_cm(loop.d_p, cfg, loop.d_s), loop, 0,
                             schedule=loop.schedule, v_stages=1)
    chunks = [c for p in plan.pipelines for c in p.chunks]
    batch = materialize_plan(plan, corpus)
    out = []
    for k in sorted(range(len(chunks)), key=lambda i: -chunks[i].tokens):
        _, tgt, seg, pos = (np.concatenate(a) for a in chunk_arrays(
            batch, k, chunks[k].tokens, loop.d_s))
        out.append((chunks[k], tgt, seg, pos))
    return out


def _split_pipelines(plan, n):
    """``plan``'s one pipeline cut into ``n`` pipelines of consecutive
    chunks (each its own backward order, its schedule made again), so that
    each of ``n`` pods takes one (the verify batch is one pipeline)."""
    import dataclasses

    import numpy as np
    (pipe,) = plan.pipelines
    subs = []
    for idx in np.array_split(np.arange(pipe.n_chunks), n):
        a, b = int(idx[0]), int(idx[-1]) + 1
        order = sorted(range(a, b), key=lambda i: pipe.f2b[i])
        subs.append(dataclasses.replace(
            pipe, chunks=pipe.chunks[a:b],
            f2b=[order.index(i) for i in range(a, b)], schedule=[],
            ckpt=[row[a:b] for row in pipe.ckpt], ckpt_diag=[]))
    return dataclasses.replace(plan, pipelines=subs)


def _encdec_cm(d_p, spec):
    """The cost model ``launch/train.train`` plans ``d_p`` stages of this
    card with (:func:`trainer_cm`), for ``spec``."""
    from repro_torch.core import ClusterSpec, CostModel
    cl = ClusterSpec()
    return CostModel(spec, cl.with_(d_p=d_p, hbm_bytes=cl.hbm_bytes / d_p))


def _encdec_chunks(seed):
    """train_encdec's step-0 chunks at 2x1 (:func:`_plan_chunks`: the
    largest first); a chunk's frames sit at its tokens' rows, so the
    encoder's seg and pos are its tokens'."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import plan_step
    cfg = get_arch(SEAMLESS)
    return _plan_chunks(*plan_step(_encdec_cm(2, cfg.spec), _train_loop(seed),
                                   0, schedule="gpipe-1f1b", v_stages=1))


def _encdec_verify_plan(seed, d_p, schedule, budget, dev, d_s=1):
    """train_verify_encdec's batch: ``(cfg, corpus, frames, cm, plan)`` at
    2 + 2 layers, float32 frames from the stub (``sequence_frames``); at
    ``d_s > 1`` planned at the reference's SP point (allgather_kv over
    every rank, a rank's share of the card and of ``budget``)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import PlannerConfig, plan_batch
    from repro_torch.data.batching import sequence_frames
    cfg = get_arch(SEAMLESS)
    cfg = dataclasses.replace(cfg, spec=dataclasses.replace(
        cfg.spec, n_layers=2, n_encoder_layers=2))
    rng = np.random.default_rng(seed)
    corpus = {i: rng.integers(0, cfg.spec.vocab, n).astype(np.int32)
              for i, n in enumerate(ENCDEC_VERIFY_LENS)}
    cm = _encdec_cm(d_p, cfg.spec) if d_s == 1 else \
        trainer_cm(d_p, cfg, d_s)
    plan = plan_batch(cm, list(ENCDEC_VERIFY_LENS), PlannerConfig(
        fixed_k=1, bucket_rounding=64, remat_mode="stage_aware", v_stages=1,
        sp_policy="allgather_kv" if d_s > 1 else "auto", sp_degree=d_s,
        schedule=schedule, token_capacity=1280,
        capacity_bytes=max(cm.m_model_states(p) for p in range(1, d_p + 1))
        + budget / d_s))
    frames = sequence_frames(cfg, corpus, seed, device=dev,
                             dtype=torch.float32)
    return cfg, corpus, frames, cm, plan


def _cross_meta(seg, frac):
    """Cross-attention's key side for the query rows ``seg``: each segment
    of the chunk ``round(frac * L)`` memory rows (at least 1), packed in
    segment order, padding to a multiple of 64; both sides at position
    0."""
    import numpy as np
    ids, counts = np.unique(seg[seg >= 0], return_counts=True)
    kseg = np.concatenate([np.full(max(1, round(frac * n)), g, np.int32)
                           for g, n in zip(ids, counts)])
    kseg = np.concatenate([kseg, np.full(-len(kseg) % 64, -1, np.int32)])
    return kseg, np.zeros(len(seg), np.int32), np.zeros(len(kseg), np.int32)


def phase_kernel_encdec(dev, seed):
    """Kernel A and A′ in the encoder-decoder's modes, at its heads (16
    query and 16 KV heads of 64): non-causal on train_encdec's most packed
    chunk of step 0 (the encoder: the frames' segments and positions,
    bf16) and on train_verify_encdec's largest chunk (float32);
    cross-attention from that train chunk's tokens to memory rows of the
    same segments, ``S < T``, ``S = T`` and ``S > T`` (half, as many and
    1.5 times each segment's rows; zero positions, bf16); B, C1, C2 at
    (D 1,024, V 256,206) on the two chunks' targets. Each attention case
    visits exactly its live tile pairs (``_attn_bwd_case``)."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    Hq, Hkv, D = 16, 16, 64
    # the most packed chunk: the encoder's segments and cross-attention's
    # pairing by segment id both show there
    chunk, tgt, seg, pos = max(_encdec_chunks(seed), key=lambda c: (
        len(c[0].slices), c[0].tokens))
    name = (f"{SEAMLESS} train chunk ({chunk.tokens} tokens, "
            f"{len(chunk.slices)} sequences)")
    a0 = int((seg >= 0).argmax())
    n0 = int((seg == seg[a0]).sum())
    r = a0 + min(1024, n0 // 2 // 32 * 32)

    def encoder(gen, dtype):
        return _plan_chunk(gen, seg, pos, Hq, Hkv, D, dtype, dev)

    def cross(frac):
        kseg, zq, zk = _cross_meta(seg, frac)

        def inputs(gen, dtype):
            def mk(*shape):
                return torch.randn(shape, generator=gen, device=dev,
                                   dtype=torch.float32).to(dtype)
            meta = [torch.from_numpy(x).to(dev) for x in (seg, kseg, zq, zk)]
            T, S = len(seg), len(kseg)
            return mk(T, Hq, D), mk(S, Hkv, D), mk(S, Hkv, D), mk(T, Hq, D), \
                meta
        return inputs, len(kseg)
    _, v_corpus, _, _, v_plan = _encdec_verify_plan(
        seed, *ENCDEC_VERIFY_RUNS[0], dev)
    v_chunk, v_tgt, v_seg, v_pos = _plan_chunks(v_corpus, v_plan)[0]

    def verify(gen, dtype):
        return _plan_chunk(gen, v_seg, v_pos, Hq, Hkv, D, dtype, dev)
    cases = [(f"{name} encoder", encoder, slice(r, r + 32), bf16)]
    for frac, tag in ((0.5, "S < T"), (1.0, "S = T"), (1.5, "S > T")):
        inputs, S = cross(frac)
        cases.append((f"{name} cross-attention to {S} memory rows ({tag})",
                      inputs, slice(32, 64), bf16))
    cases.append((f"train_verify_encdec chunk ({v_chunk.tokens} tokens) "
                  f"encoder", verify, slice(32, 64), f32))
    bwd = []
    for case, inputs, drop, dtype in cases:
        bwd.append(_attn_bwd_case(case, inputs, drop, 0, dtype, dev,
                                  61 + len(bwd), causal=False))
        print(f"[kernel] attention backward {json.dumps(bwd[-1])}",
              flush=True)
        torch.cuda.empty_cache()
    ce = []
    for dtype, seed_, targets, case in (
            (bf16, 66, torch.from_numpy(tgt), name),
            (f32, 67, torch.from_numpy(v_tgt),
             f"train_verify_encdec chunk ({v_chunk.tokens} tokens)")):
        ce.append(_ce_case(SEAMLESS, dtype, dev, seed_, targets=targets,
                           case=case))
        for rec in ce[-1].values():
            print(f"[kernel] cross-entropy {json.dumps(rec)}", flush=True)
        torch.cuda.empty_cache()
    return bwd, ce, _encdec_rank_cases(dev, seed)


def _encdec_rank_cases(dev, seed):
    """Kernel A and A′ and kernels B, C1, C2 at the shapes a rank of
    train_encdec_sp gives them on its largest step-0 chunk (the rank of
    ``d_s`` with the most live rows; bf16): ``{"encoder", "self",
    "cross": attention backward cases, "ce": the vocabulary block's}``.
    Every rank's rows are the keys (allgather_kv; cross-attention's are
    the gathered memory's, whose frames sit at the tokens' rows), the
    rank's block the queries."""
    import numpy as np
    import torch

    from repro_torch.runtime.sp import row_blocks
    bf16, Hq, Hkv, D = torch.bfloat16, 16, 16, 64
    d = ENCDEC_SP[1]
    chunk, tgt, seg, pos = _encdec_sp_chunks(seed)[0]
    b = len(seg) // d
    r = max(range(d), key=lambda i: int((seg[i * b:(i + 1) * b] >= 0).sum()))
    q_seg = seg[r * b:(r + 1) * b]
    zeros = np.zeros(len(seg), np.int32)
    name = (f"train_encdec_sp step-0 chunk ({chunk.tokens} tokens, "
            f"{len(chunk.slices)} sequences) rank {r} of {d}: {b} of "
            f"{len(seg)} rows")

    def rank_inputs(zero_pos):
        q_pos = (zeros if zero_pos else pos)[r * b:(r + 1) * b]
        k_pos = zeros if zero_pos else pos

        def inputs(gen, dtype):
            def mk(*shape):
                return torch.randn(shape, generator=gen, device=dev,
                                   dtype=torch.float32).to(dtype)
            meta = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                    for x in (q_seg, seg, q_pos, k_pos)]
            S = len(seg)
            return mk(b, Hq, D), mk(S, Hkv, D), mk(S, Hkv, D), \
                mk(b, Hq, D), meta
        return inputs
    # a live KV tile the rank's queries read: its own first live rows
    a0 = r * b + int((q_seg >= 0).argmax())
    drop = slice(a0, a0 + 32)
    out = {}
    for key, what, zero_pos, causal in (
            ("encoder", "encoder (frames, non-causal)", False, False),
            ("self", "decoder self-attention (causal)", False, True),
            ("cross", "cross-attention to the gathered memory (zero "
                      "positions)", True, False)):
        out[key] = _attn_bwd_case(f"{name}, {what}", rank_inputs(zero_pos),
                                  drop, 0, bf16, dev, 81 + len(out),
                                  causal=causal)
        print(f"[kernel] attention backward {json.dumps(out[key])}",
              flush=True)
        torch.cuda.empty_cache()
    shard = row_blocks(CE_HEADS[SEAMLESS][1], d)[1]
    out["ce"] = _ce_case(
        SEAMLESS, bf16, dev, 84, targets=torch.from_numpy(tgt),
        case=f"train_encdec_sp step-0 chunk ({chunk.tokens} tokens), "
             f"vocabulary block {shard[1]} rows at {shard[0]}", shard=shard)
    for rec in out["ce"].values():
        print(f"[kernel] cross-entropy {json.dumps(rec)}", flush=True)
    torch.cuda.empty_cache()
    return out


def _expected_encdec_launches(cfg, plan, d_p, dtype, n_sm,
                              policy="stage-aware", d_s=1):
    """Each stage's launches in one encoder-decoder step of ``plan``: per
    chunk and layer an encoder stage runs one attention op (non-causal),
    a decoder stage two (causal self-attention and cross-attention), each
    a forward with its tile ranges, once more per remat'd layer (the
    stage's row of the plan's table, at most its layers), and one of each
    backward pass; with ``d_s`` ranks, each op once a rank (its block of
    the chunk's rows against every rank's); a merge pass where the bf16
    forward splits the keys (``kv_splits`` at a rank's queries; the frames
    are the tokens' rows, so every op of a chunk has its shape); B, C1, C2
    once per vocabulary block and chunk on the last stage; the split's W
    runs cuBLAS products only; no plain call."""
    import torch

    from repro_torch.kernels.flash_attention import BLOCK_KV, kv_splits
    from repro_torch.runtime.sharding import encdec_stage_layers
    from repro_torch.runtime.sp import row_blocks
    from repro_torch.runtime.train_step import ROW_MULTIPLE, _table
    s = cfg.spec
    layout = encdec_stage_layers(s.n_encoder_layers, s.n_layers, d_p)
    table = _table(plan, d_p, policy)
    chunks = [c for p in plan.pipelines for c in p.chunks]
    q = ROW_MULTIPLE * d_s
    rows = [-(-max(c.tokens, 1) // q) * q for c in chunks]
    split = [dtype == torch.bfloat16 and kv_splits(
        n // d_s, -(-n // BLOCK_KV) * BLOCK_KV, s.n_heads, n_sm) > 1
        for n in rows]
    n_ce = sum(1 for _, n in row_blocks(s.vocab, d_s) if n)
    out = []
    for p, (role, ids) in enumerate(layout):
        ops_ = (1 if role == "encoder" else 2) * d_s
        fwd = ops_ * sum(len(ids) + min(table[p][k], len(ids))
                         for k in range(len(chunks)))
        bwd = ops_ * len(ids) * len(chunks)
        exp = _expected_launches(cfg, plan, [0] * len(chunks), dtype)
        for k in exp:
            if k.startswith("plain"):
                continue
            if k.startswith("ce_"):
                exp[k] = n_ce * exp[k] if p == d_p - 1 else 0
            elif k in ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"):
                exp[k] = bwd
            elif k == "flash_combine_kernel":
                exp[k] = ops_ * sum(
                    len(ids) + min(table[p][k2], len(ids))
                    for k2 in range(len(chunks)) if split[k2])
            elif exp[k]:                    # the forward and its ranges
                exp[k] = fwd
        out.append(exp)
    return out


class _StageTimes:
    """Each stage's device time by action (``F``, ``B``, ``W``): CUDA
    events recorded on the current stream before and after every action
    the executor runs (every stage here is on one card and one stream, so
    an action's span holds its kernels and any idle time between them);
    :meth:`drain` sums the finished spans in ms, by stage."""

    def __init__(self):
        self.pending = []

    @contextlib.contextmanager
    def patched(self):
        import torch

        from repro_torch.runtime.executor import PipelineExecutor
        run = PipelineExecutor._run

        def timed(ex, p, a):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            run(ex, p, a)
            ev[1].record()
            self.pending.append((p, a.op, *ev))
        PipelineExecutor._run = timed
        try:
            yield self
        finally:
            PipelineExecutor._run = run

    def drain(self):
        import torch
        torch.cuda.synchronize()
        out = {}
        for p, op, a, b in self.pending:
            d = out.setdefault(p, {})
            d[op] = d.get(op, 0.0) + a.elapsed_time(b)
        self.pending = []
        return out


def phase_train_encdec(dev, seed):
    """seamless-m4t-v2 at full width and depth, bf16 with a float32 AdamW
    master, through ``launch/train.train`` (:data:`ENCDEC_RUNS`: a step at
    2x1 under gpipe-1f1b, then one step at 4x1 under zero-bubble-h1 with
    the split backward, every stage on this card), each sequence with as
    many frames as tokens from the stub: per step the tokens/s (valid
    decoder tokens over the step's wall time), the frames, each stage's
    estimate and the card's peak beside their sum, the launches per stage,
    each stage's device time by action (:class:`_StageTimes`) and
    ``solve_s``; every loss finite, every peak at or under the plan's
    estimate, every stage's launches as its plan predicts and no plain
    call."""
    import math

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg = get_arch(SEAMLESS)
    recs, totals = [], {}
    for d_p, sched, steps, batch in ENCDEC_RUNS:
        loop = _train_loop(seed)
        loop.steps, loop.d_p, loop.schedule = steps, d_p, sched
        loop.global_batch = batch
        ctr = _train_counters()
        tally, expected, lines, times = {}, [], [], _StageTimes()
        stage_ms = []

        def on_step(step, plan, corpus, trainer):
            if expected:
                _check_stage_launches(tally, expected[-1],
                                      f"({d_p}x1) step {step - 1}")
                stage_ms.append(times.drain())
            expected.append(_expected_encdec_launches(
                cfg, plan, d_p, torch.bfloat16, n_sm))
            for t in tally.values():
                for k, n in t.items():
                    totals[k] = totals.get(k, 0) + n
            tally.clear()
            _zero_counts(ctr)
        with _per_stage(ctr, tally), times.patched():
            trainer, hist = train(cfg, loop, device=dev, on_step=on_step,
                                  log=lines.append)
        stage_ms.append(times.drain())
        _check_stage_launches(tally, expected[-1], f"({d_p}x1) last step")
        got = [dict(tally.get(p, {})) for p in range(d_p)]
        for t in tally.values():
            for k, n in t.items():
                totals[k] = totals.get(k, 0) + n
        for ln in lines:
            print(f"[train_encdec] ({d_p}x1) {ln}", flush=True)
        for i, (h, exp, ms) in enumerate(zip(hist, expected, stage_ms)):
            rec = dict(h, mesh=f"{d_p}x1", batch=batch, stage_launches=exp,
                       stage_device_ms={p: ms[p] for p in sorted(ms)})
            if i == len(hist) - 1:
                rec["stage_launches_got"] = got
            recs.append(rec)
            if not math.isfinite(h["loss"]):
                raise PhaseError(f"non-finite loss: {rec}")
            if h["card_peak_mem_gb"][0] > h["card_plan_mem_gb"][0]:
                raise PhaseError(
                    f"the card's peak {h['card_peak_mem_gb'][0]} GB is above "
                    f"the sum of its stages' estimates "
                    f"{h['card_plan_mem_gb'][0]} GB: {rec}")
        del trainer
        torch.cuda.empty_cache()
    return recs, totals


def phase_train_encdec_sp(dev, seed):
    """seamless-m4t-v2 at full width and depth on :data:`ENCDEC_SP`'s
    stages of sequence-parallel ranks through ``launch/train.train``
    (``--mesh 2x2``; allgather_kv over each stage's ranks, the reference's
    pin; ZeRO-3 ``per_tick``), bf16 with a float32 AdamW master, every
    stage and rank on this card, each rank planned with the card's memory
    over the stages and ranks, each sequence with as many frames as tokens
    from the stub. Gates: finite losses; each stage's launches as the plan
    predicts (:func:`_expected_encdec_launches` at ``d_s``), no plain
    call; the card's peak at or under the sum of its ranks' estimates;
    each rank's owned state at or under the charge of the parameters its
    stage holds (``EncDecTrainer.rank_charges``) plus its leaves kept
    whole and its share of the parameters the planner's count leaves out.
    Per step: tokens/s, the collectives' bytes and the memory gathers', A's
    and B's rows a rank, each rank's frame rows, the ZeRO-3 gathers and
    the planner's own charge (``m_model_states``) beside the stage's."""
    import math

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train
    cfg = get_arch(SEAMLESS)
    loop = _encdec_sp_loop(seed)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ctr = _train_counters()
    tally, expected, lines, totals = {}, [], [], {}
    tag = "train_encdec_sp"

    def fold():
        for t in tally.values():
            for k, n in t.items():
                totals[k] = totals.get(k, 0) + n

    def on_step(step, plan, corpus, trainer):
        if expected:
            _check_stage_launches(tally, expected[-1],
                                  f"{tag} step {step - 1}")
        expected.append(_expected_encdec_launches(
            cfg, plan, loop.d_p, torch.bfloat16, n_sm, d_s=loop.d_s))
        fold()
        tally.clear()
        _zero_counts(ctr)
    with _per_stage(ctr, tally):
        trainer, hist = train(cfg, loop, device=dev, on_step=on_step,
                              log=lines.append)
    _check_stage_launches(tally, expected[-1], f"{tag} last step")
    fold()
    for ln in lines:
        print(f"[{tag}] {ln}", flush=True)
    gb = lambda b: b / 1e9  # noqa: E731
    recs = []
    for h, exp in zip(hist, expected):
        rec = {k: h[k] for k in (
            "step", "loss", "tokens", "frames", "wall_s", "tokens_per_s",
            "chunks", "remat_layers", "sp_policy", "d_s_eff", "d_s",
            "attn_rows_per_rank", "ce_rows_per_rank", "frame_rows_per_rank",
            "collectives", "collective_bytes", "memory_gathers",
            "memory_gather_bytes", "card_peak_mem_gb", "card_plan_mem_gb",
            "stage_plan_mem_gb", "solve_s", "zero3_mode", "gathers",
            "regathers")}
        rec.update(
            rank_state_gb=[[gb(b) for b in st]
                           for st in h["rank_state_bytes"]],
            rank_charge_gb=[gb(b) for b in h["rank_charge_bytes"]],
            planner_charge_gb=[gb(b) for b in h["planner_charge_bytes"]],
            whole_state_gb=[[gb(b) for b in st]
                            for st in h["whole_state_bytes"]],
            uncounted_state_gb=gb(h["uncounted_state_bytes"]),
            gather_gb=gb(h["gather_bytes"]),
            scatter_gb=gb(h["scatter_bytes"]),
            gathered_peak_gb=gb(h["gathered_peak_bytes"]),
            arch=cfg.name, layers=[cfg.spec.n_encoder_layers,
                                   cfg.spec.n_layers],
            mesh=f"{loop.d_p}x{loop.d_s}", stage_launches=exp)
        recs.append(rec)
        if not math.isfinite(h["loss"]):
            raise PhaseError(f"{tag}: non-finite loss: {rec}")
        if h["card_peak_mem_gb"][0] > h["card_plan_mem_gb"][0]:
            raise PhaseError(
                f"{tag}: the card's peak {h['card_peak_mem_gb'][0]} GB is "
                f"above the sum of its ranks' estimates "
                f"{h['card_plan_mem_gb'][0]} GB: {rec}")
        for p, (own, whole) in enumerate(zip(h["rank_state_bytes"],
                                             h["whole_state_bytes"])):
            for r, (o, w) in enumerate(zip(own, whole)):
                limit = h["rank_charge_bytes"][p] + w + \
                    h["uncounted_state_bytes"]
                if o > limit:
                    raise PhaseError(
                        f"{tag}: stage {p} rank {r} owns {o} bytes, over "
                        f"the charge of its stage's parameters, its whole "
                        f"leaves and its share of the uncounted parameters "
                        f"({limit}): {rec}")
    del trainer
    torch.cuda.empty_cache()
    return recs, totals


@contextlib.contextmanager
def _plain_float64_encdec():
    """:func:`_plain_float64` with the decoder's cross-attention made of
    its projections and that plain attention (its own autograd function
    takes the kernels)."""
    import torch

    import repro_torch.models.encdec as encdec
    from repro_torch.kernels import ops
    from repro_torch.models.attention import _cross_kv
    saved = encdec.cross_attention

    def cross(q, memory, wk, wv, seg_q, seg_kv, *, heads, scale):
        k, v = _cross_kv(memory, wk, wv, heads, q.shape[-1])
        zq, zk = (torch.zeros_like(t) for t in (seg_q, seg_kv))
        return ops.flash_attention(q, k, v, seg_q, seg_kv, zq, zk,
                                   causal=False, scale=scale)
    encdec.cross_attention = cross
    try:
        with _plain_float64():
            yield
    finally:
        encdec.cross_attention = saved


def _encdec_witness(cfg, params, corpus, frames, dev):
    """The encoder-decoder verify step's loss and gradients in float64,
    independent of the kernels: one ``EncDecLM.loss`` per sequence through
    :func:`_plain_float64_encdec`; the gradients in ``from_stages``' leaf
    order."""
    import torch

    from repro_torch.models import EncDecLM
    from repro_torch.models.model import tree_leaves, tree_map
    from repro_torch.runtime.train_step import sequence_rows
    p64 = tree_map(lambda a: a.detach().to(dev, torch.float64, copy=True)
                   .requires_grad_(True), params)
    n_valid = sum(max(len(t) - 1, 0) for t in corpus.values())
    total = 0.0
    with _plain_float64_encdec():
        model = EncDecLM(cfg)
        for sid in sorted(corpus):
            toks, tgt, seg, pos = (torch.from_numpy(a).to(dev)
                                   for a in sequence_rows(corpus[sid]))
            fr = frames[sid].to(dev, torch.float64)
            fr = torch.cat([fr, fr.new_zeros((len(seg) - len(fr),
                                              fr.shape[1]))])
            loss, _ = model.loss(p64, fr, seg, pos, toks, tgt, seg, pos,
                                 compute_dtype=torch.float64)
            (loss / n_valid).backward()
            total += float(loss.detach())
    grads = [p.grad.cpu() for p in tree_leaves(p64)]
    del p64
    return total / n_valid, grads


@contextlib.contextmanager
def _encdec_fault(fault):
    """A planted encoder-decoder fault (undone on exit): ``"causal
    encoder"`` runs the encoder's self-attention with a causal limit;
    ``"memory gradient dropped"`` zeroes the memory's gradient that the
    last (decoder) stage hands back, so the stage before it passes on
    only its own layers' part."""
    import torch

    import repro_torch.models.encdec as encdec
    from repro_torch.runtime.executor import PipelineExecutor
    if fault == "causal encoder":
        obj, name, orig = encdec, "attention_block", encdec.attention_block

        def faulty(*a, **kw):
            return orig(*a, **dict(kw, causal=True))
    elif fault == "memory gradient dropped":
        obj, name = PipelineExecutor, "_send_grad"
        orig = PipelineExecutor._send_grad

        def faulty(self, s, k, g):
            if s == self.d_p - 1:
                g = (torch.zeros_like(g[0]), *g[1:])
            orig(self, s, k, g)
    else:
        raise ValueError(fault)
    setattr(obj, name, faulty)
    try:
        yield
    finally:
        setattr(obj, name, orig)


ENCDEC_FAULTS = ("causal encoder", "memory gradient dropped")


def phase_train_verify_encdec(dev, seed):
    """seamless-m4t-v2 in float32 at full width on 2 + 2 layers, the
    verify sequences (:data:`ENCDEC_VERIFY_LENS`) at d_p 2 (gpipe-1f1b)
    and 4 (zero-bubble-h1, the split backward), each under a remat table
    whose encoder and decoder rows differ: the pipelined step launches
    the kernels as its plan predicts; it and the whole-batch step
    (``EncDecTrainer.sequence_loss_and_grads``: one unchunked
    ``EncDecLM.loss`` a sequence) agree within VERIFY_LIMIT (the loss and
    each gradient leaf relative to its largest value), and each agrees
    with the float64 witness (:func:`_encdec_witness`, no kernel); at d_p
    4 both :data:`ENCDEC_FAULTS` fall outside the limit."""
    import torch

    from repro_torch.core.schedule import get_schedule
    from repro_torch.models import EncDecLM
    from repro_torch.models.model import tree_leaves
    from repro_torch.runtime.encdec_pipeline import EncDecGeometry
    from repro_torch.runtime.train_step import EncDecTrainer
    from repro_torch.weights import from_stages
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    out, totals, base = {}, {}, None
    for d_p, sched, budget in ENCDEC_VERIFY_RUNS:
        cfg, corpus, frames, cm, plan = _encdec_verify_plan(seed, d_p, sched,
                                                            budget, dev)
        table = plan.ckpt_table()
        if table[0] == table[-1] or not any(map(any, table)):
            raise PhaseError(f"the verify plan's remat table lacks rows that "
                             f"differ: {table}")
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = EncDecLM(cfg).init(gen, device=dev)
        t0 = time.perf_counter()
        witness = _encdec_witness(cfg, params, corpus, frames, dev)
        witness_s = time.perf_counter() - t0
        geom = EncDecGeometry(d_p=d_p, schedule=sched,
                              split_bwd=get_schedule(sched, 1).split_bwd)
        tr = EncDecTrainer(cfg, params, geometry=geom, cards=[dev],
                           compute_dtype=torch.float32, cost_model=cm)
        del params
        ctr = _train_counters()
        tally = {}
        expected = _expected_encdec_launches(cfg, plan, d_p, torch.float32,
                                             n_sm)
        _zero_counts(ctr)
        with _per_stage(ctr, tally):
            run = tr.loss_and_grads(plan, corpus, frames)
        _check_stage_launches(tally, expected, f"verify {d_p}x1")
        for t in tally.values():
            for k, n in t.items():
                totals[k] = totals.get(k, 0) + n
        whole = tr.sequence_loss_and_grads(corpus, frames)
        names = _leaf_names(from_stages(cfg, tr.params))

        def against_whole(r):
            worst, leaf = 0.0, 0
            for i, (a, b) in enumerate(zip(tree_leaves(r.grads),
                                           tree_leaves(whole.grads))):
                x = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                     1e-30)
                if x > worst:
                    worst, leaf = x, i
            rel = abs(r.loss - whole.loss) / abs(whole.loss)
            return {"loss": r.loss, "loss_rel_diff": rel,
                    "grad_max_rel_diff": worst,
                    "grad_max_rel_diff_leaf": names[leaf],
                    "within": rel <= VERIFY_LIMIT and worst <= VERIFY_LIMIT
                    and r.n_valid == whole.n_valid}
        rec = {"mesh": f"{d_p}x1", "schedule": sched, "remat_table": table,
               "chunks": [c.tokens for p in plan.pipelines for c in p.chunks],
               "limit": VERIFY_LIMIT, "pipelined": against_whole(run),
               "loss_whole_batch": whole.loss,
               "float64 witness": {
                   "seconds": witness_s, "loss": witness[0],
                   "pipelined": _against_float64(run, witness, names),
                   "whole batch": _against_float64(whole, witness, names)},
               "stage_launches": expected}
        if base is None:            # the 2x1 step: the SP cases' reference
            base = (run, witness, names, cfg, corpus, frames, budget)
        del run
        bad = [k for k in ("pipelined", "whole batch")
               if max(rec["float64 witness"][k]["loss_rel_diff"],
                      rec["float64 witness"][k]["grad_max_rel_diff"])
               > VERIFY_LIMIT]
        if d_p == 4:
            for fault in ENCDEC_FAULTS:
                with _encdec_fault(fault):
                    rec[fault] = against_whole(tr.loss_and_grads(
                        plan, corpus, frames))
        out[f"{d_p}x1"] = rec
        del whole, tr, witness
        torch.cuda.empty_cache()
        if not rec["pipelined"]["within"] or bad:
            raise PhaseError(f"the pipelined step, the whole-batch step and "
                             f"the float64 witness differ: {rec}")
        caught = [f for f in ENCDEC_FAULTS if f in rec and
                  rec[f]["within"]]
        if caught:
            raise PhaseError(f"the limit does not catch {caught}: {rec}")
    out.update(_encdec_verify_sp(dev, seed, base, n_sm, totals))
    out["launches"] = totals
    return out


@contextlib.contextmanager
def _encdec_sp_fault(fault):
    """A planted fault on the encoder-decoder's SP axis (undone on exit),
    as ``tests/test_torch_encdec_sp.encdec_sp_fault``: ``"cross-attention
    over its own rank's frames"`` gives each rank's cross-attention its own
    memory block in place of the gathered one; ``"a rank's memory gradient
    dropped"`` zeroes rank 1's block of the memory gradient the last stage
    hands back."""
    import torch

    from repro_torch.runtime import sp
    from repro_torch.runtime.executor import PipelineExecutor
    if fault == ENCDEC_SP_FAULTS[0]:
        obj, name = sp, "gather_memory"

        def faulty(memory, seg_mem):
            return list(zip(memory, seg_mem))
    elif fault == ENCDEC_SP_FAULTS[1]:
        obj, name = PipelineExecutor, "_send_grad"
        orig = PipelineExecutor._send_grad

        def faulty(self, s, k, g):
            if s == self.d_p - 1:
                g = (g[0], torch.zeros_like(g[1]), *g[2:])
            orig(self, s, k, g)
    else:
        raise ValueError(fault)
    saved = getattr(obj, name)
    setattr(obj, name, faulty)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def _encdec_verify_sp(dev, seed, base, n_sm, totals):
    """train_verify_encdec's cases on the sequence-parallel and pod axes
    (:data:`ENCDEC_VERIFY_SP`), float32, the same parameters and batch as
    the 2x1 case (``base``: its step, float64 witness, leaf names, config,
    corpus, frames and activation budget): each case's loss and every
    gradient leaf within VERIFY_LIMIT of the 2x1 step's and of the
    witness's; launches as each case's plan predicts (summed over the
    pods' shares); the first case run twice, the same bits; at it, both
    :data:`ENCDEC_SP_FAULTS` outside the limit. Each case's plan is made
    at its SP point; a pods case cuts the plan's pipeline in two
    (:func:`_split_pipelines`)."""
    import torch

    from repro_torch.core.schedule import get_schedule
    from repro_torch.models import EncDecLM
    from repro_torch.models.model import tree_leaves
    from repro_torch.runtime.encdec_pipeline import EncDecGeometry
    from repro_torch.runtime.train_step import EncDecTrainer, pod_plans
    ref, witness, names, cfg, corpus, frames, budget = base

    def against(r, want):
        worst, leaf = 0.0, 0
        for i, (a, b) in enumerate(zip(tree_leaves(r.grads),
                                       tree_leaves(want.grads))):
            x = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 1e-30)
            if x > worst:
                worst, leaf = x, i
        rel = abs(r.loss - want.loss) / abs(want.loss)
        return {"loss": r.loss, "loss_rel_diff": rel,
                "grad_max_rel_diff": worst,
                "grad_max_rel_diff_leaf": names[leaf],
                "within": rel <= VERIFY_LIMIT and worst <= VERIFY_LIMIT
                and r.n_valid == want.n_valid}
    out = {}
    for name, d_p, d_s, sched, mode, pods in ENCDEC_VERIFY_SP:
        _, _, _, cm, plan = _encdec_verify_plan(seed, d_p, sched, budget,
                                                dev, d_s)
        if pods > 1:
            plan = _split_pipelines(plan, pods)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = EncDecLM(cfg).init(gen, device=dev)
        geom = EncDecGeometry(d_p=d_p, schedule=sched,
                              split_bwd=get_schedule(sched, 1).split_bwd,
                              d_s=d_s, zero3_mode=mode)
        tr = EncDecTrainer(cfg, params, geometry=geom, cards=[dev],
                           compute_dtype=torch.float32, cost_model=cm,
                           n_pods=pods)
        del params
        subs = [sub for sub in pod_plans(plan, pods) if sub.pipelines]
        per_pod = [_expected_encdec_launches(cfg, sub, d_p, torch.float32,
                                             n_sm, d_s=d_s) for sub in subs]
        expected = [{k: sum(e[p][k] for e in per_pod) for k in per_pod[0][p]}
                    for p in range(d_p)]
        ctr = _train_counters()
        tally = {}
        _zero_counts(ctr)
        with _per_stage(ctr, tally):
            run = tr.loss_and_grads(plan, corpus, frames)
        _check_stage_launches(tally, expected, f"verify {name}")
        for t in tally.values():
            for k, n in t.items():
                totals[k] = totals.get(k, 0) + n
        rec = {"mesh": f"{d_p}x{d_s}", "schedule": sched, "zero3": mode,
               "pods": pods, "limit": VERIFY_LIMIT,
               "chunks": [[c.tokens for c in p.chunks]
                          for p in plan.pipelines],
               "remat_table": plan.ckpt_table(),
               "collective_bytes": run.pipeline["collective_bytes"],
               "memory_bytes": run.pipeline["memory_bytes"],
               "against 2x1": against(run, ref),
               "float64 witness": _against_float64(run, witness, names),
               "stage_launches": expected}
        w = rec["float64 witness"]
        if not rec["against 2x1"]["within"] or max(
                w["loss_rel_diff"], w["grad_max_rel_diff"]) > VERIFY_LIMIT:
            raise PhaseError(f"verify {name}: the step differs from the 2x1 "
                             f"step or the float64 witness: {rec}")
        if name == ENCDEC_VERIFY_SP[0][0]:
            again = tr.loss_and_grads(plan, corpus, frames)
            rec["bitwise_repeat"] = again.loss == run.loss and all(
                torch.equal(a, b) for a, b in zip(tree_leaves(again.grads),
                                                  tree_leaves(run.grads)))
            del again
            if not rec["bitwise_repeat"]:
                raise PhaseError(f"verify {name}: two runs differ: {rec}")
            for fault in ENCDEC_SP_FAULTS:
                with _encdec_sp_fault(fault):
                    rec[fault] = against(tr.loss_and_grads(
                        plan, corpus, frames), ref)
            caught = [f for f in ENCDEC_SP_FAULTS if rec[f]["within"]]
            if caught:
                raise PhaseError(f"verify {name}: the limit does not catch "
                                 f"{caught}: {rec}")
        out[name] = rec
        print(f"[train_verify_encdec] {name} {json.dumps(rec)}", flush=True)
        del run, tr
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the trainer's control plane: checkpoint and resume, elastic re-staging,
# online re-planning with the plan journal (gemma3-1b at full width, bf16)

RESTART_STEPS = 4       # 0-3 saving after 1 and 3; restore 1, run 2-3
# restart: gemma3-1b cut to 8 of its 26 layers (every width kept), so
# that the script fits its time with the ZeRO-3 and mesh-engine phases (at
# 1x1 the plan's estimate charges the tied head's states twice: no
# shallow-cut peak)
RESTART_LAYERS = 8
# elastic: gemma3-1b at full width and depth, 2 steps a phase; its 2x1
# phases pin a one-virtual-stage backend (the planner picks interleaved v
# = 13 there, and a checkpoint moves only between runs of one v: the
# reference's guard)
ELASTIC_STEPS, ELASTIC_SCHEDULE = 2, "zero-bubble-h1"
# gemma3-1b's layers in train_elastic: 13 of 26, to keep the script in
# its time (not fewer: its 2x1 steps' peaks are gated, and shallow 2x1
# cuts peak over the plan)
ELASTIC_LAYERS = 13
# re-planning: 2x1, gemma3-1b cut to 2 of 26 layers (every width kept) and
# batches of 8 x 4096 tokens so that four runs of 12 steps fit the time
# budget; the auto run's controller with a cooldown of 4 steps (default
# 8), so that a drift trigger can follow the bootstrap fit within the run
REPLAN_LAYERS, REPLAN_CONTEXT, REPLAN_STEPS, REPLAN_COOLDOWN = 2, 4096, 12, 4
REPLAN_STRAGGLER = "2:2.5@3"


def _scratch_dir(need_bytes, what):
    """A temporary directory under ``build/`` (ignored by git) with room for
    ``need_bytes``; the caller removes it."""
    import shutil
    import tempfile
    base = ROOT / "build"
    base.mkdir(exist_ok=True)
    free = shutil.disk_usage(base).free
    if free < need_bytes:
        raise PhaseError(f"{what}: {free / 1e9:.1f} GB free under {base}, "
                         f"{need_bytes / 1e9:.1f} GB needed (twice the "
                         f"checkpointed state)")
    return Path(tempfile.mkdtemp(prefix="ckpt-", dir=base))


def _snapshot(trainer):
    """The trainer's checkpoint tree copied to the host (pinned buffers,
    as ``CheckpointManager.save`` copies it), named."""
    from repro_torch.ckpt import host_copies, named_leaves
    named = named_leaves(trainer.state_tree())
    return list(zip([n for n, _ in named],
                    host_copies(x for _, x in named)))


def _state_diff(tree, snap, first_per_key=False):
    """Names of the leaves of the state ``tree`` whose bits differ from
    the snapshot ``snap``'s, each compared on its own device
    (``first_per_key``: at most one per top-level key: a planted fault
    needs no full read)."""
    import torch

    from repro_torch.ckpt import named_leaves
    named = named_leaves(tree)
    if [n for n, _ in named] != [n for n, _ in snap]:
        raise PhaseError("the state's leaves are not the snapshot's")
    bad, seen = [], set()
    for (n, x), (_, y) in zip(named, snap):
        key = n.split("/")[0]
        if first_per_key and key in seen:
            continue
        same = (torch.equal(x.detach(), y.to(x.device, non_blocking=True))
                if isinstance(y, torch.Tensor) else x == y)
        if not same:
            bad.append(n)
            seen.add(key)
    return bad


class _PathLaunches:
    """A control-plane phase's launches: the counts zeroed when it starts,
    each step's plan's expectation (all stages summed) added before the
    step; :meth:`check` reads the counts once the phase's runs ended."""

    def __init__(self, dev):
        import torch
        self.ctr = _train_counters()
        self.n_sm = torch.cuda.get_device_properties(
            dev).multi_processor_count
        self.expected = {}
        _zero_counts(self.ctr)

    def step(self, cfg, plan, d_p):
        import torch

        from repro_torch.runtime.train_step import remat_depths
        if d_p == 1:
            per = [_expected_launches(cfg, plan,
                                      remat_depths(plan, cfg.spec.n_layers))]
        else:
            per = _expected_stage_launches(cfg, plan, d_p, torch.bfloat16,
                                           self.n_sm, trainer_cm(d_p, cfg))
        for exp in per:
            for k, n in exp.items():
                self.expected[k] = self.expected.get(k, 0) + n

    def check(self, what):
        got = _read_counts(self.ctr)
        bad = {k: (got[k], n) for k, n in self.expected.items()
               if got[k] != n}
        if bad:
            raise PhaseError(f"{what}: launch counts differ from the plans' "
                             f"(got, expected): {bad}")
        idle = [k for k in ("flash_fwd_mma_kernel", "flash_bwd_tiles_kernel",
                            "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel",
                            "ce_fwd_mma_kernel", "ce_bwd_dh_mma_kernel",
                            "ce_bwd_dw_mma_kernel") if not got[k]]
        if idle:
            raise PhaseError(f"{what}: kernels of the path never launched: "
                             f"{idle}")
        return got


def _peak_over_plan(h):
    """A step's card peak minus its plan's estimate (GB)."""
    if "card_peak_mem_gb" in h:
        return h["card_peak_mem_gb"][0] - h["card_plan_mem_gb"][0]
    return h["peak_mem_gb"] - h["plan_peak_mem_gb"]


def _check_peaks(hist, what):
    for h in hist:
        if _peak_over_plan(h) > 0:
            raise PhaseError(f"{what}: step {h['step']}'s peak is "
                             f"{_peak_over_plan(h):.2f} GB above its plan's "
                             f"estimate: {_step_summary(h)}")


def _step_summary(h):
    keys = ("step", "loss", "tokens", "wall_s", "tokens_per_s",
            "peak_mem_gb", "plan_peak_mem_gb", "card_peak_mem_gb",
            "card_plan_mem_gb", "chunks", "solve_s")
    return {k: h[k] for k in keys if k in h}


def phase_train_restart(dev, seed):
    """gemma3-1b at full width and depth, bf16, ``--mesh 1x1`` on the train
    phase's batches: steps 0-3 uninterrupted with a checkpoint after step 1
    and one after step 3 (step 1's is written while steps 2-3 update the
    state in place; step 3's save reuses the pinned buffers); then a new
    trainer restored from step 1's checkpoint runs steps 2-3. Gates: step
    1's checkpoint, restored, equals the state step 2 started from bit for
    bit (parameters, master, m, v, step: a host copy still in flight when
    step 2 ran would hold its bits); steps 2-3 after the restore give the
    uninterrupted losses and final state bit for bit; a restore that keeps
    the new trainer's own master (from its bf16 parameters) and zero
    moments — the planted fault — fails the first gate."""
    import shutil

    import torch

    from repro_torch.launch.train import train
    from repro_torch.optim import init_opt_state
    from repro_torch.weights import OPT_KEYS
    cfg = _arch("gemma3-1b").with_layers(RESTART_LAYERS)
    launches = _PathLaunches(dev)
    lines, found = [], {}

    def on_step(step, plan, corpus, trainer):
        launches.step(cfg, plan, 1)
        if step == 2 and "saved" not in found:
            found["saved"] = _snapshot(trainer)

    def on_resume(tr, step):
        found["step"] = step
        found["restore"] = _state_diff(tr.state_tree(), found["saved"])
        # the planted fault: the new trainer's own AdamW state (master
        # from its bf16 parameters, zero moments) kept over the saved
        opt = init_opt_state(tr.params)
        fault = {"params": tr.params, "step": tr.opt["step"],
                 **{k: opt[k] for k in OPT_KEYS}}
        found["fault"] = _state_diff(fault, found["saved"], first_per_key=True)

    def run(**kw):
        loop = _train_loop(seed)
        loop.steps = RESTART_STEPS
        for k, v in kw.items():
            setattr(loop, k, v)
        trainer, hist = train(cfg, loop, device=dev, log=lines.append,
                              on_step=on_step, on_resume=on_resume)
        return trainer, hist

    # twice a checkpoint: bf16 parameters, float32 master, m and v
    tmp = _scratch_dir(2 * 14 * cfg.spec.param_count(), "train_restart")
    try:
        trainer, hist_a = run(ckpt_dir=str(tmp), ckpt_every=2)
        want = _snapshot(trainer)
        del trainer
        torch.cuda.empty_cache()
        # resume from step 1's checkpoint
        shutil.rmtree(tmp / f"step_{RESTART_STEPS - 1:08d}")
        trainer, hist_b = run(ckpt_dir=str(tmp), ckpt_every=RESTART_STEPS + 1,
                              resume=True)
        final = _state_diff(trainer.state_tree(), want)
        del trainer
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = launches.check("train_restart")
    for ln in lines:
        print(f"[train_restart] {ln}", flush=True)
    saves = [h["save"] for h in hist_a if "save" in h]
    losses_a = [h["loss"] for h in hist_a]
    losses_b = [h["loss"] for h in hist_a[:2] + hist_b]
    rec = {"checkpoint_gb": saves[0]["bytes"] / 1e9,
           "saves": [{"after_step": x["step"],
                      "blocking_s": x["blocking_s"], "write_s": x["write_s"],
                      "write_gb_per_s": x["bytes"] / 1e9 / x["write_s"]}
                     for x in saves],
           "restore_s": hist_b[-1]["checkpoint"]["restore_s"],
           "resumed_at": found.get("step"),
           "losses_uninterrupted": losses_a, "losses_resumed": losses_b,
           "restore_bitwise": found.get("restore") == [],
           "final_bitwise": final == [],
           "fault_leaves_differing": found.get("fault"),
           "steps": [_step_summary(h) for h in hist_a + hist_b]}
    if [x["step"] for x in saves] != [1, RESTART_STEPS - 1]:
        raise PhaseError(f"the uninterrupted run saved after steps "
                         f"{[x['step'] for x in saves]}: {rec}")
    if found.get("step") != 2:
        raise PhaseError(f"the resumed run started at {found.get('step')}, "
                         f"not step 2: {rec}")
    if found["restore"]:
        raise PhaseError(f"step 1's checkpoint differs from the state step 2 "
                         f"started from in {len(found['restore'])} leaves "
                         f"({found['restore'][:4]}): {rec}")
    keys = {n.split("/")[0] for n in found["fault"]}
    if not {"master", "m", "v"} <= keys:
        raise PhaseError(f"the planted fault (fresh master and moments) "
                         f"passed the restore gate: {rec}")
    if losses_b != losses_a or final:
        raise PhaseError(f"steps 2-3 after the restore are not the "
                         f"uninterrupted run's: losses {losses_b} against "
                         f"{losses_a}, {len(final)} leaves differ "
                         f"({final[:4]})")
    _check_peaks(hist_a + hist_b, "train_restart")
    return rec, counts


def phase_train_elastic(dev, seed):
    """``launch/elastic.run`` on one card: gemma3-1b at full width on
    :data:`ELASTIC_LAYERS` of its layers, bf16, the train phase's batches,
    2x1 -> 1x1 -> 2x1 (2x1 under
    :data:`ELASTIC_SCHEDULE`) with a shared checkpoint and telemetry
    directory,
    ``--replan observe`` with inline jobs. Gates: each restore, re-staged,
    equals the state saved bit for bit; the loss continues (the
    reference's check); the shrink phase has the ``elastic`` trigger, the
    grow phase none and a calibration of version >= 1; every peak at or
    under its plan's estimate; launches as the plans predict."""
    import shutil

    import torch

    from repro_torch.launch import elastic
    cfg = _arch("gemma3-1b").with_layers(ELASTIC_LAYERS)
    launches = _PathLaunches(dev)
    d_p = {name: n for name, n, _ in elastic.PHASES}
    prev = {"shrink": "phase 1", "grow": "shrink"}
    done, restored, lines = {}, {}, []

    def on_done(phase, tr):
        if phase in prev.values():      # the next phase compares with it
            done[phase] = _snapshot(tr)

    def on_resume(phase, tr, step):
        restored[phase] = (step, _state_diff(tr.state_tree(),
                                             done[prev[phase]]))
    # twice a checkpoint: bf16 parameters, float32 master, m and v
    tmp = _scratch_dir(2 * 14 * cfg.spec.param_count(), "train_elastic")
    try:
        hists = elastic.run(
            cfg, tmp, device=dev, steps=ELASTIC_STEPS, replan="observe",
            global_batch=TRAIN_BATCH, context=TRAIN_CONTEXT, seed=seed,
            compute_dtype="bfloat16", schedule=ELASTIC_SCHEDULE,
            log=lines.append, on_resume=on_resume, on_done=on_done,
            on_step=lambda ph, s, p, c, tr: launches.step(cfg, p, d_p[ph]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = launches.check("train_elastic")
    for ln in lines:
        print(f"[train_elastic] {ln}", flush=True)
    rec = {"layers": cfg.spec.n_layers, "schedule": ELASTIC_SCHEDULE,
           "restored": {ph: {"at_step": s, "leaves_differing": len(bad)}
                        for ph, (s, bad) in restored.items()},
           "replan": {ph: {k: h[-1]["replan"][k] for k in (
               "calibration_version", "triggers", "counters",
               "calibration_deltas")} for ph, h in hists.items()},
           "checkpoints": {ph: h[-1]["checkpoint"] for ph, h in
                           hists.items()},
           "steps": {ph: [_step_summary(x) for x in h]
                     for ph, h in hists.items()}}
    if sorted(restored) != ["grow", "shrink"] or any(
            bad for _, bad in restored.values()):
        raise PhaseError(f"a re-staged restore differs from the state "
                         f"saved: {rec['restored']}")
    for ph, h in hists.items():
        _check_peaks(h, f"train_elastic {ph}")
    torch.cuda.empty_cache()
    return rec, counts


def phase_train_replan(dev, seed):
    """gemma3-1b at full width on :data:`REPLAN_LAYERS` layers, 2x1 on one
    card, bf16, batches of 8 x :data:`REPLAN_CONTEXT`: four runs of
    :data:`REPLAN_STEPS` steps — ``--replan off``; ``--replan observe``;
    ``--replan auto --replan-sync --probe-every 1 --inject-straggler
    2:2.5@3 --telemetry-dir``; a ``--plan-journal`` replay of the auto
    run's ``plans.jsonl``. Gates: observe's losses and plans are off's
    bit for bit, the replay's the auto run's; no re-plan job failed;
    launches as the plans predict. Printed: trigger counts, swaps,
    hysteresis rejects, the adopted calibration's deltas from the copied
    cost model, and each run's largest step peak over its plan's estimate
    (not gated here: at 2 of 26 layers the planner's model charges about
    0.6 GB of activations where the step also holds the tied head's bf16
    weight gradient, 0.6 GB, which it does not charge; the full-depth
    phases gate their peaks)."""
    import shutil

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train
    from repro_torch.telemetry import read_jsonl
    cfg = get_arch("gemma3-1b").with_layers(REPLAN_LAYERS)
    launches = _PathLaunches(dev)
    tmp = _scratch_dir(0, "train_replan")
    runs, lines = {}, []
    modes = {
        "off": {},
        "observe": dict(replan="observe", replan_background=False,
                        telemetry_dir=str(tmp / "observe")),
        "auto": dict(replan="auto", replan_background=False, probe_every=1,
                     inject_straggler=REPLAN_STRAGGLER,
                     replan_cooldown=REPLAN_COOLDOWN,
                     telemetry_dir=str(tmp / "auto")),
        "replay": dict(plan_journal=str(tmp / "auto" / "plans.jsonl"))}
    try:
        for name, kw in modes.items():
            loop = _train_loop(seed)
            loop.steps, loop.d_p, loop.context = (REPLAN_STEPS, 2,
                                                  REPLAN_CONTEXT)
            for k, v in kw.items():
                setattr(loop, k, v)
            plans = []

            def on_step(step, plan, corpus, trainer):
                plans.append(plan.to_json())
                launches.step(cfg, plan, 2)
            trainer, hist = train(cfg, loop, device=dev, on_step=on_step,
                                  log=lambda s, n=name: lines.append(
                                      f"({n}) {s}"))
            del trainer
            torch.cuda.empty_cache()
            errors = [e for d in (tmp / name,) if d.exists()
                      for e in read_jsonl(d / "timeline-train.jsonl")
                      if e["kind"] == "replan" and e.get("phase") == "error"]
            runs[name] = {"losses": [h["loss"] for h in hist],
                          "plans": plans, "hist": hist, "errors": errors}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = launches.check("train_replan")
    for ln in lines:
        print(f"[train_replan] {ln}", flush=True)

    def same_plans(a, b):           # solve_time: the solver's own clock
        return [dict(p, solve_time=0) for p in a] == \
            [dict(p, solve_time=0) for p in b]
    rep = {n: runs[n]["hist"][-1].get("replan") for n in ("observe", "auto")}
    rec = {"layers": REPLAN_LAYERS, "context": REPLAN_CONTEXT,
           "steps": REPLAN_STEPS, "straggler": REPLAN_STRAGGLER,
           "cooldown": REPLAN_COOLDOWN,
           "observe_is_off": runs["observe"]["losses"] == runs["off"][
               "losses"] and same_plans(runs["observe"]["plans"],
                                        runs["off"]["plans"]),
           "replay_is_auto": runs["replay"]["losses"] == runs["auto"][
               "losses"] and runs["replay"]["plans"] == runs["auto"]["plans"],
           "replan_errors": {n: r["errors"] for n, r in runs.items()},
           **{f"{n}_{k}": r[k] for n, r in rep.items() for k in (
               "triggers", "counters", "swap_steps", "calibration_version",
               "calibration_deltas")},
           "auto_calibration": rep["auto"]["calibration"],
           "losses": {n: r["losses"] for n, r in runs.items()},
           "buckets": {n: sorted(r["hist"][-1]["telemetry"]["per_bucket"])
                       for n, r in runs.items()},
           "tokens_per_s": {n: [h["tokens_per_s"] for h in r["hist"]]
                            for n, r in runs.items()},
           "peak_over_plan_gb": {n: max(_peak_over_plan(h)
                                        for h in r["hist"])
                                 for n, r in runs.items()}}
    if not rec["observe_is_off"]:
        raise PhaseError(f"--replan observe changed the losses or plans: "
                         f"{rec}")
    if not rec["replay_is_auto"]:
        raise PhaseError(f"the journal replay is not the auto run: {rec}")
    if any(rec["replan_errors"].values()):
        raise PhaseError(f"a re-plan job failed: {rec['replan_errors']}")
    return rec, counts



# ---------------------------------------------------------------------------
# the sequence-parallel axis (runtime/sp.py, runtime/ep.py): kernel cases at
# a rank's shapes, train_sp, train_sp_ulysses, train_sp_hymba (bf16, the
# card's memory over the stages and their ranks) and train_sp_verify

# (arch, d_p, d_s, SP policy pin, SP degree pin); the depth: TRAIN_LAYERS;
# every stage's ranks own ZeRO-3 shards (per_tick, the CLI's, unless
# SP_LOOP says otherwise)
SP_RUNS = {"train_sp": ("gemma3-1b", 2, 2, "auto", 2),
           "train_sp_ulysses": ("qwen3-4b", 1, 4, "ulysses", 4),
           "train_sp_hymba": ("hymba-1.5b", 1, 2, "auto", 2),
           "train_sp_per_step": ("gemma3-1b", 2, 2, "auto", 2),
           "train_pods": ("gemma3-1b", 1, 2, "auto", 2)}
# a run's trainer settings beyond its mesh (launch/train.TrainConfig): the
# ZeRO-3 cadence, the pods (each planned with its share of the card)
SP_LOOP = {"train_sp_per_step": {"zero3_mode": "per_step"},
           "train_pods": {"n_pods": 2}}
SP_STEPS = 2


def _expected_sp_launches(cfg, plan, d_p, d_s, dtype, n_sm, cm,
                          policy="stage-aware"):
    """Each stage's launches in one step of ``plan`` on ``d_p`` stages of
    ``d_s`` SP ranks (``plan.sp``: the policy and ``d_eff`` ranks a replica
    group, ``r = d_s / d_eff`` groups): per layer, chunk and group
    ``d_eff`` attention forwards with their tile ranges (one a rank: the
    group's policy runs one op a rank), again per remat'd layer on group
    0; per layer and chunk ``d_eff`` of each backward pass, group 0 only
    (the replica groups feed no loss: autograd runs no backward for them);
    a merge pass where the bf16 forward splits a rank's keys
    (``flash_attention.kv_splits`` at the rank's query rows and heads);
    the selective scan ``2 d_eff - 1`` times a layer and group (a summary
    from a zero state on each rank but the last, then each rank from its
    folded state), its backward as the attention's; B, C1, C2 once per
    vocabulary block (``d_s``) and chunk on the last stage; no plain
    call."""
    import torch

    from repro_torch.core.schedule import get_schedule
    from repro_torch.kernels.flash_attention import BLOCK_KV, kv_splits
    from repro_torch.models.config import LayerKind
    from repro_torch.runtime.program import stage_programs
    from repro_torch.runtime.sharding import stage_blocks
    from repro_torch.runtime.sp import row_blocks
    from repro_torch.runtime.train_step import (ROW_MULTIPLE, _table,
                                                stage_remat)
    pol, d_eff = plan.sp.policy, plan.sp.d_s_eff
    rep = d_s // d_eff
    v = plan.v_stages
    blocks = stage_blocks(d_p, cfg.spec.n_layers, v)
    depths = stage_remat(plan, cfg.spec.n_layers, d_p, v, policy)
    table, base = _table(plan, d_p, policy), 0
    cm = cm.with_sp(pol, d_eff)
    for pipe in plan.pipelines:
        n = pipe.n_chunks
        programs = stage_programs(
            pipe, d_p, v=v, cm=cm, depths=[r[base:base + n] for r in table],
            split=get_schedule(plan.schedule, v).split_bwd)
        for p, prog in enumerate(programs):
            for a in prog:
                if a.remat:
                    depths[p][a.vstage][base + a.chunk] = \
                        len(blocks[p][a.vstage])
        base += n
    spec = cfg.spec
    heads = spec.n_heads // d_eff if pol == "ulysses" else spec.n_heads
    split = []
    for c in (c for pipe in plan.pipelines for c in pipe.chunks):
        q = ROW_MULTIPLE * d_eff
        rows = -(-c.tokens // q) * q
        T = rows if pol == "ulysses" else rows // d_eff
        S = -(-(c.context + rows) // BLOCK_KV) * BLOCK_KV
        split.append(dtype == torch.bfloat16 and
                     kv_splits(T, S, heads, n_sm) > 1)
    attn = cfg.layer_kind != LayerKind.MAMBA
    ssm = spec.ssm_state > 0
    n_ce = sum(1 for _, r in row_blocks(spec.vocab, d_s) if r)
    n_scan = 2 * d_eff - 1
    out = []
    for p in range(d_p):
        f = b = comb = 0
        for j in range(v):
            nl = len(blocks[p][j])
            for k in range(plan.n_chunks):
                fk = nl * rep + depths[p][j][k]
                f += fk
                b += nl
                comb += fk if split[k] else 0
        exp = _expected_launches(cfg, plan, [0] * plan.n_chunks, dtype)
        for k in exp:
            if k.startswith("plain"):
                continue
            if k.startswith("ce_"):
                exp[k] = n_ce * plan.n_chunks if exp[k] and p == d_p - 1 \
                    else 0
            elif k.startswith("mamba_scan"):
                bwd = k.startswith("mamba_scan_bwd") or \
                    k == "mamba_scan_reduce_kernel"
                exp[k] = n_scan * (b if bwd else f) if ssm else 0
            elif k in ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"):
                exp[k] = d_eff * b if attn else 0
            elif k == "flash_combine_kernel":
                exp[k] = d_eff * comb if attn else 0
            elif exp[k]:                    # the forward and its ranges
                exp[k] = d_eff * f if attn else 0
        out.append(exp)
    return out


def _sp_loop(seed, tag, **extra):
    arch, d_p, d_s, pol, deg = SP_RUNS[tag]
    loop = _train_loop(seed)
    loop.steps, loop.d_p, loop.d_s = SP_STEPS, d_p, d_s
    loop.sp_policy, loop.sp_degree = pol, deg
    for k, v in dict(SP_LOOP.get(tag, {}), **extra).items():
        setattr(loop, k, v)
    return _arch(arch), loop


def _sp_step0(seed, tag):
    """Step 0's plan of ``tag``'s run and its chunks as the step feeds
    them (:func:`_plan_chunks`), largest first."""
    from repro_torch.launch.train import plan_step
    cfg, loop = _sp_loop(seed, tag)
    cm = trainer_cm(loop.d_p, cfg, loop.d_s)
    corpus, plan = plan_step(cm, loop, 0)
    return cfg, plan, _plan_chunks(corpus, plan)


def phase_train_sp(dev, seed, tag, **extra):
    """``tag``'s run of :data:`SP_RUNS` through ``launch/train.train``
    (``--mesh PxS``, ``--sp-policy``, ``--sp-degree``; :data:`SP_LOOP`'s
    and ``extra``'s trainer settings): bf16, every stage and rank (and
    pod) on this card, each rank planned with the card's memory over the
    pods, stages and ranks, each rank owning its ZeRO-3 shards. Gates:
    finite losses; each stage's launches as the plan predicts
    (:func:`_expected_sp_launches`, summed over the pods' shares), no
    plain call; the card's peak at or under the sum of its ranks'
    estimates; each rank's owned state (its live parameters, float32
    gradient sums, AdamW master, m and v) at or under the planner's
    charge (``m_model_states``) plus its leaves kept whole on every rank
    and its share of the parameters the planner's count leaves out; the
    pods' parameters equal after the last step. Per step: tokens/s, the
    plan's SP point, the rows a rank gives kernel A and B, the
    collectives' bytes, the ZeRO-3 gathers and reduce-scatters and the
    most gathered bytes alive at once beside the largest layer's and the
    largest stage's gathered bytes."""
    import math

    import torch

    from repro_torch.launch.train import train
    from repro_torch.models.model import tree_leaves
    from repro_torch.runtime.train_step import pod_plans
    cfg, loop = _sp_loop(seed, tag, **extra)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    cm = trainer_cm(loop.d_p, cfg, loop.d_s, loop.n_pods)
    ctr = _train_counters()
    tally, expected, lines, totals = {}, [], [], {}

    def fold():
        for t in tally.values():
            for k, n in t.items():
                totals[k] = totals.get(k, 0) + n

    def on_step(step, plan, corpus, trainer):
        if expected:
            _check_stage_launches(tally, expected[-1], f"{tag} step "
                                                       f"{step - 1}")
        per_pod = [_expected_sp_launches(cfg, sub, loop.d_p, loop.d_s,
                                         torch.bfloat16, n_sm, cm)
                   for sub in pod_plans(plan, loop.n_pods) if sub.pipelines]
        expected.append([{k: sum(e[p][k] for e in per_pod) for k in
                          per_pod[0][p]} for p in range(loop.d_p)])
        fold()
        tally.clear()
        _zero_counts(ctr)
    with _per_stage(ctr, tally):
        trainer, hist = train(cfg, loop, device=dev, on_step=on_step,
                              log=lines.append)
    _check_stage_launches(tally, expected[-1], f"{tag} last step")
    fold()
    for ln in lines:
        print(f"[{tag}] {ln}", flush=True)
    el = torch.tensor([], dtype=trainer.dtype).element_size()
    gathered = [[sum(sum(t.numel() for t in leaf.shards) * el
                     for leaf in tree_leaves(lp)
                     if leaf.spec.gathered and not leaf.spec.whole)
                 for lp in st.zero3.leaves.values()]
                for st in trainer.stages]
    recs = []
    for h in hist:
        rec = {k: h[k] for k in (
            "step", "loss", "tokens", "wall_s", "tokens_per_s", "chunks",
            "remat_layers", "sp_policy", "d_s_eff", "d_s",
            "attn_rows_per_rank", "ce_rows_per_rank", "collectives",
            "collective_bytes", "card_peak_mem_gb", "card_plan_mem_gb",
            "stage_plan_mem_gb", "solve_s", "zero3_mode", "gathers",
            "regathers")}
        gb = lambda b: b / 1e9  # noqa: E731
        rec.update(
            rank_state_gb=[[gb(b) for b in st]
                           for st in h["rank_state_bytes"]],
            rank_charge_gb=[gb(b) for b in h["rank_charge_bytes"]],
            whole_state_gb=[[gb(b) for b in st]
                            for st in h["whole_state_bytes"]],
            uncounted_state_gb=gb(h["uncounted_state_bytes"]),
            gather_gb=gb(h["gather_bytes"]),
            scatter_gb=gb(h["scatter_bytes"]),
            gathered_peak_gb=gb(h["gathered_peak_bytes"]),
            largest_layer_gathered_gb=gb(max(max(g) for g in gathered)),
            largest_stage_gathered_gb=gb(max(sum(g) for g in gathered)),
            arch=cfg.name, layers=cfg.spec.n_layers,
            mesh=f"{loop.d_p}x{loop.d_s}")
        for k in ("n_pods", "compress_pod_grads", "pod_chunks",
                  "pod_n_valid"):
            if k in h:
                rec[k] = h[k]
        recs.append(rec)
        if not math.isfinite(h["loss"]):
            raise PhaseError(f"{tag}: non-finite loss: {rec}")
        if h["card_peak_mem_gb"][0] > h["card_plan_mem_gb"][0]:
            raise PhaseError(
                f"{tag}: the card's peak {h['card_peak_mem_gb'][0]} GB is "
                f"above the sum of its ranks' estimates "
                f"{h['card_plan_mem_gb'][0]} GB: {rec}")
        for p, (own, whole) in enumerate(zip(h["rank_state_bytes"],
                                             h["whole_state_bytes"])):
            for r, (o, w) in enumerate(zip(own, whole)):
                limit = h["rank_charge_bytes"][p] + w + \
                    h["uncounted_state_bytes"]
                if o > limit:
                    raise PhaseError(
                        f"{tag}: stage {p} rank {r} owns {o} bytes, over "
                        f"the planner's charge, its whole leaves and its "
                        f"share of the uncounted parameters ({limit}): "
                        f"{rec}")
    for pod in trainer.replicas:
        if not all(torch.equal(a, b) for a, b in zip(
                tree_leaves(trainer.params), tree_leaves(pod.params))):
            raise PhaseError(f"{tag}: the pods' parameters differ after "
                             f"the last step")
    del trainer
    torch.cuda.empty_cache()
    return recs, totals


def phase_train_pods(dev, seed):
    """``train_pods``: :func:`phase_train_sp` on 2 pods, :data:`SP_STEPS`
    steps with the plain all-reduce over the pods, then as many through
    the int8 one with error feedback (``compress_pod_grads``)."""
    recs, totals = [], {}
    for compress in (False, True):
        r, t = phase_train_sp(dev, seed, "train_pods",
                              compress_pod_grads=compress)
        recs += r
        for k, n in t.items():
            totals[k] = totals.get(k, 0) + n
    return recs, totals


def _sp_rank_inputs(seg, pos, ctx_len, r, d, Hq, Hkv, D, dev):
    """``inputs(gen, dtype)`` for kernel A and A′ as rank ``r`` of ``d``
    gives them under allgather_kv: its block of the chunk's rows as
    queries (its own positions), against the carry's ``ctx_len`` live
    rows and every rank's rows as keys."""
    import numpy as np
    import torch
    b = len(seg) // d
    q_seg, q_pos = seg[r * b:(r + 1) * b], pos[r * b:(r + 1) * b]
    kseg = np.concatenate([np.zeros(ctx_len, np.int32), seg])
    kpos = np.concatenate([np.arange(ctx_len, dtype=np.int32), pos])

    def inputs(gen, dtype):
        def mk(*shape):
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float32).to(dtype)
        meta = [torch.from_numpy(x).to(dev) for x in (q_seg, kseg, q_pos,
                                                       kpos)]
        S = len(kseg)
        return mk(b, Hq, D), mk(S, Hkv, D), mk(S, Hkv, D), mk(b, Hq, D), meta
    return inputs


def phase_kernel_sp(dev, seed):
    """The kernels at the shapes a rank gives them, each against its plain
    version (the cases' own tolerances, faults and bitwise repeats), bf16:
    kernel A and A′ as rank 1 of train_sp's step-0 chunk with the most
    context gives them under allgather_kv (its 1/2 of the chunk's rows at
    their positions, against the carry and the gathered rows; gemma3-1b
    global layer, 4 query heads, 1 KV head of 256), and as a rank of
    train_sp_ulysses gives them (every row of step 0's largest chunk, 8 of
    qwen3-4b's 32 query heads and 2 of its 8 KV heads, 128 wide); B, C1
    and C2 on hymba-1.5b's second vocabulary block (16,000 of 32,001 rows,
    offset 16,001) on train_sp_hymba's largest step-0 chunk's targets,
    most outside the block; the gated D and D′ on rank 1's block of that
    chunk (its first row continuing a sequence: a non-zero h0, dh0
    checked)."""
    import torch
    bf16 = torch.bfloat16
    recs = {}
    cfg, plan, chunks = _sp_step0(seed, "train_sp")
    chunk, _, seg, pos = max((c for c in chunks if c[0].context),
                             key=lambda c: c[0].context, default=chunks[0])
    d = plan.sp.d_s_eff
    b = len(seg) // d
    live = seg[b:] >= 0
    a0 = b + int(live.argmax())
    recs["allgather_kv"] = _attn_bwd_case(
        f"train_sp rank 1 of {d}: {b} of chunk ({chunk.tokens} tokens, carry "
        f"{chunk.context}) rows, global layer",
        _sp_rank_inputs(seg, pos, chunk.context, 1, d, 4, 1, 256, dev),
        slice(chunk.context + a0 - b, chunk.context + a0 - b + 32), 0, bf16,
        dev, 71, row_block=1024)
    print(f"[kernel_sp] attention backward "
          f"{json.dumps(recs['allgather_kv'])}", flush=True)
    torch.cuda.empty_cache()
    qcfg, qplan, qchunks = _sp_step0(seed, "train_sp_ulysses")
    qd = qplan.sp.d_s_eff
    qchunk, _, qseg, qpos = qchunks[0]
    s = qcfg.spec

    def ulysses_inputs(gen, dtype):
        return _plan_chunk(gen, qseg, qpos, s.n_heads // qd,
                           s.n_kv_heads // qd, s.head_dim, dtype, dev,
                           qchunk.context, qchunk.context)
    q0 = qchunk.context + int((qseg >= 0).argmax())
    recs["ulysses"] = _attn_bwd_case(
        f"train_sp_ulysses rank of {qd}: chunk ({qchunk.tokens} tokens), "
        f"{s.n_heads // qd} query / {s.n_kv_heads // qd} KV heads",
        ulysses_inputs, slice(q0 + 1024, q0 + 1056), 0, bf16, dev, 72,
        row_block=1024)
    print(f"[kernel_sp] attention backward {json.dumps(recs['ulysses'])}",
          flush=True)
    torch.cuda.empty_cache()
    hcfg, hplan, hchunks = _sp_step0(seed, "train_sp_hymba")
    hchunk, htgt, hseg, hpos = hchunks[0]
    from repro_torch.runtime.sp import row_blocks
    shard = row_blocks(hcfg.spec.vocab, hplan.sp.d_s_eff)[1]
    recs["ce"] = _ce_case(
        "hymba-1.5b", bf16, dev, 73, targets=torch.from_numpy(htgt),
        case=f"train_sp_hymba chunk ({hchunk.tokens} tokens), vocabulary "
             f"block {shard[1]} rows at {shard[0]}", shard=shard)
    for rec in recs["ce"].values():
        print(f"[kernel_sp] cross-entropy {json.dumps(rec)}", flush=True)
    torch.cuda.empty_cache()
    hb = len(hseg) // hplan.sp.d_s_eff
    recs["scan"] = _gated_scan_case(
        f"train_sp_hymba rank 1: rows {hb}-{len(hseg)} of chunk "
        f"({hchunk.tokens} tokens), gated, from a folded h0",
        hseg[hb:], hpos[hb:], 3200, 16, bf16, dev, 74)
    print(f"[kernel_sp] selective scan {json.dumps(recs['scan'])}",
          flush=True)
    torch.cuda.empty_cache()
    return recs


# train_sp_verify: (arch, d_s, policy, degree); each at full width and 2
# layers, in float32, the SP step against the whole-batch 1x1 step on the
# same plan's chunks; SP_VERIFY_FAULTS must each fall outside the limit
SP_VERIFY = (("gemma3-1b", 2, "allgather_kv", 2),
             ("gemma3-1b", 4, "allgather_kv", 2),
             ("qwen3-4b", 2, "ulysses", 2),
             ("hymba-1.5b", 2, "allgather_kv", 2),
             ("olmoe-1b-7b", 2, "ulysses", 2),
             ("deepseek-v2-lite", 2, "allgather_kv", 2))
SP_VERIFY_FAULTS = {"gemma3-1b": ("lse summed",),
                    "hymba-1.5b": ("halo from own rows",
                                   "fold skips a_prod")}
SP_VERIFY_LAYERS = 2
# the verify plans' memory budget: a rank's states and this (a remat table)
SP_VERIFY_MARGIN = 0.08e9


@contextlib.contextmanager
def _sp_fault(fault):
    """A planted sequence-parallel fault (undone on exit): "lse summed"
    adds the vocabulary blocks' log-sum-exps (``sp.merge_lse``); "fold
    skips a_prod" makes each rank's decay product 1 in the SSM fold
    (``ssm.shard_decay``); "halo from own rows" hands each rank its own
    last rows as its conv halo (``sp.make_sp_conv_tail_exchange``; a model
    made inside the block takes it)."""
    import torch

    from repro_torch.models import ssm
    from repro_torch.runtime import sp
    if fault == "lse summed":
        obj, name, new = sp, "merge_lse", lambda lses: lses.sum(0)
    elif fault == "fold skips a_prod":
        obj, name = ssm, "shard_decay"

        def new(p, dt_in, live, reset):
            return torch.ones_like(p["a_log"], dtype=torch.float32)
    elif fault == "halo from own rows":
        obj, name, real = sp, "make_sp_conv_tail_exchange", \
            sp.make_sp_conv_tail_exchange

        def new():
            exchange = real()

            def own_rows(xs, lives, resets, carried):
                _, tail = exchange(xs, lives, resets, carried)
                return [x[-carried.shape[0]:].to(carried.dtype)
                        for x in xs], tail
            return own_rows
    else:
        raise ValueError(f"unknown SP fault {fault!r}")
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _sp_pad_rank_mixer(dev, seed):
    """hymba-1.5b's mixer at full width in float32 on a chunk of 2 ranks
    whose pad rows fill the last rank (and part of the first): the SP
    mixer (the prefix scan from a folded state, the conv halo) against
    the unsharded one, both on the card, on the live rows' outputs, the
    state and tail handed on and every gradient; each SSM fault must fall
    outside the limit."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import DecoderLM, layer_params
    from repro_torch.models import ssm
    from repro_torch.runtime import sp
    cfg = get_arch("hymba-1.5b").with_layers(1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p0 = layer_params(DecoderLM(cfg).init(gen, device=dev), 0)["mamba"]
    s, T = cfg.spec, 1024
    seg = np.full(T, -1, np.int32)
    pos = np.zeros(T, np.int32)
    seg[:300], pos[:300] = 0, np.arange(300) + 700     # continues a carry
    seg[300:450], pos[300:450] = 1, np.arange(150)
    x = torch.randn((T, s.d_model), generator=gen, device=dev)
    h0 = torch.randn((s.inner, s.ssm_state), generator=gen, device=dev)
    tail = torch.randn((s.ssm_conv - 1, s.inner), generator=gen, device=dev)
    w = torch.randn((T, s.d_model), generator=gen, device=dev)
    w[torch.from_numpy(seg < 0).to(dev)] = 0.0
    segt, post = torch.from_numpy(seg).to(dev), torch.from_numpy(pos).to(dev)

    def run(d):
        p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
        xx, hh, tt = (t.clone().requires_grad_(True) for t in (x, h0, tail))
        if d is None:
            out, h, t = ssm.mamba_apply(cfg, p, xx, pos=post, seg=segt,
                                        state=hh, conv_tail=tt)
        else:
            outs, h, t = ssm.mamba_apply_sp(
                cfg, p, list(xx.split(T // d)), poss=list(post.split(T // d)),
                segs=list(segt.split(T // d)), state=hh, conv_tail=tt,
                scan_fn=sp.make_sp_ssm_scan(),
                tail_exchange=sp.make_sp_conv_tail_exchange())
            out = torch.cat(outs)
        ((out * w).sum() + h.sum() + t.sum()).backward()
        return [out[segt >= 0], h, t, xx.grad, hh.grad, tt.grad,
                *[p[k].grad for k in sorted(p)]]

    def worst(a, b):
        return max(float((x - y).detach().abs().max()) /
                   max(float(y.detach().abs().max()), 1e-30)
                   for x, y in zip(a, b))
    want = run(None)
    got = run(2)
    faults = {}
    for f in ("halo from own rows", "fold skips a_prod"):
        with _sp_fault(f):
            faults[f] = worst(run(2), want)
    rec = {"T": T, "live_rows": int((seg >= 0).sum()),
           "rank1_live_rows": int((seg[T // 2:] >= 0).sum()),
           "max_rel_diff": worst(got, want), "faults": faults}
    if rec["rank1_live_rows"] or rec["max_rel_diff"] > VERIFY_LIMIT:
        raise PhaseError(f"the SP mixer differs from the unsharded one on "
                         f"a chunk whose last rank is pad rows: {rec}")
    missed = [f for f, e in rec["faults"].items() if e <= VERIFY_LIMIT]
    if missed:
        raise PhaseError(f"the limit does not catch {missed}: {rec}")
    return rec


# ZeRO-3 in train_sp_verify: (arch, policy) over ZERO3_VERIFY_MESHES'
# (d_p, d_s, schedule), each in both modes, against the 1x1 step on the
# same chunks (2x2 under zero-bubble-h1: the split backward's W pass
# reduce-scatters each rank's product); ZERO3_NORM_CASE at d_s = 3, where
# hymba's widths (1,600, 6,400) divide by no dim of most leaves: they stay
# whole on every rank, and the step's norm must count each once
ZERO3_VERIFY = (("gemma3-1b", "allgather_kv"), ("hymba-1.5b", "allgather_kv"),
                ("olmoe-1b-7b", "ulysses"), ("deepseek-v2-lite",
                                             "allgather_kv"))
ZERO3_VERIFY_MESHES = ((1, 2, "gpipe-1f1b"), (2, 2, "zero-bubble-h1"),
                       (1, 4, "gpipe-1f1b"))
ZERO3_NORM_CASE = ("hymba-1.5b", 1, 3, "allgather_kv", "gpipe-1f1b")
ZERO3_FAULTS = ("gather in the wrong rank order", "reduce-scatter keeps own")
# the pods' cases: gemma3-1b 1x2 per_tick on 2 pods, on eight verify
# sequences (two pipelines: the pods take one each); the compressed sums'
# error feedback over POD_ROUNDS rounds of the same gradients
POD_VERIFY_LENS = [3000, 900, 500, 300, 2500, 1200, 800, 400]
POD_ROUNDS = 8


@contextlib.contextmanager
def _zero3_fault(fault):
    """A planted ZeRO-3 or pod fault (undone on exit), as
    ``tests/test_torch_zero3.zero3_fault``: "gather in the wrong rank
    order" concatenates a leaf's shards backwards
    (``sharding.gather_shards``); "reduce-scatter keeps own" gives each
    rank its block of its own product alone in the split backward's W pass
    (``pipeline.reduce_scatter_grads``); "norm counts whole leaves d_s
    times" gives every leaf the norm factor 1
    (``PipelineTrainer.norm_factors``); "error feedback dropped" quantises
    each round from a zero error (``compression.q8_psum``)."""
    import torch

    from repro_torch.optim import compression
    from repro_torch.runtime import pipeline, sharding
    from repro_torch.runtime.train_step import PipelineTrainer
    if fault == "gather in the wrong rank order":
        obj, name, real = sharding, "gather_shards", sharding.gather_shards

        def new(shards, dim):
            return real(list(shards)[::-1], dim)
    elif fault == "reduce-scatter keeps own":
        obj, name = pipeline, "reduce_scatter_grads"

        def new(contribs, leaf):
            if leaf.spec.whole:
                return sharding.reduce_scatter_grads(contribs, leaf)
            for r, acc in enumerate(leaf.accs):
                c = contribs[min(r, len(contribs) - 1)]
                acc.add_(c.split(list(leaf.spec.sizes), dim=leaf.spec.dim)[r])
    elif fault == "norm counts whole leaves d_s times":
        obj, name = PipelineTrainer, "norm_factors"

        def new(self, p):
            return [1.0] * len(self._leaf_specs(p))
    elif fault == "error feedback dropped":
        obj, name, real = compression, "q8_psum", compression.q8_psum

        def new(gs, errs):
            return real(gs, [torch.zeros_like(e) for e in errs])
    else:
        raise ValueError(f"unknown ZeRO-3 fault {fault!r}")
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _zero3_verify(dev, seed, ctr, n_sm, launches):
    """The ZeRO-3 and pod cases of ``train_sp_verify`` (float32, full
    width, :data:`SP_VERIFY_LAYERS` layers): :data:`ZERO3_VERIFY` over
    :data:`ZERO3_VERIFY_MESHES` in ``per_tick`` and ``per_step`` against
    the whole-batch 1x1 step on the same chunks (loss and every leaf within
    VERIFY_LIMIT), a repeat of each arch's 1x2 run in each mode bit for
    bit, launches as planned; :data:`ZERO3_FAULTS` on gemma3-1b's 2x2
    ``per_tick`` run and the whole-leaf norm fault on
    :data:`ZERO3_NORM_CASE` (its norm against the 1x1 gradients') outside
    the limit; 2 pods, plain, within the limit of the 1x1 step; 2 pods
    through the int8 all-reduce: every element within the quantisation
    bound ``n_pods * scale / 2`` of the plain sum, and over
    :data:`POD_ROUNDS` rounds of the same gradients with the errors fed
    back the cumulative sum within that bound of the plain one ("error
    feedback dropped" far outside)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import (ClusterSpec, CostModel, PlannerConfig,
                                  plan_batch)
    from repro_torch.models import DecoderLM
    from repro_torch.models.model import tree_leaves, unstack_layers
    from repro_torch.optim import global_norm
    from repro_torch.runtime.pipeline import PipelineGeometry
    from repro_torch.runtime.train_step import ChunkedTrainer, PipelineTrainer
    out = {}

    def plan_for(cfg, lens, d_p, d_s, pol, deg, sched):
        cm = CostModel(cfg.spec, ClusterSpec(d_p=d_p, d_s=d_s))
        budget = max(cm.with_sp(pol, deg).m_model_states(p)
                     for p in range(1, d_p + 1)) + SP_VERIFY_MARGIN
        plan = plan_batch(cm, lens, PlannerConfig(
            fixed_k=3, bucket_rounding=64, remat_mode="stage_aware",
            capacity_bytes=budget, sp_policy=pol, sp_degree=deg,
            schedule=sched))
        if max(sq.n_chunks for sq in plan.sequences) < 3:
            raise PhaseError(f"{cfg.name} {d_p}x{d_s}: the verify plan "
                             f"splits no sequence over 3 chunks")
        return cm, plan

    def compare(run, base, names):
        worst, leaf = 0.0, 0
        for i, (a, b) in enumerate(zip(tree_leaves(run.grads),
                                       tree_leaves(base.grads))):
            r = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            if r > worst:
                worst, leaf = r, i
        rel = abs(run.loss - base.loss) / abs(base.loss)
        return {"loss_rel_diff": rel, "grad_max_rel_diff": worst,
                "grad_max_rel_diff_leaf": names[leaf],
                "within": rel <= VERIFY_LIMIT and worst <= VERIFY_LIMIT
                and run.n_valid == base.n_valid}

    def count(tally):
        for t in tally.values():
            for k, n in t.items():
                launches[k] = launches.get(k, 0) + n

    n_arch, n_dp, n_ds, n_pol, n_sched = ZERO3_NORM_CASE
    cases = [(arch, pol, ZERO3_VERIFY_MESHES, False)
             for arch, pol in ZERO3_VERIFY]
    cases.append((n_arch, n_pol, ((n_dp, n_ds, n_sched),), True))
    for arch, pol, meshes, norm_case in cases:
        cfg = get_arch(arch).with_layers(SP_VERIFY_LAYERS)
        rng = np.random.default_rng(seed)
        lens = [3000, 900, 500, 300]
        corpus = {i: rng.integers(0, cfg.spec.vocab, n).astype(np.int32)
                  for i, n in enumerate(lens)}
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = DecoderLM(cfg).init(gen, device=dev)
        names = _leaf_names(unstack_layers(params))
        bases, recs = {}, {}
        for d_p, d_s, sched in meshes:
            deg = d_s
            cm, plan = plan_for(cfg, lens, d_p, d_s, pol, deg, sched)
            key = repr([(c.context, c.tokens, c.slices)
                        for pp in plan.pipelines for c in pp.chunks])
            if key not in bases:
                bases[key] = ChunkedTrainer(cfg, params, device=dev,
                                            compute_dtype=torch.float32
                                            ).loss_and_grads(plan, corpus)
            base = bases[key]
            for mode in ("per_tick", "per_step"):
                if norm_case and mode == "per_step":
                    continue
                geom = PipelineGeometry(
                    d_p=d_p, d_s=d_s, policy=pol, d_s_eff=deg,
                    schedule=sched, split_bwd=sched == "zero-bubble-h1",
                    zero3_mode=mode)

                def sp_run(count_it=False, norm=False):
                    tr = PipelineTrainer(cfg, params, geometry=geom,
                                         cards=[dev],
                                         compute_dtype=torch.float32,
                                         cost_model=cm)
                    tally = {}
                    _zero_counts(ctr)
                    with _per_stage(ctr, tally):
                        if norm:
                            res, accs = tr._step_grads(plan, corpus)
                            res.grad_norm = float(tr.grad_norm(accs))
                            res.grads = tr._model_layout(accs)
                            del accs
                        else:
                            res = tr.loss_and_grads(plan, corpus)
                    if count_it:
                        _check_stage_launches(tally, _expected_sp_launches(
                            cfg, plan, d_p, d_s, torch.float32, n_sm, cm),
                            f"train_sp_verify zero3 {arch} {d_p}x{d_s} "
                            f"{mode}")
                        count(tally)
                    del tr
                    return res
                first = sp_run(count_it=True, norm=norm_case)
                z = first.pipeline["zero3"]
                rec = {"sp": [plan.sp.policy, plan.sp.d_s_eff],
                       "schedule": plan.schedule,
                       "chunks": [(c.context, c.tokens)
                                  for pp in plan.pipelines
                                  for c in pp.chunks],
                       "remat_table": plan.ckpt_table(),
                       **compare(first, base, names),
                       "gather_gb": z["gather_bytes"] / 1e9,
                       "scatter_gb": z["scatter_bytes"] / 1e9,
                       "gathered_peak_gb": z["peak_live_bytes"] / 1e9,
                       "whole_leaves_gb": [[b / 20e9 for b in st] for st in
                                           z["whole_state_bytes"]]}
                if (d_p, d_s, mode) == (1, 2, "per_tick"):
                    again = sp_run()
                    rec["bitwise_repeat"] = first.loss == again.loss and all(
                        torch.equal(a, b) for a, b in zip(
                            tree_leaves(first.grads),
                            tree_leaves(again.grads)))
                    del again
                rec["faults"] = {}
                if norm_case:
                    want = float(global_norm(base.grads))
                    rec["grad_norm_rel_diff"] = abs(
                        first.grad_norm - want) / want
                    with _zero3_fault("norm counts whole leaves d_s times"):
                        bad = sp_run(norm=True)
                    rec["faults"]["norm counts whole leaves d_s times"] = {
                        "grad_norm_rel_diff": abs(bad.grad_norm - want) / want,
                        "within": abs(bad.grad_norm - want) / want
                        <= VERIFY_LIMIT}
                    rec["within"] = rec["within"] and \
                        rec["grad_norm_rel_diff"] <= VERIFY_LIMIT
                    del bad
                if (arch, d_p, d_s, mode) == ("gemma3-1b", 2, 2, "per_tick"):
                    for f in ZERO3_FAULTS:
                        with _zero3_fault(f):
                            bad = sp_run()
                        rec["faults"][f] = compare(bad, base, names)
                        del bad
                del first
                k = f"{arch} {d_p}x{d_s} {mode}"
                recs[k] = rec
                print(f"[train_sp_verify] zero3 {k} {json.dumps(rec)}",
                      flush=True)
                if not rec["within"] or not rec.get("bitwise_repeat", True):
                    raise PhaseError(f"zero3 {k}: the step differs from the "
                                     f"1x1 step: {rec}")
                missed = [f for f, r in rec["faults"].items() if r["within"]]
                if missed:
                    raise PhaseError(f"zero3 {k}: the limit does not catch "
                                     f"{missed}")
                torch.cuda.empty_cache()
        out.update(recs)
        del bases, params
        torch.cuda.empty_cache()
    out["pods"] = _pods_verify(dev, seed, ctr, n_sm, launches, compare)
    return out


def _pods_verify(dev, seed, ctr, n_sm, launches, compare):
    """The pods' cases of :func:`_zero3_verify`."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import (ClusterSpec, CostModel, PlannerConfig,
                                  plan_batch)
    from repro_torch.models import DecoderLM
    from repro_torch.models.model import unstack_layers
    from repro_torch.optim.compression import q8_scale
    from repro_torch.runtime.pipeline import PipelineGeometry
    from repro_torch.runtime.train_step import (ChunkedTrainer,
                                                PipelineTrainer, pod_plans)
    cfg = get_arch("gemma3-1b").with_layers(SP_VERIFY_LAYERS)
    rng = np.random.default_rng(seed)
    corpus = {i: rng.integers(0, cfg.spec.vocab, n).astype(np.int32)
              for i, n in enumerate(POD_VERIFY_LENS)}
    cm = CostModel(cfg.spec, ClusterSpec(d_s=2))
    plan = plan_batch(cm, POD_VERIFY_LENS, PlannerConfig(
        fixed_k=3, bucket_rounding=64, remat_mode="stage_aware",
        capacity_bytes=cm.with_sp("allgather_kv", 2).m_model_states(1)
        + SP_VERIFY_MARGIN, sp_policy="allgather_kv", sp_degree=2))
    subs = pod_plans(plan, 2)
    if not all(s.pipelines for s in subs):
        raise PhaseError(f"the pods' verify plan gives a pod no pipeline: "
                         f"{[p.n_chunks for p in plan.pipelines]}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = DecoderLM(cfg).init(gen, device=dev)
    names = _leaf_names(unstack_layers(params))
    base = ChunkedTrainer(cfg, params, device=dev,
                          compute_dtype=torch.float32
                          ).loss_and_grads(plan, corpus)
    geom = PipelineGeometry(d_p=1, d_s=2, policy="allgather_kv", d_s_eff=2)

    def trainer(compress):
        return PipelineTrainer(cfg, params, geometry=geom, cards=[dev],
                               compute_dtype=torch.float32, cost_model=cm,
                               n_pods=2, compress_pod_grads=compress)
    tr = trainer(False)
    tally = {}
    _zero_counts(ctr)
    with _per_stage(ctr, tally):
        plain = tr.loss_and_grads(plan, corpus)
    per_pod = [_expected_sp_launches(cfg, sub, 1, 2, torch.float32, n_sm,
                                     cm) for sub in subs]
    _check_stage_launches(tally, [{k: sum(e[0][k] for e in per_pod)
                                   for k in per_pod[0][0]}],
                          "train_sp_verify 2 pods")
    for t in tally.values():
        for k, n in t.items():
            launches[k] = launches.get(k, 0) + n
    rec = {"pod_chunks": plain.pipeline["pod_chunks"],
           "pipelines": [p.n_chunks for p in plan.pipelines],
           "plain": compare(plain, base, names)}
    del plain, tr
    # the compressed sums of the pods' gradient sums against their plain
    # sum, scaled as the step scales them (1 / n_valid)
    tr = trainer(True)
    runs = tr.pod_runs(plan, corpus)
    n_valid = sum(r.n_valid for r, _ in runs)
    accs = [a for _, a in runs]
    del runs

    def ratio(got, want, scales, rounds=1):
        worst = 0.0
        for gp, wp, sp in zip(got, want, scales):
            for g, w, s in zip(gp, wp, sp):
                if s > 1e-30:
                    worst = max(worst, float((g - rounds * w).abs().max())
                                / (2 * s / 2 / n_valid))
        return worst

    with torch.no_grad():
        want = [[(a0 + a1) / n_valid for a0, a1 in zip(p0, p1)]
                for p0, p1 in zip(*accs)]

        def rounds(n):
            """``n`` rounds of the same pods' sums through the trainer's
            compressed reduction (from a zero error state), summed; the
            last round's scales."""
            tr.err = None
            total, scales = None, None
            for _ in range(n):
                copy = [[[a.clone() for a in p] for p in pod]
                        for pod in accs]
                scales = [[float(q8_scale([c[p][i] for c in copy],
                                          [e[p][i] for e in tr.err]
                                          if tr.err else
                                          [torch.zeros_like(copy[0][p][i])]
                                          * 2))
                           for i in range(len(copy[0][p]))]
                          for p in range(len(copy[0]))]
                got = tr.reduce_pods(copy, n_valid)
                total = got if total is None else [
                    [t + g for t, g in zip(tp, gp)]
                    for tp, gp in zip(total, got)]
                del copy, got
            return total, scales
        one, s1 = rounds(1)
        rec["compressed_over_bound"] = ratio(one, want, s1)
        # the quantisation error itself: the largest element's, and the
        # largest leaf's relative to its largest plain value
        rec["compressed_max_abs_err"] = max(
            float((g - w).abs().max()) for gp, wp in zip(one, want)
            for g, w in zip(gp, wp))
        rec["compressed_max_rel_err"] = max(
            float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for gp, wp in zip(one, want) for g, w in zip(gp, wp))
        rec["bound_max"] = max(2 * s / 2 / n_valid for sp in s1 for s in sp)
        del one
        many, sn = rounds(POD_ROUNDS)
        rec["error_feedback_over_bound"] = ratio(many, want, sn, POD_ROUNDS)
        del many
        with _zero3_fault("error feedback dropped"):
            bad, sb = rounds(POD_ROUNDS)
        rec["faults"] = {"error feedback dropped": {
            "over_bound": ratio(bad, want, sb, POD_ROUNDS)}}
        del bad
    rec["n_pods"], rec["rounds"] = 2, POD_ROUNDS
    print(f"[train_sp_verify] pods {json.dumps(rec)}", flush=True)
    # (1e-4 of the bound: the float32 rounding of the scale and of 1 / n)
    if not rec["plain"]["within"] or rec["compressed_over_bound"] > 1.0001 \
            or rec["error_feedback_over_bound"] > 1.0001:
        raise PhaseError(f"the pods' sums differ from the 1x1 step or "
                         f"leave the quantisation bound: {rec}")
    if rec["faults"]["error feedback dropped"]["over_bound"] <= 2:
        raise PhaseError(f"the bound does not catch a dropped error "
                         f"feedback: {rec}")
    del tr, accs, base, params
    torch.cuda.empty_cache()
    return rec


def phase_train_sp_verify(dev, seed):
    """float32, full width, :data:`SP_VERIFY_LAYERS` layers: for each case
    of :data:`SP_VERIFY`, the SP step (``PipelineTrainer`` at ``1 x d_s``,
    the plan's SP point pinned; the verify phases' four sequences, one
    split over 3 chunks, a remat table from a tight budget) against the
    whole-batch 1x1 step (``ChunkedTrainer``) on the same plan's chunks:
    loss and every gradient leaf within VERIFY_LIMIT relative (each leaf
    to its largest value); two SP runs bit for bit; launches as the plan
    predicts; the planted faults of SP_VERIFY_FAULTS outside the limit;
    hymba's case also runs :func:`_sp_pad_rank_mixer`."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import (ClusterSpec, CostModel, PlannerConfig,
                                  plan_batch)
    from repro_torch.models import DecoderLM
    from repro_torch.models.model import tree_leaves, unstack_layers
    from repro_torch.runtime.pipeline import PipelineGeometry
    from repro_torch.runtime.train_step import ChunkedTrainer, PipelineTrainer
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ctr = _train_counters()
    out, launches = {}, {}
    for arch, d_s, pol, deg in SP_VERIFY:
        cfg = get_arch(arch).with_layers(SP_VERIFY_LAYERS)
        rng = np.random.default_rng(seed)
        lens = [3000, 900, 500, 300]
        corpus = {i: rng.integers(0, cfg.spec.vocab, n).astype(np.int32)
                  for i, n in enumerate(lens)}
        cm = CostModel(cfg.spec, ClusterSpec(d_s=d_s))
        budget = cm.with_sp(pol, deg).m_model_states(1) + SP_VERIFY_MARGIN
        plan = plan_batch(cm, lens, PlannerConfig(
            fixed_k=3, bucket_rounding=64, remat_mode="stage_aware",
            capacity_bytes=budget, sp_policy=pol, sp_degree=deg))
        if max(sq.n_chunks for sq in plan.sequences) < 3:
            raise PhaseError(f"{arch}: the verify plan splits no sequence "
                             f"over 3 chunks")
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = DecoderLM(cfg).init(gen, device=dev)
        names = _leaf_names(unstack_layers(params))
        base = ChunkedTrainer(cfg, params, device=dev,
                              compute_dtype=torch.float32
                              ).loss_and_grads(plan, corpus)
        geom = PipelineGeometry(d_p=1, d_s=d_s, policy=pol, d_s_eff=deg)

        def sp_run(count=False):
            tr = PipelineTrainer(cfg, params, geometry=geom, cards=[dev],
                                 compute_dtype=torch.float32, cost_model=cm)
            tally = {}
            _zero_counts(ctr)
            with _per_stage(ctr, tally):
                res = tr.loss_and_grads(plan, corpus)
            if count:
                _check_stage_launches(tally, _expected_sp_launches(
                    cfg, plan, 1, d_s, torch.float32, n_sm, cm),
                    f"train_sp_verify {arch} 1x{d_s}")
                for t in tally.values():
                    for k, n in t.items():
                        launches[k] = launches.get(k, 0) + n
            del tr
            return res

        def against_base(run):
            worst, leaf = 0.0, 0
            for i, (a, b) in enumerate(zip(tree_leaves(run.grads),
                                           tree_leaves(base.grads))):
                r = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                     1e-30)
                if r > worst:
                    worst, leaf = r, i
            rel = abs(run.loss - base.loss) / abs(base.loss)
            return {"loss_rel_diff": rel, "grad_max_rel_diff": worst,
                    "grad_max_rel_diff_leaf": names[leaf],
                    "within": rel <= VERIFY_LIMIT and worst <= VERIFY_LIMIT
                    and run.n_valid == base.n_valid}
        first = sp_run(count=True)
        rec = {"mesh": f"1x{d_s}", "sp": [plan.sp.policy, plan.sp.d_s_eff],
               "chunks": [(c.context, c.tokens) for p in plan.pipelines
                          for c in p.chunks],
               "remat_table": plan.ckpt_table(), "loss": base.loss,
               **against_base(first),
               "collective_bytes": first.pipeline["collective_bytes"]}
        again = sp_run()
        rec["bitwise_repeat"] = first.loss == again.loss and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(first.grads),
                                              tree_leaves(again.grads)))
        del first, again
        rec["faults"] = {}
        for f in SP_VERIFY_FAULTS.get(arch, ()):
            with _sp_fault(f):
                bad = sp_run()
            rec["faults"][f] = against_base(bad)
            del bad
        if arch == "hymba-1.5b":
            rec["pad_rank_mixer"] = _sp_pad_rank_mixer(dev, seed)
        key = f"{arch} 1x{d_s}" + (f" at {deg}" if deg != d_s else "")
        out[key] = rec
        print(f"[train_sp_verify] {key} {json.dumps(rec)}", flush=True)
        if not rec["within"] or not rec["bitwise_repeat"]:
            raise PhaseError(f"{key}: the SP step differs from the 1x1 "
                             f"step: {rec}")
        missed = [f for f, r in rec["faults"].items() if r["within"]]
        if missed:
            raise PhaseError(f"{key}: the limit does not catch {missed}")
        del base, params
        torch.cuda.empty_cache()
    out["zero3"] = _zero3_verify(dev, seed, ctr, n_sm, launches)
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# the pipelined prefill and fixed-batch decode: hymba-1.5b and
# falcon-mamba-7b at full width and depth, their float32 verify against the
# one-shot oracle, seamless-m4t-v2, and kernel A at a decode step's shapes
# ---------------------------------------------------------------------------

HYMBA, FALCON = "hymba-1.5b", "falcon-mamba-7b"
# bf16 decode: (prompts, prompt tokens, new tokens, meshes on the one card);
# 16 new tokens since PR 28 (32 before), to keep the script in its time
DECODE_RUNS = {HYMBA: (16, 1024, 16, ((1, 1), (2, 2))),
               FALCON: (8, 1024, 16, ((1, 1),))}
# the float32 verify: (prompts, new tokens, meshes); prompts of 1,024
DECODE_VERIFY = {HYMBA: (2, 8, ((1, 1), (2, 2))), FALCON: (2, 8, ((1, 1),))}
# seamless-m4t-v2: requests, prompt tokens, frames, new tokens, meshes
ENCDEC_DECODE = (2, 256, 512, 8, ((1, 1), (2, 2)))


def _decode_prompts(vocab, n, length):
    """``n`` prompts of ``length`` tokens: the first ``n`` prompts of the
    "github" request trace (seed 0) at least that long, cut to it."""
    from repro_torch.data import sample_request_trace
    trace = sample_request_trace("github", 8 * n, 4096, vocab, seed=0,
                                 max_new_tokens=32)
    out = [[int(t) for t in r["prompt"][:length]] for r in trace
           if len(r["prompt"]) >= length][:n]
    if len(out) < n:
        raise PhaseError(f"the trace has {len(out)} prompts of {length} "
                         f"tokens, not {n}")
    return out


def _decode_expected(cfg, geom, dtype, prompt, steps, n_sm, sp_prefill,
                     frames=0):
    """Launches of one ``DecodeStepBuilder``'s prefill (every prompt of
    ``prompt`` tokens in one chunk) and of its ``steps`` decode
    steps, as the code's shapes give them: per attention op the forward
    (and its tile ranges where the op computes them: always in decode,
    which keeps the lse; bf16 only in the prefill), the merge pass where
    ``kv_splits`` splits the keys; per mamba layer and chunk kernel D's
    three passes (on SP ranks ``2 d_s - 1`` scans: each rank's, and a
    summary from zero for every rank but the last); the encoder-decoder's
    encoder (non-causal over the frames) and cross-attention; no
    backward, no plain call."""
    from collections import Counter

    import torch

    from repro_torch.kernels.flash_attention import FWD_KERNELS, kv_splits
    from repro_torch.kernels.mamba_scan import mamba_scan_fwd_cuda
    s = cfg.spec
    L, d, B = s.n_layers, geom.d_s, geom.batch_per_pod
    bf16 = dtype == torch.bfloat16
    pad = lambda n: -(-n // 32) * 32  # noqa: E731
    pre, dec = Counter(), Counter()

    def att(c, T, S, n, tiles):
        c[FWD_KERNELS[dtype]] += n
        c["flash_bwd_tiles_kernel"] += n if tiles else 0
        c["flash_combine_kernel"] += n * (kv_splits(
            pad(T), pad(S), s.n_heads, n_sm, dtype) > 1)
    if s.is_encoder_decoder:
        att(pre, frames, frames, B * s.n_encoder_layers, bf16)
    T = prompt
    if not s.attn_free:
        if sp_prefill:
            b = -(-T // d)
            att(pre, b, d * b, B * L * d, bf16)
        else:
            att(pre, T, T, B * L, bf16)
    if s.is_encoder_decoder:
        att(pre, T, frames, B * L, bf16)
    if s.ssm_state > 0:
        for k in mamba_scan_fwd_cuda.KERNELS:
            pre[k] += B * L * ((2 * d - 1) if sp_prefill else 1)
    n = steps * geom.n_micro * L * d
    if not s.attn_free:
        att(dec, geom.bm, geom.bm * geom.s_loc, n, True)
    if s.is_encoder_decoder:
        s_mem_loc = -(-frames // d)
        att(dec, geom.bm, geom.bm * s_mem_loc, n, True)
    return pre, dec


def _check_launches(counts, expected, what):
    bad = {k: (counts.get(k, 0), expected.get(k, 0))
           for k in set(counts) | set(expected)
           if counts.get(k, 0) != expected.get(k, 0)}
    if bad:
        raise PhaseError(f"{what}: launch counts (got, expected): {bad}")


def _state_bytes(state):
    """Bytes the decode state's tensors hold (each storage once)."""
    import torch
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            key = x.untyped_storage().data_ptr()
            if key not in seen:
                seen.add(key)
                total += x.untyped_storage().nbytes()
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
    for v in state.values():
        walk(v)
    return total


def _decode_run(dev, cfg, params, prompts, new, mesh, dtype, ctr, n_sm,
                frames=None, fault=None, keep=None):
    """One ``DecodeStepBuilder`` at ``mesh`` over ``prompts``: prefill,
    then ``new - 1`` steps, each bracketed by ``torch.cuda.synchronize``.
    Returns the ids and the record (TTFT = the batch's prefill seconds,
    decode tokens/s and TPOT, peak memory, the state's bytes beside
    ``decode_state_bytes``, launches of each part against
    :func:`_decode_expected`, plain calls). ``fault(state)`` is applied
    after the prefill; ``keep(geom, state)`` sees the state after the last
    step."""
    import torch

    from repro_torch.runtime.serve_step import (DecodeStepBuilder,
                                                decode_state_bytes)
    d_p, d_s = mesh
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    b = DecodeStepBuilder(cfg, params, d_p=d_p, d_s=d_s, compute_dtype=dtype,
                          device=dev)
    _zero_counts(ctr)
    t0 = time.perf_counter()
    first, state = b.prefill(prompts, frames, max_new=new)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    pre = _read_counts(ctr)
    if fault is not None:
        fault(state)
    _zero_counts(ctr)
    ids = [[t] for t in first]
    t0 = time.perf_counter()
    for _ in range(new - 1):
        for o, t in zip(ids, b.step(state)):
            o.append(t)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    dec = _read_counts(ctr)
    steps = new - 1
    s_mem = None if frames is None else -(-frames[0].shape[0] // d_s) * d_s
    want_pre, want_dec = _decode_expected(
        cfg, b.geom, dtype, len(prompts[0]), steps, n_sm, b.sp_prefill,
        0 if frames is None else frames[0].shape[0])
    rec = dict(mesh=f"{d_p}x{d_s}", dtype=_dtype_name(dtype),
               prompts=len(prompts), prompt_tokens=len(prompts[0]),
               new_tokens=new, n_micro=b.geom.n_micro, bm=b.geom.bm,
               s_loc=b.geom.s_loc, ttft_s=ttft, decode_s=dec_s,
               decode_tokens_per_s=len(prompts) * steps / dec_s,
               tpot_ms=1e3 * dec_s / steps,
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               allocated_before_gb=before / 1e9,
               state_bytes=_state_bytes(state),
               decode_state_bytes=decode_state_bytes(b.geom, cfg,
                                                     s_mem=s_mem),
               launches_prefill={k: v for k, v in pre.items() if v},
               launches_decode={k: v for k, v in dec.items() if v})
    if keep is not None:
        keep(b.geom, state)
    del b, state
    if any(not 0 <= t < cfg.spec.vocab for x in ids for t in x):
        raise PhaseError(f"ids outside the vocabulary: {rec}")
    plain = {k: pre[k] + dec[k] for k in pre if k.startswith("plain")}
    if any(plain.values()):
        raise PhaseError(f"plain calls on the card: {plain}; {rec}")
    if rec["state_bytes"] != rec["decode_state_bytes"]:
        raise PhaseError(f"the state holds {rec['state_bytes']} bytes, "
                         f"decode_state_bytes says "
                         f"{rec['decode_state_bytes']}: {rec}")
    _check_launches(pre, want_pre, f"prefill {rec}")
    _check_launches(dec, want_dec, f"decode {rec}")
    return ids, rec


def phase_decode(dev, arch, params):
    """``arch`` in bf16 at full width and depth (``params``: its weights in
    bf16) through the pipelined prefill and decode at each of its
    ``DECODE_RUNS`` meshes on the one card. Gates: every id in the
    vocabulary, no plain call, the state's bytes as ``decode_state_bytes``,
    launches as :func:`_decode_expected`. Returns the records and each
    mesh's launches (prefill and decode together)."""
    import torch
    cfg = _arch(arch)
    n, length, new, meshes = DECODE_RUNS[arch]
    prompts = _decode_prompts(cfg.spec.vocab, n, length)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ctr = _train_counters()
    recs, counts = [], {}
    for mesh in meshes:
        _, rec = _decode_run(dev, cfg, params, prompts, new, mesh,
                             torch.bfloat16, ctr, n_sm)
        rec["layers"] = cfg.spec.n_layers
        recs.append(rec)
        counts[rec["mesh"]] = {k: rec["launches_prefill"].get(k, 0)
                               + rec["launches_decode"].get(k, 0)
                               for k in ctr}
        torch.cuda.empty_cache()
    return recs, counts


def _attention_dropped():
    """The reference's residual (``decode_step_fn`` never adds its
    attention output): the attention runs and writes its cache row, and
    the layer gets zeros from it."""
    import contextlib

    from repro_torch.runtime import serve_step
    orig = serve_step.decode_attention

    @contextlib.contextmanager
    def patched():
        serve_step.decode_attention = \
            lambda *a, **k: orig(*a, **k).mul_(0)
        try:
            yield
        finally:
            serve_step.decode_attention = orig
    return patched()


def _swap_ssm_states(state):
    """Sequences 0 and 1 of microbatch 0 exchange their SSM states in
    every layer (the tokens stay)."""
    for stage in state["ssm_h"]:
        for blk in stage:
            blk[0, :, [0, 1]] = blk[0, :, [1, 0]]


# the decode state after the last step against ``forward_chunk``'s carry
# over each sequence: the largest difference over the largest magnitude of
# each field and layer (float32)
DECODE_STATE_LIMIT = 1e-3


def _state_error(cfg, params32, prompts, ids, geom, state, dev):
    """The largest error of the decode state (KV rows, SSM state and conv
    tail of every layer and sequence) against the carry of
    ``DecoderLM.forward_chunk`` over the sequence it holds (the prompt and
    every id but the last, teacher-forced), each field's difference over
    its largest magnitude."""
    import torch

    from repro_torch.models import DecoderLM
    model, L_s, worst = DecoderLM(cfg), geom.layers_per_stage, 0.0
    for i, (prompt, got) in enumerate(zip(prompts, ids)):
        seq = list(prompt) + list(got[:-1])
        n = len(seq)
        with torch.no_grad():
            _, ctx = model.forward_chunk(
                params32, torch.tensor(seq, device=dev),
                torch.zeros(n, dtype=torch.int32, device=dev),
                torch.arange(n, dtype=torch.int32, device=dev),
                ctx=model.init_ctx(n, torch.float32, device=dev),
                compute_dtype=torch.float32)
        m, b = divmod(i, geom.bm)
        for layer in range(cfg.spec.n_layers):
            p, l = divmod(layer, L_s)
            for key, want, dim in (("cache_k", ctx.k, 0),
                                   ("cache_v", ctx.v, 0),
                                   ("ssm_h", ctx.ssm_h, 0),
                                   ("conv_tail", ctx.ssm_tail, 1)):
                if key not in state:
                    continue
                got_f = torch.cat([r[m, l, b] for r in state[key][p]],
                                  dim=dim)
                w = want[layer]
                if key.startswith("cache"):
                    got_f = got_f[:n]
                err = float((got_f.float() - w.float()).abs().max())
                worst = max(worst, err / max(float(w.abs().max()), 1e-30))
    return worst


def phase_decode_verify(dev, arch, params32):
    """float32 at full width and depth: ``DECODE_VERIFY[arch]`` prompts of
    1,024 tokens at each mesh, held to the port's ``one_shot_generate``
    (``DecoderLM.forward_chunk`` over prompt and ids, a whole forward a
    token) under ``verify_against_one_shot``'s near-tie rule, and the
    state after the last step to ``forward_chunk``'s carry over the same
    sequences within ``DECODE_STATE_LIMIT`` (:func:`_state_error`; the
    ids alone barely see a mamba state: at these random weights its share
    of a layer's output is small beside the skip's); a planted fault
    (hymba: the reference's residual, the attention term dropped;
    falcon-mamba: two sequences' SSM states swapped) must fail them."""
    import torch

    from repro_torch.serve.engine import (one_shot_generate,
                                          verify_against_one_shot)
    cfg = _arch(arch)
    n, new, meshes = DECODE_VERIFY[arch]
    prompts = _decode_prompts(cfg.spec.vocab, n, 1024)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ctr = _train_counters()
    t0 = time.perf_counter()
    ref_ids = one_shot_generate(cfg, params32, prompts, new,
                                compute_dtype=torch.float32, device=dev)
    out = dict(arch=arch, layers=cfg.spec.n_layers, prompts=n,
               new_tokens=new, one_shot_s=time.perf_counter() - t0,
               runs=[])

    def check(ids):
        return verify_against_one_shot(cfg, params32, prompts, ids, new,
                                       compute_dtype=torch.float32,
                                       device=dev, reference=ref_ids)
    counts, held = {}, {}

    def keep(geom, state):
        held["geom"], held["state"] = geom, state

    def state_err(ids):
        err = _state_error(cfg, params32, prompts, ids, held["geom"],
                           held.pop("state"), dev)
        return err, err <= DECODE_STATE_LIMIT
    for mesh in meshes:
        ids, rec = _decode_run(dev, cfg, params32, prompts, new, mesh,
                               torch.float32, ctr, n_sm, keep=keep)
        ok, lines = check(ids)
        err, state_ok = state_err(ids)
        rec.update(ok=ok, lines=lines, state_rel_err=err,
                   state_limit=DECODE_STATE_LIMIT)
        out["runs"].append(rec)
        counts[rec["mesh"]] = {k: rec["launches_prefill"].get(k, 0)
                               + rec["launches_decode"].get(k, 0)
                               for k in ctr}
        if not (ok and state_ok):
            raise PhaseError(f"decode differs from the one-shot oracle: "
                             f"{rec}")
    if arch == HYMBA:
        fault, ctx, hook = "attention term dropped", _attention_dropped(), \
            None
    else:
        import contextlib
        fault, ctx, hook = "SSM states swapped", contextlib.nullcontext(), \
            _swap_ssm_states
    with ctx:
        ids, _ = _decode_run(dev, cfg, params32, prompts, new, (1, 1),
                             torch.float32, ctr, n_sm, fault=hook, keep=keep)
    ok, lines = check(ids)
    err, state_ok = state_err(ids)
    out["fault"] = dict(fault=fault, ids_caught=not ok,
                        state_rel_err=err, state_caught=not state_ok,
                        lines=lines)
    if ok and state_ok:
        raise PhaseError(f"the verify does not catch {fault!r}: {out}")
    return out, counts


def _encdec_one_shot(model, params, prompt, frames, new, dev):
    """The teacher-forced oracle of the encoder-decoder: its memory from
    ``EncDecLM.encode``, then per token ``EncDecLM.decode`` over the
    prompt and the ids so far, the final norm and the greedy head. Returns
    the ids and, per step, (top-1 minus top-2 logit, max |logit|)."""
    import torch

    from repro_torch.models.layers import rms_norm
    from repro_torch.runtime.serve_step import greedy_ids
    n = frames.shape[0]
    z = lambda k: torch.zeros(k, dtype=torch.int32, device=dev)  # noqa
    ar = lambda k: torch.arange(k, dtype=torch.int32, device=dev)  # noqa
    with torch.no_grad():
        mem = model.encode(params, frames.to(dev), z(n), ar(n))
        seq, ids, margins = list(prompt), [], []
        for _ in range(new):
            h = model.decode(params, torch.tensor(seq, device=dev),
                             z(len(seq)), ar(len(seq)), mem, z(n),
                             compute_dtype=torch.float32)
            h = rms_norm(h[-1:], params["final_norm"], model.cfg.rms_eps)
            logits = (h.float() @ params["embed"].float().T)[0]
            top = torch.topk(logits, 2).values
            margins.append((float(top[0] - top[1]),
                            float(logits.abs().max())))
            t = int(greedy_ids(h, params["embed"])[0])
            ids.append(t)
            seq.append(t)
    return ids, margins


def phase_decode_encdec(dev, seed):
    """seamless-m4t-v2 in float32 at full width and depth (24 + 24 layers):
    ``ENCDEC_DECODE`` requests with frames from the audio stub (a
    generator seeded with ``seed``), through the pipelined prefill (the
    encoder, then the decoder behind its KV carry) and decode (the
    cross-attention over the ranks' frame blocks) at each mesh, held to the
    teacher-forced encode and decode greedy under the near-tie rule."""
    import torch

    from repro_torch.models import EncDecLM
    from repro_torch.models.frontends import audio_frame_stub
    from repro_torch.serve.engine import NEAR_TIE
    cfg = _arch(SEAMLESS)
    n, length, n_frames, new, meshes = ENCDEC_DECODE
    prompts = _decode_prompts(cfg.spec.vocab, n, length)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = EncDecLM(cfg)
    params = model.init(gen, device=dev, dtype=torch.float32)
    frames = [audio_frame_stub(cfg, gen, n_frames, device=dev,
                               dtype=torch.float32) for _ in range(n)]
    oracle = [_encdec_one_shot(model, params, p, f, new, dev)
              for p, f in zip(prompts, frames)]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ctr = _train_counters()
    recs, counts = [], {}
    for mesh in meshes:
        ids, rec = _decode_run(dev, cfg, params, prompts, new, mesh,
                               torch.float32, ctr, n_sm, frames=frames)
        ok, lines = True, []
        for i, (got, (want, margins)) in enumerate(zip(ids, oracle)):
            j = next((t for t in range(new) if got[t] != want[t]), None)
            if j is None:
                lines.append(f"request {i}: {new} ids match")
                continue
            margin, scale = margins[j]
            tolerated = margin < NEAR_TIE * scale
            ok &= tolerated
            lines.append(f"request {i}: ids differ at {j} ({got[j]} vs "
                         f"{want[j]}); margin {margin:.3e} vs {NEAR_TIE:g}"
                         f" * {scale:.3e}: "
                         f"{'near-tie' if tolerated else 'MISMATCH'}")
        rec.update(frames=n_frames, layers=cfg.spec.n_layers
                   + cfg.spec.n_encoder_layers, ok=ok, lines=lines)
        recs.append(rec)
        counts[rec["mesh"]] = {k: rec["launches_prefill"].get(k, 0)
                               + rec["launches_decode"].get(k, 0)
                               for k in ctr}
        if not ok:
            raise PhaseError(f"decode differs from the oracle: {rec}")
    del params
    return recs, counts


def _decode_attn_case(name, Hq, Hkv, Dk, Dv, bm, s_loc, offset, length,
                      window, dtype, dev, seed):
    """Kernel A as one rank of a decode step runs it
    (``ops.attention_with_lse``): ``bm`` queries at position ``length``,
    one a sequence, against the rank's ``bm x s_loc`` cache rows whose
    global rows start at ``offset`` (:func:`_lse_case`). Faults: the
    causal limit one off, a window one off."""
    import torch

    from repro_torch.models.attention import decode_meta
    gen = torch.Generator(device=dev).manual_seed(seed)

    def mk(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    q, k, v = mk(bm, Hq, Dk), mk(bm * s_loc, Hkv, Dk), mk(bm * s_loc, Hkv,
                                                          Dv)
    seg_q, seg_kv, row = decode_meta(bm, s_loc, offset, dev)
    pos = torch.full((bm,), length, dtype=torch.int32, device=dev)
    args = dict(q=q, k=k, v=v, seg_q=seg_q, seg_kv=seg_kv, pos_q=pos,
                pos_kv=row, window=window)
    faults = {"causal off by one": dict(pos_q=pos - 1)}
    if window > 0:
        faults["window - 1"] = dict(window=window - 1)
    return _lse_case(name, args, faults, dtype, dev,
                     length=length, rows_offset=offset)


def _lse_case(name, args, faults, dtype, dev, **extra):
    """Kernel A with its log-sum-exp (``ops.attention_with_lse``, as a rank
    of a sequence-sharded cache runs it) on ``args`` against the plain
    attention and its lse; a query with no live key must give zeros and
    ``-inf``. ``faults``: changed arguments each of which must fall outside
    the tolerance (none where no key is live: nothing moves a zero
    output). Times: the op (tile ranges, forward, merge pass), the plain
    version, SDPA with the boolean mask; the bound: each input read once,
    the output and lse written once, against the live pairs' operations."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import kv_splits
    q, k, v = args["q"], args["k"], args["v"]
    seg_q, seg_kv = args["seg_q"], args["seg_kv"]
    pos, row, window = args["pos_q"], args["pos_kv"], args["window"]
    lse_args = {n: args[n] for n in ("q", "k", "seg_q", "seg_kv", "pos_q",
                                      "pos_kv", "window", "scale")
                if n in args}
    out, lse = ops.attention_with_lse(**args)
    want = ref.flash_attention_reference(**args)
    want_lse = ref.flash_attention_lse(**lse_args)
    max_err, ok = _within(out, want, dtype)
    live = torch.isfinite(want_lse)
    lse_err, lse_ok = _within(lse[live], want_lse[live], torch.float32) \
        if bool(live.any()) else (0.0, True)
    lse_ok &= bool(torch.equal(torch.isfinite(lse), live))
    again = [ops.attention_with_lse(**args) for _ in range(2)]
    bitwise = all(torch.equal(a, out) and torch.equal(b, lse)
                  for a, b in again)
    caught, missed = {}, []
    if bool(live.any()):
        for fault, change in faults.items():
            caught[fault], inside = _within(
                ops.attention_with_lse(**{**args, **change})[0], want, dtype)
            if inside:
                missed.append(fault)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    kernel_ms = _cuda_ms(lambda: ops.attention_with_lse(**args))
    plain_ms = _cuda_ms(lambda: (ref.flash_attention_reference(**args),
                                 ref.flash_attention_lse(**lse_args)),
                        iters=5, warmup=1)
    mask = ref.attention_mask(seg_q, seg_kv, pos, row, True, window)
    T, Hq, Dk = q.shape
    Hkv, Dv = k.shape[1], v.shape[2]
    G = Hq // Hkv
    ke = k.repeat_interleave(G, dim=1).transpose(0, 1)[None]
    ve = v.repeat_interleave(G, dim=1).transpose(0, 1)[None]
    qe = q.transpose(0, 1)[None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = _cuda_ms(lambda: sdpa(qe, ke, ve, attn_mask=mask,
                                       scale=args.get("scale")),
                          iters=5, warmup=1)
    pairs = int(mask.sum()) * Hq
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out, lse))
    nbytes += sum(t.numel() * 4 for t in (seg_q, seg_kv, pos, row))
    bound_ms, bound_by = _bound((2.0 * Dk + 2.0 * Dv) * pairs, nbytes, dtype)
    rec = dict(case=name, dtype=_dtype_name(dtype), T=T, S=k.shape[0],
               Hq=Hq, Hkv=Hkv, D=Dk, Dv=Dv, window=window, **extra,
               live_keys=int((seg_kv >= 0).sum()), live_pairs=pairs,
               n_split=kv_splits(-(-T // 32) * 32, k.shape[0], Hq, n_sm,
                                 dtype),
               max_abs_err=max_err, lse_max_abs_err=lse_err,
               tol=TOL[_dtype_name(dtype)], within_tol=ok and lse_ok,
               bitwise_repeat=bitwise, faults_max_abs_err=caught,
               faults_within_tol=missed, kernel_ms=kernel_ms,
               kernel_ms_is="the op: pad, tile ranges, forward with lse, "
                            "merge pass where n_split > 1",
               plain_ms=plain_ms, library_ms=library_ms,
               library_is="scaled_dot_product_attention forward, the same "
                          "boolean mask (GQA heads expanded beforehand)",
               bound_ms=bound_ms, bound_by=bound_by)
    del ke, ve, mask
    if not (ok and lse_ok):
        raise PhaseError(f"kernel disagrees with the plain version: {rec}")
    if not bitwise:
        raise PhaseError(f"two launches of the forward differ: {rec}")
    if missed:
        raise PhaseError(f"the tolerance does not catch {missed}: {rec}")
    return rec


def phase_kernel_decode(dev, seed):
    """Kernel A at a decode step's shapes: hymba-1.5b's 2x2 rank (8
    sequences x 576 rows, 25 / 5 heads of 64) in bf16, a rank with live
    rows and one without; deepseek-v2-lite's (192, 128) over generate's
    expanded latent rows (2 sequences x 576 rows, 16 heads); hymba's 1x1
    rank in float32 (the verify's)."""
    import torch
    bf, f32 = torch.bfloat16, torch.float32
    return [
        _decode_attn_case("hymba 2x2 rank 1 mid-decode", 25, 5, 64, 64, 8,
                          576, 576, 1040, 0, bf, dev, seed),
        _decode_attn_case("hymba 2x2 rank 1 no live row", 25, 5, 64, 64, 8,
                          576, 576, 1024 - 500, 0, bf, dev, seed + 1),
        _decode_attn_case("hymba 1x1 bm 16", 25, 5, 64, 64, 16, 1088, 0,
                          1040, 0, bf, dev, seed + 2),
        _decode_attn_case("deepseek (192, 128) bm 2", 16, 16, 192, 128, 2,
                          576, 0, 514, 0, bf, dev, seed + 3),
        _decode_attn_case("hymba 1x1 float32 bm 2", 25, 5, 64, 64, 2, 1088,
                          0, 1030, 0, f32, dev, seed + 4),
    ]


# ---------------------------------------------------------------------------
# serve_mesh / verify_mesh phases: the engine on the (d_p, d_s) mesh
# ---------------------------------------------------------------------------

# (d_p, d_s, requests of the serve trace, new tokens each): gemma3-1b and
# olmoe-1b-7b at full width and depth
MESH_SERVE = {"serve_mesh": (2, 2, 16, 32), "serve_mesh_moe": (1, 2, 8, 16)}
MESH_VERIFY = {"gemma3-1b": (2, 2), MOE: (1, 2)}
MESH_FAULTS = ("rank partial dropped", "page owner shifted by one rank")


def _reference_pool_share(cfg, geom):
    """One rank's bytes of the reference's ``engine_pool_struct``: K and V
    ``[d_p, L_s, n_pages + d_s, page_sz, Hkv, Dh]`` over ``d_p x d_s``
    ranks."""
    import torch
    s = cfg.spec
    el = torch.empty((), dtype=geom.compute_dtype).element_size()
    total = 2 * geom.d_p * geom.layers_per_stage * (geom.n_pages + geom.d_s) \
        * geom.page_sz * s.n_kv_heads * s.head_dim * el
    return total // (geom.d_p * geom.d_s)


@contextlib.contextmanager
def _watch_engine(d_s, calls, ranks):
    """While the engine runs: for each (rank, window), the arguments of its
    attention call with the most key rows (references only: the engine
    makes them anew for every call, rank by rank), and the ranks that
    hold a page of a request packed into a step (from the host's page
    tables)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import engine as E
    real_attn, real_pack, n = ops.attention_with_lse, E.pack_step, [0]

    def attn(q, k, v, seg_q, seg_kv, pos_q, pos_kv, **kw):
        key = (n[0] % d_s, kw["window"])
        n[0] += 1
        if key not in calls or k.shape[0] > calls[key]["k"].shape[0]:
            calls[key] = dict(q=q, k=k, v=v, seg_q=seg_q, seg_kv=seg_kv,
                              pos_q=pos_q, pos_kv=pos_kv, **kw)
        return real_attn(q, k, v, seg_q, seg_kv, pos_q, pos_kv, **kw)

    def pack(geom, segs, device):
        ranks.update(p // geom.n_pages_loc for sg in segs for p in sg.table)
        return real_pack(geom, segs, device)
    ops.attention_with_lse, E.pack_step = attn, pack
    try:
        yield
    finally:
        ops.attention_with_lse, E.pack_step = real_attn, real_pack


def phase_serve_mesh(dev, cfg, params, trace, d_p, d_s, new):
    """The engine on a ``d_p x d_s`` mesh of this card in bf16: the serve
    phase's trace (its first requests, ``new`` tokens each); every request
    completes; A's forward and its tile ranges launch once per rank, layer
    and step; no plain call; the pool's bytes per rank equal the
    reference's ``engine_pool_struct`` share, and every rank holds pages.
    Returns the record and the largest attention call of each (rank,
    window)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (FWD_KERNELS,
                                                     flash_attention_cuda,
                                                     flash_bwd_tiles_cuda,
                                                     flash_combine_cuda)
    from repro_torch.serve.engine import ServeEngine
    econf = _econf(trace, new)
    mesh = dict(d_p=d_p, d_s=d_s)
    warm = ServeEngine(cfg, econf, params=params, param_dtype=torch.bfloat16,
                       device=dev, **mesh)
    warm.run(_requests(trace[:1], max_new=2))
    del warm
    eng = ServeEngine(cfg, econf, params=params, param_dtype=torch.bfloat16,
                      device=dev, **mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mma = FWD_KERNELS[torch.bfloat16]
    flash_attention_cuda.launches = 0
    flash_attention_cuda.by_kernel[mma] = 0
    flash_combine_cuda.launches = 0
    flash_bwd_tiles_cuda.launches = 0
    ops.flash_attention.plain_calls = 0
    calls, ranks = {}, set()
    with _watch_engine(d_s, calls, ranks):
        results = eng.run(_requests(trace, max_new=new))
    st = eng.stats()
    pool = sum(t.numel() * t.element_size() for stages in
               eng.pool_state.values() for rk in stages for t in rk)
    want = cfg.spec.n_layers * d_s * st["steps"]
    rec = dict(arch=cfg.spec.name, mesh=st["mesh"],
               completed=st["completed"],
               requests=len(trace), steps=st["steps"],
               tokens_per_s=st["tokens_per_s"], wall_s=st["wall_s"],
               ttft_s_p50=st["ttft_s_p50"], ttft_s_p95=st["ttft_s_p95"],
               tpot_s_p50=st["tpot_s_p50"], tpot_s_p95=st["tpot_s_p95"],
               prefill_tokens_fed=st["prefill_tokens_fed"],
               emitted_tokens=st["emitted_tokens"],
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               n_pages=eng.geom.n_pages, n_pages_loc=eng.geom.n_pages_loc,
               pool_bytes_per_rank=st["pool_bytes_per_rank"],
               pool_bytes_allocated_per_rank=pool // (d_p * d_s),
               reference_pool_share=_reference_pool_share(cfg, eng.geom),
               ranks_with_pages=sorted(ranks),
               collective_bytes_per_step=st["collective_bytes_per_step"],
               kv_pool=st["kv_pool"],
               flash_launches=flash_attention_cuda.launches,
               flash_mma_launches=flash_attention_cuda.by_kernel[mma],
               flash_launches_expected=want,
               tile_range_launches=flash_bwd_tiles_cuda.launches,
               combine_launches=flash_combine_cuda.launches,
               plain_attention_calls=ops.flash_attention.plain_calls)
    bad = [r for r in results.values() if len(r.output_ids) != new]
    if st["completed"] != len(trace) or bad:
        raise PhaseError(f"not every request completed: {rec}")
    if not (rec["flash_launches"] == rec["flash_mma_launches"] == want
            == rec["tile_range_launches"]) or rec["plain_attention_calls"]:
        raise PhaseError(f"the mesh engine did not run on the kernel on "
                         f"every rank: {rec}")
    if not (rec["pool_bytes_per_rank"] == rec["pool_bytes_allocated_per_rank"]
            == rec["reference_pool_share"]):
        raise PhaseError(f"the pool is not the reference's layout: {rec}")
    if ranks != set(range(d_s)):
        raise PhaseError(f"not every rank held pages: {rec}")
    return rec, calls


def _engine_rank_cases(tag, calls, dtype, dev):
    """Kernel A with its lse at each (rank, window)'s largest call of a
    mesh engine run (:func:`_lse_case`): all the step's queries against
    the rank's resident rows (rank 0: and the step's own). Faults: the
    rank's first live key tile dropped; rank 0 (the step's rows) the
    causal limit one off; a windowed layer its window one off."""
    out = []
    for (r, w), args in sorted(calls.items()):
        seg_kv = args["seg_kv"]
        live = (seg_kv >= 0).nonzero()
        faults = {}
        if len(live):
            t0 = int(live[0]) // 32 * 32
            drop = seg_kv.clone()
            drop[t0:t0 + 32] = -2
            faults["one live key tile dropped"] = dict(seg_kv=drop)
        if r == 0:
            faults["causal off by one"] = dict(pos_q=args["pos_q"] - 1)
        if w > 0:
            faults["window - 1"] = dict(window=w - 1)
        out.append(_lse_case(f"{tag} rank {r} window {w}", args, faults,
                             dtype, dev, rank=r))
    return out


@contextlib.contextmanager
def _mesh_fault(fault):
    """A planted fault of the mesh engine: ``rank partial dropped`` (the
    last rank's partial left out of the log-sum-exp merge), ``page owner
    shifted by one rank`` (every rank reads its pool rows for the pages of
    the next rank, at the same local index; the writes stay right)."""
    import dataclasses

    from repro_torch.runtime import sp
    from repro_torch.serve import engine as E
    real_merge, real_pack = sp.merge_partials, E.pack_step

    def merge(outs, lses):
        return real_merge(outs[:-1], lses[:-1])

    def pack(geom, segs, device):
        b = real_pack(geom, segs, device)
        shift = [dataclasses.replace(sg, table=[
            (p + geom.n_pages_loc) % geom.n_pages for p in sg.table])
            for sg in segs]
        for rr, rs in zip(b.ranks, real_pack(geom, shift, device).ranks):
            rr.kv = rs.kv
        return b
    if fault == "rank partial dropped":
        sp.merge_partials = merge
    elif fault == "page owner shifted by one rank":
        E.pack_step = pack
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        sp.merge_partials, E.pack_step = real_merge, real_pack


MESH_ROW_LIMIT = 1e-4     # the mesh engine's pool rows against 1x1's
# a routed model's: a router pick whose top-k margin is under float32
# rounding (olmoe's smallest ~1e-7) flips between the 1x1 block and
# the ranks' (the flipped rows are counted) and moves its row's output;
# olmoe at 1x2 read 1.14e-2 with its ids equal, the faults ~1
MESH_ROW_LIMIT_MOE = 5e-2


def _serve_rows(eng, reqs, stop=None):
    """Serve ``reqs`` (all submitted at once) to the end; returns the ids,
    the step and each running request's committed K and V rows of every
    layer (``serve_step.read_rows``) after step ``stop``, or, without
    ``stop``, after the last step before any request finished."""
    import torch

    from repro_torch.runtime.serve_step import read_rows
    for r in reqs:
        eng.submit(r)
    snap = None
    while eng.n_active:
        eng.step()
        if eng.step_count == stop or (stop is None and not eng.results):
            snap = (eng.step_count, {
                st.req.req_id: torch.cat([read_rows(
                    eng.cfg_arch, eng.geom, eng.pool_state,
                    eng.pool.table_of(st.req.req_id), st.committed, name)
                    for name in ("cache_k", "cache_v")])
                for st in eng._running if st.committed})
    ids = [eng.results[r.req_id].output_ids for r in reqs]
    return ids, snap


def _rows_error(got, want):
    """The largest row difference over the largest magnitude, over the
    requests the two snapshots hold (the same ones, or inf)."""
    if got is None or got[0] != want[0] or got[1].keys() != want[1].keys():
        return float("inf")
    return max(float((got[1][r] - want[1][r]).abs().max()
                     / want[1][r].abs().max()) for r in want[1])


def phase_verify_mesh(dev, cfg, params32, trace, d_p, d_s):
    """The float32 engine at ``d_p x d_s`` on the first 2 requests of the
    serve trace (8 new tokens; the pool cut to the two requests' pages, so
    they spread over the ranks), gated twice: its ids against
    ``one_shot_generate`` under the near-tie rule, and its pool, every
    layer's committed rows of each running request after the last step
    before a request finishes, against the 1x1 engine's (within
    :data:`MESH_ROW_LIMIT` of their largest magnitude, a routed model's
    :data:`MESH_ROW_LIMIT_MOE`: at random weights attention over thousands
    of keys moves the ids little). Each planted
    fault of :data:`MESH_FAULTS` must fail the gate. Returns the report
    and the largest attention call of each (rank, window)."""
    import dataclasses

    import torch

    from repro_torch.serve.engine import (ServeEngine, one_shot_generate,
                                          verify_against_one_shot)
    sub = trace[:2]
    econf = _econf(sub, 8)
    econf = dataclasses.replace(econf, n_pages=2 * econf.pages_per_seq)
    prompts = [t["prompt"] for t in sub]
    want = one_shot_generate(cfg, params32, prompts, 8,
                             compute_dtype=torch.float32, device=dev)

    def engine(dp, ds):
        return ServeEngine(cfg, econf, params=params32,
                           param_dtype=torch.float32, device=dev, d_p=dp,
                           d_s=ds)
    routed = cfg.spec.n_experts > 0
    limit = MESH_ROW_LIMIT_MOE if routed else MESH_ROW_LIMIT

    @contextlib.contextmanager
    def picks(out, every):
        """Each routed call's expert sets (every ``every``-th: the ranks
        route the same gathered rows)."""
        from repro_torch.models import moe
        n = [0]

        def observe(router, logits, ids, sizes):
            if n[0] % every == 0:
                out.append(ids.sort(dim=1).values)
            n[0] += 1
        with moe.observe_router(observe if routed else None):
            yield
    picks_one, picks_mesh = [], []
    with picks(picks_one, 1):
        _, one = _serve_rows(engine(1, 1), _requests(sub, max_new=8))

    def serve(seen=None):
        with picks(seen if seen is not None else [], d_s):
            ids, rows = _serve_rows(engine(d_p, d_s),
                                    _requests(sub, max_new=8), stop=one[0])
        ok, lines = verify_against_one_shot(
            cfg, params32, prompts, ids, 8, compute_dtype=torch.float32,
            device=dev, reference=want)
        err = _rows_error(rows, one)
        return ok and err <= limit, lines, err
    calls, ranks = {}, set()
    with _watch_engine(d_s, calls, ranks):
        ok, lines, err = serve(picks_mesh)
    flips = sum(int((a != b).any(1).sum())
                for a, b in zip(picks_one, picks_mesh))
    if not ok:
        raise PhaseError(f"rows {err:.3e} (limit {limit:g}, flipped "
                         f"router rows {flips}); " + "; ".join(lines))
    if ranks != set(range(d_s)):
        raise PhaseError(f"the requests' pages sit on ranks {ranks} only")
    faults = {}
    for fault in MESH_FAULTS:
        with _mesh_fault(fault):
            passed, flines, ferr = serve()
        faults[fault] = {"rows_error": ferr, "ids": flines}
        if passed:
            raise PhaseError(f"planted fault {fault!r} passes the gate: "
                             f"rows {ferr:.3e}; " + "; ".join(flines))
    return {"arch": cfg.spec.name, "mesh": f"{d_p}x{d_s}", "lines": lines,
            "rows_step": one[0], "rows_error": err, "rows_limit": limit,
            "router_flipped_rows": flips if routed else None,
            "faults": faults}, calls


# ---------------------------------------------------------------------------
# the dry-run at production meshes, held against the card
# ---------------------------------------------------------------------------

# (arch, shape, two pods): each cell's units run on this card
DRYRUN_CELLS = (("hymba-1.5b", "train_4k", False),
                ("gemma3-1b", "decode_32k", True),
                ("seamless-m4t-v2", "train_4k", False))
# the card's peak against the trace's: the caching allocator's blocks
# beside the trace's 512-byte rounding
DRYRUN_PEAK_TOL = 0.10


def _unit_on_card(cell, unit) -> bool:
    """Every parameter of the unit's stage lies on the card."""
    from repro_torch.models.model import tree_leaves
    h = cell.holder
    trees = h.params[unit.stage] if hasattr(h, "params") else \
        h.stages[unit.stage]
    return all(t.is_cuda for t in tree_leaves(trees))


def phase_dryrun(dev, seed):
    """Each cell of DRYRUN_CELLS through the dry-run on meta, then each of
    its units built and run on this card against its trace (the five
    gates of the module docstring). Returns one record a unit and each
    unit's launch counts."""
    import gc

    import torch
    out, counts = [], {}
    for arch, shape, mp in DRYRUN_CELLS:
        out += _dryrun_cell(dev, seed, arch, shape, mp, counts)
        # (the cell's card tensors died with _dryrun_cell's frame)
        gc.collect()
        torch.cuda.empty_cache()
    return out, counts


def _dryrun_cell(dev, seed, arch, shape, mp, counts):
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.model import DecoderLM
    ctr = _train_counters()
    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, shape, mp)
    dry_s = time.perf_counter() - t0
    mem = rec["memory"]
    print(f"[dryrun] {dryrun.cell_tag(arch, shape, mp)} "
          + json.dumps({"plan": rec["plan"], "build_s": rec["build_s"],
                        "trace_s": rec["trace_s"], "dryrun_s": dry_s,
                        "memory": {k: mem[k] for k in mem
                                   if k != "plan_estimate_bytes"},
                        "flops": rec["flops"]}), flush=True)
    cfg = get_arch(arch)
    model = EncDecLM(cfg) if cfg.spec.is_encoder_decoder else DecoderLM(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(gen, device=dev, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    cell = dryrun.build_cell(arch, shape, mp, device=dev, params=params,
                             seed=seed)
    build_s = time.perf_counter() - t0
    del params
    if len(cell.units) != len(rec["units"]):
        raise PhaseError(f"{arch} {shape}: {len(cell.units)} units on the "
                         f"card, {len(rec['units'])} traced")
    out = []
    for unit, tr in zip(cell.units, rec["units"]):
        key = f"dryrun_{arch}_{shape}_{rec['mesh']}_stage{unit.stage}"
        _zero_counts(ctr)
        m = dryrun.measure_unit(unit)
        counts[key] = _read_counts(ctr)
        calls = {k: v["calls"] for k, v in tr["kernel_ops"].items()}
        peak, traced = m["peak_bytes"], tr["trace_peak_bytes"]
        gates = {
            "holding": unit.rank_bytes == tr["rank_bytes"]
            and _unit_on_card(cell, unit),
            "launches": m["launches"] == calls and not any(
                counts[key][k] for k in counts[key] if k.startswith("plain")),
            "collectives": m["collectives"] == tr["collectives"],
            "signature": m["signature"] == tr["signature"],
            "peak": abs(peak - traced) <= DRYRUN_PEAK_TOL * traced}
        r = {"cell": dryrun.cell_tag(arch, shape, mp), "unit": unit.name,
             "ranks": unit.ranks, "info": unit.info,
             "rank_bytes": sorted(set(unit.rank_bytes)),
             "peak_bytes": peak, "trace_peak_bytes": traced,
             "peak_over_trace": peak / traced,
             "allocated_before_bytes": m["base_bytes"],
             "requested_peak_bytes": m["requested_peak_bytes"],
             "launches": m["launches"], "trace_calls": calls,
             "kernel_ops": {k: v["ops"] for k, v in tr["kernel_ops"].items()},
             "flops": tr["flops"],
             "collectives": {k: v for k, v in m["collectives"].items()
                             if k != "zero3"},
             "zero3": m["collectives"].get("zero3"),
             "outputs": len(m["signature"]), "run_s": m["run_s"],
             "trace_s": tr["trace_s"], "build_s": build_s, "gates": gates}
        print(f"[dryrun] {json.dumps(r)}", flush=True)
        out.append(r)
        if not all(gates.values()):
            bad = [g for g, ok in gates.items() if not ok]
            diff = {"launches": (m["launches"], calls),
                    "collectives": (m["collectives"], tr["collectives"]),
                    "holding": (unit.rank_bytes[:2], tr["rank_bytes"][:2]),
                    "signature": [(a, b) for a, b in zip(
                        m["signature"], tr["signature"]) if a != b][:4]}
            raise PhaseError(f"{r['cell']} {unit.name}: gates {bad} failed: "
                             f"{json.dumps(diff)[:3000]}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False; chip_smoke.py "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import get_arch
        from repro_torch.data import sample_request_trace
        from repro_torch.kernels.build import load_libraries
        from repro_torch.kernels.mamba_scan import (mamba_scan_bwd_cuda,
                                                    mamba_scan_fwd_cuda)
        from repro_torch.models import DecoderLM
    except ImportError as e:
        print(f"error: the port is not importable from {ROOT / 'src'}: {e}",
              file=sys.stderr)
        return 3
    scan = mamba_scan_fwd_cuda.KERNELS + mamba_scan_bwd_cuda.KERNELS
    if SCAN_KERNELS != scan:
        print(f"error: SCAN_KERNELS {SCAN_KERNELS} are not the scan wrappers' "
              "KERNELS", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception:
            traceback.print_exc()
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s",
                  flush=True)
            raise SystemExit(1)
        return out, time.perf_counter() - t0

    smi, _ = run("build", _nvidia_smi)
    libs, dt = run("build", load_libraries)
    for b in libs.values():
        for ln in _ptxas_summary(b.build_log):
            print(f"[build] {ln}")
    spills = [ln for b in libs.values() for ln in _ptxas_summary(b.build_log)
              if ln.startswith(NO_SPILL)
              and not ln.endswith("0 bytes spill stores, 0 bytes spill loads")]
    if spills:
        print(f"[build] FAILED: tensor-core kernels spill: {spills}",
              flush=True)
        return 1
    print(f"[build] ok sm_90a {', '.join(b.path.name for b in libs.values())}"
          f" in {dt:.1f}s; card: {smi}", flush=True)

    # the dry-run at production meshes: each traced unit run on this card,
    # first, while nothing else holds memory (seamless-m4t-v2's decoder
    # stage peaks at 66 GB with its 16 ranks on the card)
    (dry, dryrun_counts), dt = run("dryrun", lambda: phase_dryrun(
        dev, args.seed))
    print(f"[dryrun] ok in {dt:.1f}s: {len(dry)} units", flush=True)

    (cases, merges), dt = run("kernel", lambda: phase_kernel(dev))
    for rec in cases:
        print(f"[kernel] {json.dumps(rec)}", flush=True)
    for rec in merges:
        print(f"[kernel] merge pass {json.dumps(rec)}", flush=True)
    (bwd, ce), dt2 = run("kernel", lambda: phase_kernel_training(
        dev, args.seed))
    (scan, gated, h_attn, h_ce), dt3 = run("kernel", lambda: phase_kernel_ssm(
        dev, args.seed))
    (moe_bwd, moe_ce), dt4 = run("kernel", lambda: phase_kernel_moe(
        dev, args.seed))
    print(f"[kernel] ok in {dt + dt2 + dt3 + dt4:.1f}s", flush=True)

    cfg = get_arch("gemma3-1b")
    trace = sample_request_trace("github", 16, 4096, cfg.spec.vocab,
                                 seed=0, max_new_tokens=32)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params32 = DecoderLM(cfg).init(gen, dtype=torch.float32, device=dev)
    ctr = _train_counters()
    _zero_counts(ctr)
    srv, dt = run("serve", lambda: phase_serve(dev, cfg, params32, trace))
    serve_counts = _read_counts(ctr)
    print(f"[serve] {json.dumps(srv)} in {dt:.1f}s", flush=True)

    lines, dt = run("verify", lambda: phase_verify(dev, cfg, params32,
                                                   trace))
    print(f"[verify] ok in {dt:.1f}s: " + "; ".join(lines), flush=True)

    # the engine on the (d_p, d_s) mesh: gemma3-1b at 2x2 on this card in
    # bf16, kernel A at each rank's largest call, the float32 engine
    # against the one-shot oracle with planted faults
    from repro_torch.models.model import tree_map
    d_p, d_s, n_req, new = MESH_SERVE["serve_mesh"]
    p16 = tree_map(lambda a: a.to(torch.bfloat16), params32)
    _zero_counts(ctr)
    (srv, calls), dt = run("serve_mesh", lambda: phase_serve_mesh(
        dev, cfg, p16, trace[:n_req], d_p, d_s, new))
    mesh_counts = {"serve_mesh": _read_counts(ctr)}
    print(f"[serve_mesh] {json.dumps(srv)} in {dt:.1f}s", flush=True)
    del p16
    mesh_k, dt = run("serve_mesh", lambda: _engine_rank_cases(
        f"gemma3-1b {d_p}x{d_s} engine", calls, torch.bfloat16, dev))
    for rec in mesh_k:
        print(f"[serve_mesh] kernel {json.dumps(rec)}", flush=True)
    print(f"[serve_mesh] kernel cases ok in {dt:.1f}s", flush=True)
    del calls
    torch.cuda.empty_cache()
    _zero_counts(ctr)
    d_p, d_s = MESH_VERIFY["gemma3-1b"]
    (ver, calls), dt = run("verify_mesh", lambda: phase_verify_mesh(
        dev, cfg, params32, trace, d_p, d_s))
    mesh_counts["verify_mesh"] = _read_counts(ctr)
    print(f"[verify_mesh] ok in {dt:.1f}s: {json.dumps(ver)}", flush=True)
    mesh_k32, dt = run("verify_mesh", lambda: _engine_rank_cases(
        f"gemma3-1b {d_p}x{d_s} engine float32", calls, torch.float32,
        dev))
    for rec in mesh_k32:
        print(f"[verify_mesh] kernel {json.dumps(rec)}", flush=True)
    print(f"[verify_mesh] kernel cases ok in {dt:.1f}s", flush=True)
    del params32, calls
    torch.cuda.empty_cache()

    trn, dt = run("train", lambda: phase_train(dev, args.seed))
    for rec in trn:
        print(f"[train] {json.dumps(rec)}", flush=True)
    print(f"[train] ok in {dt:.1f}s", flush=True)
    train_counts = {k: sum(r["launches"][k] for r in trn) for k in ctr}

    ver, dt = run("train_verify", lambda: phase_train_verify(dev, args.seed))
    print(f"[train_verify] ok in {dt:.1f}s: {json.dumps(ver)}", flush=True)
    verify_counts = ver["launches"]

    hym, dt = run("train_hymba", lambda: phase_train(dev, args.seed,
                                                     "hymba-1.5b"))
    for rec in hym:
        print(f"[train_hymba] {json.dumps(rec)}", flush=True)
    print(f"[train_hymba] ok in {dt:.1f}s", flush=True)
    hymba_counts = {k: sum(r["launches"][k] for r in hym) for k in ctr}

    ver, dt = run("train_verify_hymba", lambda: phase_train_verify_hymba(
        dev, args.seed))
    print(f"[train_verify_hymba] ok in {dt:.1f}s: {json.dumps(ver)}",
          flush=True)
    verify_hymba_counts = ver["launches"]

    (pip, pipe_counts), dt = run("train_pipeline", lambda:
                                 phase_train_pipeline(dev, args.seed))
    for rec in pip:
        print(f"[train_pipeline] {json.dumps(rec)}", flush=True)
    print(f"[train_pipeline] ok in {dt:.1f}s", flush=True)

    ver, dt = run("train_pipeline_verify", lambda:
                  phase_train_pipeline_verify(dev, args.seed))
    print(f"[train_pipeline_verify] ok in {dt:.1f}s: {json.dumps(ver)}",
          flush=True)
    pipe_verify_counts = ver["launches"]
    torch.cuda.empty_cache()

    # the MoE family: olmoe-1b-7b served at full width and depth, trained
    # at full width on TRAIN_LAYERS' depth
    moe_cfg = get_arch(MOE)
    moe_trace = sample_request_trace("github", 16, 4096, moe_cfg.spec.vocab,
                                     seed=0, max_new_tokens=32)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    moe32 = DecoderLM(moe_cfg).init(gen, dtype=torch.float32, device=dev)
    torch.cuda.empty_cache()
    _zero_counts(ctr)
    with _moe_watch() as watch:
        srv, dt = run("serve_moe", lambda: phase_serve(dev, moe_cfg, moe32,
                                                       moe_trace))
    serve_moe_counts = _read_counts(ctr)
    print(f"[serve_moe] {json.dumps(srv)} in {dt:.1f}s", flush=True)
    print(f"[serve_moe] moe {json.dumps(watch)}", flush=True)
    torch.cuda.empty_cache()
    with _moe_watch() as watch:
        lines, dt = run("verify_moe", lambda: phase_verify(
            dev, moe_cfg, moe32, moe_trace))
    print(f"[verify_moe] ok in {dt:.1f}s: " + "; ".join(lines), flush=True)
    print(f"[verify_moe] moe {json.dumps(watch)}", flush=True)
    # the MoE block's expert parallelism inside the mesh engine: olmoe at
    # 1x2, bf16 on a shorter trace, then float32 against the oracle
    d_p, d_s, n_req, new = MESH_SERVE["serve_mesh_moe"]
    moe16 = tree_map(lambda a: a.to(torch.bfloat16), moe32)
    _zero_counts(ctr)
    (srv, calls), dt = run("serve_mesh_moe", lambda: phase_serve_mesh(
        dev, moe_cfg, moe16, moe_trace[:n_req], d_p, d_s, new))
    mesh_counts["serve_mesh_moe"] = _read_counts(ctr)
    print(f"[serve_mesh_moe] {json.dumps(srv)} in {dt:.1f}s", flush=True)
    del moe16
    mesh_k_moe, dt = run("serve_mesh_moe", lambda: _engine_rank_cases(
        f"{MOE} {d_p}x{d_s} engine", calls, torch.bfloat16, dev))
    for rec in mesh_k_moe:
        print(f"[serve_mesh_moe] kernel {json.dumps(rec)}", flush=True)
    del calls
    torch.cuda.empty_cache()
    _zero_counts(ctr)
    d_p, d_s = MESH_VERIFY[MOE]
    (ver, _), dt = run("verify_mesh", lambda: phase_verify_mesh(
        dev, moe_cfg, moe32, moe_trace, d_p, d_s))
    mesh_counts["verify_mesh_moe"] = _read_counts(ctr)
    print(f"[verify_mesh] ok in {dt:.1f}s: {json.dumps(ver)}", flush=True)
    del moe32
    torch.cuda.empty_cache()

    with _moe_watch() as watch:
        trn_moe, dt = run("train_moe", lambda: phase_train(dev, args.seed,
                                                           MOE))
    for rec in trn_moe:
        print(f"[train_moe] {json.dumps(rec)}", flush=True)
    print(f"[train_moe] moe {json.dumps(watch)}", flush=True)
    print(f"[train_moe] ok in {dt:.1f}s", flush=True)
    train_moe_counts = {k: sum(r["launches"][k] for r in trn_moe)
                        for k in ctr}

    ver, dt = run("train_verify_moe", lambda: phase_train_verify_moe(
        dev, args.seed))
    print(f"[train_verify_moe] ok in {dt:.1f}s: {json.dumps(ver)}",
          flush=True)
    verify_moe_counts = ver["launches"]
    torch.cuda.empty_cache()

    # MLA: deepseek-v2-lite's attention kernels at q/k 192, v 128, the
    # model trained at full width on TRAIN_LAYERS' depth and generated from
    # at full width and depth
    (mla_bwd, mla_fwd, mla_ce), dt = run("kernel_mla", lambda:
                                         phase_kernel_mla(dev, args.seed))
    print(f"[kernel_mla] ok in {dt:.1f}s", flush=True)
    with _moe_watch() as watch:
        trn_mla, dt = run("train_mla", lambda: phase_train(dev, args.seed,
                                                           MLA))
    for rec in trn_mla:
        print(f"[train_mla] {json.dumps(rec)}", flush=True)
    print(f"[train_mla] moe {json.dumps(watch)}", flush=True)
    print(f"[train_mla] ok in {dt:.1f}s", flush=True)
    train_mla_counts = {k: sum(r["launches"][k] for r in trn_mla)
                        for k in ctr}

    ver, dt = run("train_verify_mla", lambda: phase_train_verify_moe(
        dev, args.seed, MLA))
    print(f"[train_verify_mla] ok in {dt:.1f}s: {json.dumps(ver)}",
          flush=True)
    verify_mla_counts = ver["launches"]
    torch.cuda.empty_cache()
    with _moe_watch() as watch:
        (gen_mla, gen_mla_counts, gen_mla_decode), dt = run(
            "generate_mla", lambda: phase_generate(dev, args.seed))
    print(f"[generate_mla] {json.dumps(gen_mla)} in {dt:.1f}s", flush=True)
    print(f"[generate_mla] moe {json.dumps(watch)}", flush=True)
    torch.cuda.empty_cache()

    # the remaining decoder families: A and A′ at (160, 160), (32, 32) and
    # (16, 16), B / C1 / C2 at their heads; each family trained at full
    # width on TRAIN_LAYERS' depth and verified in float32; qwen2-vl-7b's
    # vision path split over two chunks; qwen3-4b served and stablelm-12b
    # and qwen2-vl-7b generated from at full width and depth
    (d_bwd, d_fwd, d_merge, d_ce, d_occ), dt = run(
        "kernel_dense", lambda: phase_kernel_dense(dev, args.seed))
    print(f"[kernel_dense] cluster occupancy of C1 (dh) and C2 (dw) by D: "
          f"{json.dumps(d_occ)}", flush=True)
    print(f"[kernel_dense] ok in {dt:.1f}s", flush=True)
    dense_counts = {}
    for tag, arch in (("qwen3", QWEN3), ("stablelm", STABLELM), ("vl", VL)):
        trn_d, dt = run(f"train_{tag}", lambda a=arch: phase_train(
            dev, args.seed, a))
        for rec in trn_d:
            print(f"[train_{tag}] {json.dumps(rec)}", flush=True)
        print(f"[train_{tag}] ok in {dt:.1f}s", flush=True)
        dense_counts[f"train_{tag}"] = {
            k: sum(r["launches"][k] for r in trn_d) for k in ctr}
        torch.cuda.empty_cache()
        ver, dt = run(f"train_verify_{tag}", lambda a=arch:
                      phase_train_verify_dense(dev, args.seed, a))
        print(f"[train_verify_{tag}] ok in {dt:.1f}s: {json.dumps(ver)}",
              flush=True)
        dense_counts[f"train_verify_{tag}"] = ver["launches"]
        torch.cuda.empty_cache()
    spl, dt = run("split_vl", lambda: phase_split_vl(dev, args.seed))
    print(f"[split_vl] ok in {dt:.1f}s: {json.dumps(spl)}", flush=True)
    torch.cuda.empty_cache()
    q_cfg = get_arch(QWEN3)
    q_trace = sample_request_trace("github", 16, 4096, q_cfg.spec.vocab,
                                   seed=0, max_new_tokens=32)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    q_params = DecoderLM(q_cfg).init(gen, dtype=torch.bfloat16, device=dev)
    _zero_counts(ctr)
    srv, dt = run("serve_qwen3", lambda: phase_serve(dev, q_cfg, q_params,
                                                     q_trace))
    dense_counts["serve_qwen3"] = _read_counts(ctr)
    print(f"[serve_qwen3] {json.dumps(srv)} in {dt:.1f}s", flush=True)
    del q_params
    torch.cuda.empty_cache()
    for tag, arch in (("stablelm", STABLELM), ("vl", VL)):
        (gen_d, counts, _), dt = run("generate_dense", lambda a=arch:
                                     phase_generate(dev, args.seed, a))
        dense_counts[f"generate_{tag}"] = counts
        print(f"[generate_dense] {arch} {json.dumps(gen_d)} in {dt:.1f}s",
              flush=True)
        torch.cuda.empty_cache()

    # the encoder-decoder: A and A′ non-causal and across two streams, B /
    # C1 / C2 at its head; seamless-m4t-v2 trained at full width and depth
    # through the stage-split pipeline and verified in float32
    (e_bwd, e_ce, e_sp), dt = run("kernel_encdec", lambda:
                                  phase_kernel_encdec(dev, args.seed))
    print(f"[kernel_encdec] ok in {dt:.1f}s", flush=True)
    (e_trn, encdec_counts), dt = run("train_encdec", lambda:
                                     phase_train_encdec(dev, args.seed))
    for rec in e_trn:
        print(f"[train_encdec] {json.dumps(rec)}", flush=True)
    print(f"[train_encdec] ok in {dt:.1f}s", flush=True)
    # the encoder-decoder on the sequence-parallel axis: 2x2 at full width
    # and depth, allgather_kv, ZeRO-3 per_tick
    (e_sp_trn, encdec_sp_counts), dt = run(
        "train_encdec_sp", lambda: phase_train_encdec_sp(dev, args.seed))
    for rec in e_sp_trn:
        print(f"[train_encdec_sp] {json.dumps(rec)}", flush=True)
    print(f"[train_encdec_sp] ok in {dt:.1f}s", flush=True)
    ver, dt = run("train_verify_encdec", lambda: phase_train_verify_encdec(
        dev, args.seed))
    print(f"[train_verify_encdec] ok in {dt:.1f}s: {json.dumps(ver)}",
          flush=True)
    encdec_verify_counts = ver["launches"]
    torch.cuda.empty_cache()

    # the trainer's control plane: checkpoint and resume at full depth,
    # elastic re-staging between pipeline depths, online re-planning with
    # an injected straggler and the plan journal's replay
    (rst, restart_counts), dt = run("train_restart", lambda:
                                    phase_train_restart(dev, args.seed))
    print(f"[train_restart] ok in {dt:.1f}s: {json.dumps(rst)}", flush=True)
    (ela, elastic_counts), dt = run("train_elastic", lambda:
                                    phase_train_elastic(dev, args.seed))
    print(f"[train_elastic] ok in {dt:.1f}s: {json.dumps(ela)}", flush=True)
    (rpl, replan_counts), dt = run("train_replan", lambda:
                                   phase_train_replan(dev, args.seed))
    print(f"[train_replan] ok in {dt:.1f}s: {json.dumps(rpl)}", flush=True)

    # the sequence-parallel axis: the kernels at a rank's shapes; gemma3-1b
    # at 2x2 (allgather_kv), qwen3-4b at 1x4 (ulysses), hymba-1.5b at 1x2
    # (allgather_kv, the SSM prefix scan and conv halo), bf16; the float32
    # verify of six families against the 1x1 step
    sp_k, dt = run("kernel_sp", lambda: phase_kernel_sp(dev, args.seed))
    print(f"[kernel_sp] ok in {dt:.1f}s", flush=True)
    sp_counts = {}
    for tag in SP_RUNS:
        (recs, sp_counts[tag]), dt = run(tag, lambda t=tag: (
            phase_train_pods(dev, args.seed) if t == "train_pods" else
            phase_train_sp(dev, args.seed, t)))
        for rec in recs:
            print(f"[{tag}] {json.dumps(rec)}", flush=True)
        print(f"[{tag}] ok in {dt:.1f}s", flush=True)
    ver, dt = run("train_sp_verify", lambda: phase_train_sp_verify(
        dev, args.seed))
    print(f"[train_sp_verify] ok in {dt:.1f}s", flush=True)
    sp_counts["train_sp_verify"] = ver["launches"]
    torch.cuda.empty_cache()

    # the pipelined prefill and fixed-batch decode: kernel A at a decode
    # step's shapes; hymba-1.5b and falcon-mamba-7b at full width and depth
    # in bf16 (one float32 copy of the weights made from the seed, its bf16
    # copy beside it), then in float32 against the one-shot oracle;
    # seamless-m4t-v2 in float32 against its teacher-forced greedy
    from repro_torch.models.model import tree_map
    dk, dt = run("kernel_decode", lambda: phase_kernel_decode(dev,
                                                              args.seed))
    for rec in dk:
        print(f"[kernel_decode] {json.dumps(rec)}", flush=True)
    print(f"[kernel_decode] ok in {dt:.1f}s", flush=True)
    decode_counts = {"generate_mla_decode": gen_mla_decode}
    for arch, tag in ((HYMBA, "decode_hymba"), (FALCON,
                                               "decode_falcon_mamba")):
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        p32 = DecoderLM(_arch(arch)).init(gen, dtype=torch.float32,
                                          device=dev)
        p16 = tree_map(lambda a: a.to(torch.bfloat16), p32)
        (recs, counts), dt = run(tag, lambda a=arch, p=p16: phase_decode(
            dev, a, p))
        for rec in recs:
            print(f"[{tag}] {json.dumps(rec)}", flush=True)
            decode_counts[f"{tag}_{rec['mesh']}"] = counts[rec["mesh"]]
        print(f"[{tag}] ok in {dt:.1f}s", flush=True)
        del p16
        torch.cuda.empty_cache()
        (ver, counts), dt = run("decode_verify", lambda a=arch, p=p32:
                                phase_decode_verify(dev, a, p))
        print(f"[decode_verify] {json.dumps(ver)}", flush=True)
        print(f"[decode_verify] {arch} ok in {dt:.1f}s", flush=True)
        for mesh, c in counts.items():
            decode_counts[f"decode_verify_{arch}_{mesh}"] = c
        del p32
        torch.cuda.empty_cache()
    (recs, counts), dt = run("decode_encdec", lambda: phase_decode_encdec(
        dev, args.seed))
    for rec in recs:
        print(f"[decode_encdec] {json.dumps(rec)}", flush=True)
        decode_counts[f"decode_encdec_{rec['mesh']}"] = counts[rec["mesh"]]
    print(f"[decode_encdec] ok in {dt:.1f}s", flush=True)
    torch.cuda.empty_cache()


    # launches per path: the serving engines, the bf16 train steps, the
    # float32 verify phases' chunked step (the float32 B and C1 run only
    # there), the pipelines, the one-shot generators
    paths = {"serve": serve_counts, "train": train_counts,
             "train_hymba": hymba_counts, "train_verify": verify_counts,
             "train_verify_hymba": verify_hymba_counts,
             "train_pipeline": pipe_counts,
             "train_pipeline_verify": pipe_verify_counts,
             "serve_moe": serve_moe_counts, "train_moe": train_moe_counts,
             "train_verify_moe": verify_moe_counts,
             "train_mla": train_mla_counts,
             "train_verify_mla": verify_mla_counts,
             "generate_mla": gen_mla_counts, **dense_counts,
             "train_encdec": encdec_counts,
             "train_encdec_sp": encdec_sp_counts,
             "train_verify_encdec": encdec_verify_counts,
             "train_restart": restart_counts,
             "train_elastic": elastic_counts,
             "train_replan": replan_counts, **sp_counts, **decode_counts,
             **mesh_counts, **dryrun_counts}
    print("[kernels] " + "; ".join(f"{p}: {json.dumps(c)}"
                                   for p, c in paths.items())
          + f"; total {time.perf_counter() - t_start:.1f}s", flush=True)
    fa = "src/repro_torch/kernels/csrc/flash_attention.cu"
    cs = "src/repro_torch/kernels/csrc/cross_entropy.cu"
    ms_src = "src/repro_torch/kernels/csrc/mamba_scan.cu"
    tpu_fa = "src/repro/kernels/flash_attention.py:89"
    tpu_ms = "src/repro/kernels/mamba_scan.py:77"
    tpu_ce = "src/repro/kernels/cross_entropy.py"
    g, m = cases[0], merges[0]          # gemma3-1b global layer, bf16
    g32 = cases[3]                      # the same, float32
    gb = bwd[0]             # step 0's largest train chunk, global, bf16
    gb_local = bwd[1]       # the same chunk, window-512 layer
    vb, vb_h = bwd[-2], bwd[-1]     # the verify phases' chunks, float32
    gce = ce[0]             # the gemma3-1b head on that chunk, bf16
    vce, vce_h = ce[-2], ce[-1]     # the verify phases' chunks, float32
    # the selective scan: the gated bf16 case on hymba's largest train
    # chunk (the train step's), then the float32 gated case (the verify
    # phase's) and the ungated cases with bf16 xs at hymba's and
    # falcon-mamba-7b's widths
    scan_also = [gated[1], sp_k["scan"], scan[0], scan[3]]
    # the attention backward's library yardstick on the kernel's own case
    # (step 0's largest train chunk), else on the first case it takes
    lib = next((r for r in [gb] + bwd if r["library_ms"] is not None), gb)

    def _also(rec):         # a second case of the same kernel
        return [{k: rec[k] for k in ("case", "dtype", "T", "D", "V",
                                     "kernel_ms", "bound_ms", "plain_ms",
                                     "library_ms", "max_abs_err")}]

    def _bwd_also(rec, p):  # an attention backward pass of another case
        return {"case": rec["case"], "dtype": rec["dtype"], "T": rec["T"],
                "S": rec["S"], "Hq": rec["Hq"], "D": rec["D"],
                "Dv": rec["Dv"], "causal": rec.get("causal", True),
                "ms": rec[f"kernel_ms_{p}"], "bound_ms": rec[f"bound_ms_{p}"],
                "bound_by": rec[f"bound_by_{p}"],
                "plain_ms": rec["plain_ms"], "library_ms": rec["library_ms"],
                "max_abs_err": rec["max_abs_err"]}
    moe_gb, moe_vb = moe_bwd            # olmoe's train chunk, verify chunk
    moe_gce, moe_tce, moe_vce = moe_ce  # train chunk, CE_T, verify chunk
    mla_gb, mla_vb = mla_bwd            # deepseek's (192, 128) cases
    mla_gce, mla_vce = mla_ce           # its head: train chunk, verify chunk
    # the dense families: (160, 160) train and verify chunks, then fig11's
    # and fig13's (32, 32) and (16, 16) cases, bf16 and float32 each
    st_gb, st_vb, *fig = d_bwd
    fig_bf16 = [r for r in fig if r["dtype"] == "bfloat16"]
    fig_f32 = [r for r in fig if r["dtype"] == "float32"]
    dense_gce, dense_vce = d_ce[:3], d_ce[3]    # bf16 at 3 heads, float32
    # the encoder-decoder: the encoder (non-causal) and the three cross
    # cases on the train chunk, bf16; the encoder on the verify chunk,
    # float32; its head on both chunks
    enc_bf16, enc_f32 = e_bwd[:4], e_bwd[4]
    enc_gce, enc_vce = e_ce
    # and at a rank's shapes on train_encdec_sp's step-0 chunk: the
    # encoder, the decoder's self-attention and cross-attention (bf16),
    # the head's second vocabulary block
    enc_rank = [e_sp[k] for k in ("encoder", "self", "cross")]

    def _fwd(rec):          # the attention forward of one case
        keys = ("case", "dtype", "T", "S", "Hq", "D", "Dv", "window")
        if "fwd_ms" not in rec:             # an engine-step case: the op
            return {**{k: rec[k] for k in keys}, "causal": True,
                    "n_split": rec["n_split"],
                    "ms": rec["kernel_ms"], "ms_is": rec["kernel_ms_is"],
                    "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                    "plain_ms": rec["plain_ms"],
                    "library_ms": rec["library_ms"],
                    "max_abs_err": rec["max_abs_err"]}
        return {**{k: rec[k] for k in keys},
                "causal": rec.get("causal", True),
                "n_split": rec["fwd_n_split"],
                "ms": rec["fwd_ms"], "bound_ms": rec["fwd_bound_ms"],
                "bound_by": rec["fwd_bound_by"],
                "plain_ms": rec["fwd_plain_ms"],
                "library_ms": rec["fwd_library_ms"],
                "max_abs_err": rec["out_max_abs_err"]}

    def entry(name, src, tpu, rec, **kw):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": tpu,
                "launches": sum(c.get(name, 0) for c in paths.values()),
                **{f"launches_{p}": c.get(name, 0) for p, c in paths.items()},
                "case": rec["case"], "dtype": rec["dtype"], "T": rec["T"],
                "max_abs_err": rec["max_abs_err"],
                "ms": rec["kernel_ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"]} | kw
    def scan_entry(name, rec):
        bwd_pass = name in mamba_scan_bwd_cuda.KERNELS
        fn = "D'" if bwd_pass else "D"

        def numbers(r):
            sfx = "_bwd" if bwd_pass else ""
            return {"case": r["case"], "dtype": r["dtype"], "T": r["T"],
                    "ms": r["kernel_ms_by"][name],
                    "bound_ms": r["bound_ms" + sfx],
                    "bound_by": r["bound_by" + sfx],
                    "design_bound_ms": r["design_bound_ms_by"][name],
                    "design_bound_by": r["design_bound_by_by"][name],
                    "max_abs_err": r["bwd_max_abs_err" if bwd_pass
                                     else "max_abs_err"],
                    "function_ms": r["kernel_ms_by"][fn],
                    "function_plain_ms": r["plain_ms" + sfx]}
        return entry(name, ms_src, tpu_ms + (" (its gradient)" if bwd_pass
                                             else ""), rec, **numbers(rec),
                     plain_ms=rec["plain_ms_bwd" if bwd_pass
                                  else "plain_ms"],
                     plain_covers=f"the whole of {fn} ({rec['plain_is']})",
                     ms_covers="this kernel alone; function_ms: all of "
                               f"{fn}'s kernels",
                     bound_covers=f"bound_ms: the whole of {fn}, its own "
                                  "inputs and outputs; design_bound_ms: "
                                  "what this pass reads and writes, this "
                                  "design's summaries, checkpoints and "
                                  "partials included",
                     library_is=rec["library_is"],
                     also=[numbers(r) for r in scan_also])

    kernels = {"kernels": [
        entry("flash_fwd_mma_kernel", fa, tpu_fa, gb, **_fwd(gb),
              ms_covers="the forward kernel as the train step runs it, with "
                        "lse, unsplit (n_split 1) on the train chunks; the "
                        "tile ranges are flash_bwd_tiles_kernel's",
              library_is="scaled_dot_product_attention forward, "
                         "EFFICIENT_ATTENTION backend, the same boolean mask",
              also=[_fwd(r) for r in (gb_local, h_attn, moe_gb, mla_gb,
                                      mla_fwd, g, cases[1], cases[2], st_gb,
                                      d_fwd, *fig_bf16, *enc_bf16,
                                      *enc_rank, sp_k["allgather_kv"],
                                      sp_k["ulysses"],
                                      *[r for r in dk
                                        if r["dtype"] == "bfloat16"],
                                      *mesh_k, *mesh_k_moe)]),
        entry("flash_fwd_kernel", fa, tpu_fa, vb, **_fwd(vb),
              ms_covers="the forward as the train step runs it, with lse: "
                        "split pass and merge pass",
              library_is="scaled_dot_product_attention forward, "
                         "EFFICIENT_ATTENTION backend, the same boolean mask",
              also=[_fwd(r) for r in (vb_h, moe_vb, mla_vb, g32,
                                      cases[4], st_vb, *fig_f32, enc_f32,
                                      *[r for r in dk
                                        if r["dtype"] == "float32"],
                                      *mesh_k32)]),
        entry("flash_combine_kernel", fa, tpu_fa, m,
              also=[{k: d_merge[k] for k in ("case", "dtype", "T", "n_split",
                                             "kernel_ms", "bound_ms",
                                             "plain_ms", "max_abs_err")}]),
        entry("flash_bwd_dkdv_kernel", fa, tpu_fa + " (its gradient)", gb,
              ms=gb["kernel_ms_dkdv"], bound_ms=gb["bound_ms_dkdv"],
              bound_by=gb["bound_by_dkdv"], plain_is=gb["plain_is"],
              library_ms=lib["library_ms"], library_case=lib["case"],
              library_case_ms=lib["kernel_ms"],
              library_is=lib["library_is"] + "; kernel and yardstick both "
              "on library_case (library_case_ms: both backward passes)",
              also=[_bwd_also(r, "dkdv") for r in (moe_gb, moe_vb, mla_gb,
                                                   mla_vb, st_gb, st_vb,
                                                   *fig, *e_bwd, *enc_rank,
                                                   sp_k["allgather_kv"],
                                                   sp_k["ulysses"])]),
        entry("flash_bwd_dq_kernel", fa, tpu_fa + " (its gradient)", gb,
              ms=gb["kernel_ms_dq"], bound_ms=gb["bound_ms_dq"],
              bound_by=gb["bound_by_dq"], plain_is=gb["plain_is"],
              library_ms=lib["library_ms"], library_case=lib["case"],
              library_case_ms=lib["kernel_ms"],
              library_is=lib["library_is"] + "; kernel and yardstick both "
              "on library_case (library_case_ms: both backward passes)",
              also=[_bwd_also(r, "dq") for r in (moe_gb, moe_vb, mla_gb,
                                                 mla_vb, st_gb, st_vb,
                                                 *fig, *e_bwd, *enc_rank,
                                                 sp_k["allgather_kv"],
                                                 sp_k["ulysses"])]),
        entry("flash_bwd_tiles_kernel", fa, tpu_fa + " (its gradient)", gb,
              max_abs_err=gb["tiles_max_abs_err"], ms=gb["tiles_ms"],
              plain_ms=gb["tiles_plain_ms"], bound_ms=gb["tiles_bound_ms"],
              bound_by=gb["tiles_bound_by"], library_ms=None,
              ms_covers="the backward passes' tile ranges and summaries",
              plain_is="ref.flash_attention_tiles (from the mask)",
              also=[{"case": r["case"], "causal": r["causal"],
                     "ms": r["tiles_ms"], "bound_ms": r["tiles_bound_ms"],
                     "plain_ms": r["tiles_plain_ms"], "tiles": r["tiles"],
                     "max_abs_err": r["tiles_max_abs_err"]}
                    for r in (*e_bwd, *enc_rank, sp_k["allgather_kv"],
                              sp_k["ulysses"])]),
        entry("ce_fwd_mma_kernel", cs, tpu_ce + ":79", gce["B"],
              library_is=gce["B"]["library_is"],
              library_bf16_ms=gce["B"]["library_bf16_ms"],
              library_bf16_is=gce["B"]["library_bf16_is"],
              also=_also(moe_gce["B"]) + _also(moe_tce["B"])
              + _also(mla_gce["B"])
              + [x for r in dense_gce for x in _also(r["B"])]
              + _also(enc_gce["B"]) + _also(sp_k["ce"]["B"])
              + _also(e_sp["ce"]["B"])),
        entry("ce_bwd_dh_mma_kernel", cs, tpu_ce + ":159", gce["C1"],
              max_active_clusters={D: o["dh"] for D, o in d_occ.items()},
              cluster_slices={D: o["slices"] for D, o in d_occ.items()},
              also=_also(moe_gce["C1"]) + _also(moe_tce["C1"])
              + _also(mla_gce["C1"])
              + [x for r in dense_gce for x in _also(r["C1"])]
              + _also(enc_gce["C1"]) + _also(sp_k["ce"]["C1"])
              + _also(e_sp["ce"]["C1"])),
        entry("ce_fwd_kernel", cs, tpu_ce + ":79", vce["B"],
              library_is=vce["B"]["library_is"],
              also=_also(vce_h["B"]) + _also(moe_vce["B"])
              + _also(mla_vce["B"]) + _also(dense_vce["B"])
              + _also(enc_vce["B"])),
        entry("ce_bwd_kernel<dh>", cs, tpu_ce + ":159", vce["C1"],
              also=_also(vce_h["C1"]) + _also(moe_vce["C1"])
              + _also(mla_vce["C1"]) + _also(dense_vce["C1"])
              + _also(enc_vce["C1"])),
        entry("ce_bwd_dw_mma_kernel", cs, tpu_ce + ":222", gce["C2"],
              max_active_clusters={D: o["dw"] for D, o in d_occ.items()},
              cluster_slices={D: o["slices"] for D, o in d_occ.items()},
              also=_also(h_ce["C2"]) + _also(moe_gce["C2"])
              + _also(moe_tce["C2"]) + _also(mla_gce["C2"])
              + [x for r in dense_gce for x in _also(r["C2"])]
              + _also(enc_gce["C2"]) + _also(sp_k["ce"]["C2"])
              + _also(e_sp["ce"]["C2"])),
        entry("ce_bwd_kernel<dw>", cs, tpu_ce + ":222", vce["C2"],
              also=_also(vce_h["C2"]) + _also(moe_vce["C2"])
              + _also(mla_vce["C2"]) + _also(dense_vce["C2"])
              + _also(enc_vce["C2"])),
        *[scan_entry(name, rec) for name in SCAN_KERNELS
          for rec in gated[:1]]]}
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
