#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, exit code != 0):
  1. build    compile every kernel in paddle_tpu_torch/kernels/csrc with
              nvcc (sm_90a) into build/kernels/, and time it;
  2. kernels  hold each hand-written kernel against its plain PyTorch
              version on the card at the serving path's Llama-2-7B shapes,
              in bf16 (2e-2 abs; the chunk attention 1e-3 + one bf16 ulp
              of the plain output) and fp32 (1e-4 abs), and time the kernel,
              the plain version, one library call where PyTorch has one,
              and the card's least time for the same work (bound; the
              prefill, decode and chunk rows also give bound_frac, bound /
              kernel time). The decode attention and the one-layer and
              N-layer fused decode run at serve's ragged lengths (one idle
              row) and at serve_long's decode contexts (3500/2900/1800/700
              of a 4096-token table), with device_ms from calls replayed
              from a CUDA graph; the chunk
              attention a 256-token chunk from
              start 3328 and a ragged 100-token final chunk, each with a
              spread and a peaked softmax; the N-layer decode a group of
              4 layers, also held bit for bit to 4 launches of the
              one-layer kernel and timed beside them. Every kernel with
              an int8-pool variant (decode, chunk, one-layer and N-layer
              decode attention) runs it on the
              same pools quantized (decode and chunk held to 1e-5 in fp32
              and 1e-3 + one bf16 ulp in bf16; the fused kernels to their
              native tolerance, the one-layer kernel's appended int8 rows
              within one payload step and SCALE_RTOL of the plain rows, the
              N-layer one bit for bit to 4 int8 one-layer launches), and the
              N-layer decode also runs int4 weights on native and int8
              pools; then the spec phase's new shapes: #4 as the verify
              (S = 3, 5, 9 at 7B heads from 700 in a 1024-token table) and
              as the draft's sync chunk (S = 64 at TinyLlama-1.1B's heads,
              32 over 4 of dim 64), #2 and #3 as the draft's step (B = 1,
              700 tokens, TinyLlama's layer), each also on its pools
              quantized (its int8 variant, as above); then generation's
              new shapes: #1 as the draft's prefill (S = 256, 32 over 4
              heads of dim 64), as generate's prefill into its ring buffer
              (B = 4, S = 128, T = 160) and as generate_speculative's
              verify (S = 3, 5, 9 from 700 of an 800-position ring buffer
              at 7B heads), the caches holding +-1e4 past cur_len, each
              held to flash_prefill_ref and timed against SDPA with an
              explicit mask; #2 at generate_paged's last step (4 rows of
              160 tokens, a pool with no null page), native and int8; #3
              through incubate.nn.functional.fused_block_decode at serve's
              lengths; then GPT-3 345M's heads (16 MHA heads of dim 64):
              #1 as a 256-token prefill, #2 at B = 4 over 1023/517/78/0
              of a 1024-token table, #4 as a 256-token chunk from 512
              (native and on the pool quantized), each held to its plain
              version and timed against SDPA and the bound; then #2 at the
              tensor-parallel shard's shape (B = 4, 16 heads over 16 kv
              heads of 128, serve's lengths), on the last shard's kv-head
              partition of a 7B pool (a view, as the TP chain passes it),
              native and int8;
  3. serve    Llama-2-7B (32 layers, bf16, random weights from a seed)
              through ServingEngine: 8 requests of at most 256 tokens, 32
              new tokens each, some submitted mid-run, with fused block
              decode, with the generic decode, with the generic decode on
              an int8 pool, and 4 layers a launch on an int8 pool and with
              int4 weights; the kernel launch counters show which kernels
              (and variants) each run went through, exactly;
     serve_long
              the same model with a 4096-token context: 8 prompts of 40 to
              3500 tokens (the long ones prefilled in 256-token chunks
              between decode steps), half submitted mid-run, 32 new tokens
              each, with one fused kernel per layer and one per group of 4
              layers (FLAGS_fused_block_layers=4) on the native pool (the
              streams must be identical), then one per layer on an int8
              pool and one per group on an int8 pool with int4 weights
              (the first tokens must be identical); launch counts exact;
              the chunks run as the engine's CUDA graph;
     sched    the scheduler on the same model: max_batch 8 under the
              default bucket ladder (rungs 4 and 8, shrink patience 2), 12
              prompts of 17 to 256 tokens, half submitted after 6 steps:
              every request OK with its tokens, at least two migrations,
              one CUDA-graph capture per rung, exact launch counts; its
              agreement with a fixed (8,) run is reported (first differing
              token, top-2 logit margins). Then each decode route's graph
              (fused N = 1, N = 4 on an int8 pool with int4 weights,
              generic) against the eager step it captured on the same
              inputs and pools: logits and pool writes bit for bit, the
              same launches counted, and both step times (CUDA events),
              the replay's device time and each call's host seconds. Then
              deadline=0 and run(max_wall=0) end TIMEOUT, a tight-deadline
              arrival into a full batch preempts (every request OK,
              on_token once a token and once at the end, run_step / poll /
              take_results equal to run); the victims' streams against an
              uninterrupted run are reported;
     prefix   the prefix cache on serve_long's configuration: one seeded
              2048-token prefix (32 pages) under 8 requests of 32 new
              tokens, the first cold (its prompt in 10 chunks from 0),
              three arriving once it has its first token, four 6 steps
              later; every request OK, each hit adopting 32 pages, the
              suffixes over two pages chunked from cursor 2048 in
              ceil(suffix / 256) chunks and the others teacher-forced,
              exact launches; the same traffic with prefix_cache=False
              for the chunks and #4 launches saved, the TTFTs and the
              streams' agreement (first differing token, top-2 margins);
              the engine's chunk graph against the eager chunk program
              (logits row and pool writes bit for bit, the same
              launches) with both times, the replay's and each call's
              host seconds; a cached page spilled to pinned host memory
              and restored into another page, bit for bit and in place,
              each timed against the chunk compute a page; then the host
              tier: one slot, 34 device pages, 96 host pages, a second
              prefix spilling the first and a repeat of the first
              restoring its 32 pages, the streams equal to a pool that
              never spills;
     recovery replay recovery on the same model, serve's pages and context
              with the prefix cache and 256-token chunks: 8 requests of 32
              new tokens (prompts of 17 to 700, the 300 and 700 chunked),
              half after 6 steps, fault-free and under
              FLAGS_fault_inject="prefill:every=5;chunk_prefill:every=4;
              decode_dispatch:every=9" (no-progress budget 20): every
              request OK, recoveries equal to the faults fired, one capture
              per rung and one for the chunk as in the fault-free run, the
              pools at their addresses, the ledger balanced after the
              drain, exact launches (the graphs replayed), and
              serving_decode_steps equal to the decode steps dispatched
              (counter bookkeeping: it counts on the host before the
              fault check and the graph call); the bf16 agreement with
              the fault-free run (first differing token, top-2 margins),
              recovery ms (the median, max and mean of the recoveries'
              own wall clocks) and retries reported, and the statuses at
              the default budget (3); retry exhaustion (every dispatch fails,
              budget 2: every request FAILED, run returns, the disarmed
              engine serves a request as a fault-free engine does); a
              KernelError, injected (a neutral message, no real fault) and
              from a graph given a moved pool, raises out of step; the
              graphed fused step at B = 4 with FLAGS_telemetry on and off;
              a Chrome trace of the phase under build/;
     spec     speculative decoding on the same model with a TinyLlama-1.1B-
              shaped seeded draft (hidden 2048, 22 layers, 32 heads over 4
              kv heads, inter 5632): batch 1 at a 9-slot budget (rungs 2,
              4, 8, adaptive), 4 prompts of 17 to 256 tokens, 64 new tokens
              each, with the draft on the fused route and on the generic
              one, with the target as its own draft (γ reaches 8) and with
              an all-zero draft (γ falls to 2), beside the plain engine:
              every request OK, exact launches (#3 or #2 a draft layer per
              scan step, #4 a layer per verify and a draft layer per sync
              chunk, #1 a layer per admission), the draft synced once a
              request (gap-free rounds), at most one capture a key and
              engine; acceptance, tokens a round, the γ trajectory, each
              round's wall ms and each graph's device ms by γ, the bf16
              agreement with the plain engine (first differing token, top-2
              margins; each logits row up to the first difference within
              an RMS of 2^-3 of the plain row's standard deviation, and
              each first difference at a plain top-2 margin below twice
              that: a near tie; the plain engine's generic route against
              its fused one held the same way as the yardstick) and the
              break-even acceptance rate per γ against the plain step; a
              request whose prompt and new tokens fill the table (960 +
              64); serve's traffic at max_batch 4 under the default
              pricing (steps mix), and an int8 pool at batch 1, each held
              to the plain engine's logits the same way; sampled
              requests (temperature 0.8, top-k 50, top-p 0.95, four seeds)
              equal over two runs, and compared with a run under
              FLAGS_fault_inject="spec_draft:every=3:times=4;spec_verify:
              every=4:times=4" (bf16: agreement reported; the replays
              re-prefill the KV the rounds read, which rounds otherwise);
     generate the same model through GenerationMixin, its loops eager on
              ring buffers: greedy generate (B = 4, P = 128, N = 32: #1 32
              launches, exactly), its agreement with the ServingEngine's
              streams of the same prompts reported (first differing token,
              top-2 margins, each row's first bf16 tie at the top); sampled
              (temperature 0.8, top-k 50, top-p 0.95) equal over two runs
              of one generator seed, and top-k = 1 equal to greedy up to
              each row's first tie; beam search (4 beams, P = 64, N = 16),
              its length-normalised log-probability rescored by one
              no-cache forward no lower than greedy's minus BEAM_TOL;
              generate_paged (#1 32, #2 992 launches); generate_speculative
              with the TinyLlama-1.1B-shaped draft (gamma 4, N = 64: #1 32
              a round, acceptance and ms a token against generate); then
              Paddle's fused serving entry points at 7B width against the
              same entry points on the plain versions: fused_multi_transformer
              (4 layers, a 128-token prefill with caches, then 16 decode
              steps: #1 4 launches), masked_multihead_attention (16 steps),
              block_multihead_attention (prefill and 16 decode steps over a
              pool with no null page: #1 1, #2 16) and fused_block_decode
              (16 steps: #3 16); the phase's seconds;
     handoff  serve's configuration, native and int8 pools: a 200-token
              request harvested after its first token from engine A and
              adopted by engine B, which served it alone first: B's stream
              equal to the solo one bit for bit, B's CUDA graphs and pool
              addresses kept, no new capture, #3 a layer per decode step
              only; the bundle round-trips a spawned process byte for byte
              (no CUDA tensor rides); harvest and adoption ms;
     tp       ServingEngine(tp_degree=2) on serve's model and traffic,
              both shards on the card: fused N = 1, N = 4 and an int8
              pool, each beside the tp = 1 engine (the streams compared,
              a difference reported with its first differing token and
              both engines' top-2 margins there; decode step ms, TTFT,
              tokens/s and peak memory of both); exact launches (#2 32
              layers x 2 shards a decode step, #1 a layer a prefill, no
              #3/#5), the key carrying ("tp", 2); the graphed TP step
              against its eager step bit for bit with both times; a
              200-token int8 request harvested from one TP engine and
              adopted by another that served it alone, bit for bit;
              FleetRouter(replicas=2, tp_degree=2) on serve's traffic,
              loss-free and through one replica loss
              (router_dispatch:every=20:times=1): every request OK, the
              agreement with the loss-free fleet reported (a re-routed
              request re-prefills prompt + tokens: bf16 rounds it
              otherwise); the phase's seconds (GPT-3 345M's generic
              route at tp = 2 runs in the gpt phase: streams equal to
              tp = 1 bit for bit, launches as at tp = 1);
     fleet    FleetRouter(replicas=2) over serve's engine (fused N = 1, a
              16-page host tier a replica): two 512-token shared prefixes
              under 5 requests each (suffixes 17 to 256; each prefix's
              first request in wave 1 with 2 cold prompts, the rest in wave
              2), 32 new tokens: every request OK, wave 2 placed by
              affinity on its prefix's replica, the routing counters'
              increase equal to the placements, one capture a rung and one
              chunk capture a replica (none during the traffic), exact
              launches (#3, #1, #4 summed over every engine built); the
              round-robin arm's pages adopted no more than affinity's; a
              loss drill (router_dispatch:every=25:times=3, armed after
              the warm-up): every request OK, losses = faults fired (at
              least 2), rerouted = requests exported, the rebuilt
              replicas' captures counted, the peak within one replica's
              pool bytes of the fault-free run, the agreement with it
              (first difference, top-2 margin), each loss's ms (harvest,
              rebuild, the rebuilt replica's first step) and the device
              bytes around it; a crash loop (every=1) raising after
              max_losses;
     quant    serve's model through nn.quant.quantize_linears (int8, then
              int4), served by ServingEngine with the fused flag on:
              serve's traffic with one 300-token prompt, the generic route
              taken (#1, #4, #2 exact, no #3/#5), every request OK, the
              weight_quantize -> weight_dequantize round trip of layer 0
              and the LM head within half a scale step, the weight bytes
              against bf16's, the graphed decode step against the bf16
              generic step, and two streams against the same quantized
              model's generate (first difference, top-2 margin);
     gpt      GPT-3 345M (vocab 50304, hidden 1024, 24 layers, 16 heads of
              64, inter 4096, 1024 positions, tied head), bf16, seeded:
              ServingEngine at max_batch 4, pages of 64, a 1024-token
              context, 256-token chunks, 8 prompts of 17 to 900 tokens
              (half mid-run), 32 new tokens (every request OK; #1, #2, #4
              exact, no fused kernel; a capture a key), generate (B = 4,
              P = 128, N = 32: #1 24 launches), the model as its own draft
              at γ = 2, batch 1 (acceptance, round ms, exact launches);
              the engine at tp_degree=2 (the generic route as at tp = 1:
              streams equal, the same launches);
     memwatch serve's engine and traffic on the fused (N = 1) and generic
              routes, each on a native and an int8 pool, telemetry and
              memwatch on: the program table (a row per captured decode
              rung and chunk program, each graph's temp, its private
              memory pool, > 0) printed; estimate_engine_memory's weight
              and KV-pool terms equal to the bytes of the engine's weight
              and pool tensors, its total beside the run's allocator peak
              and each row's estimated temp beside the captured one
              (reported); plan_fused_layers' scratch equal to the kernel's
              own size query (ptt_fused_multi_block_decode_scratch) at
              serve's and serve_long's shapes, native and int4, each plan
              fitting the card; the fused native run again with memwatch
              off: streams token for token and launches equal, no row
              added, both graphed step times; then tools/torch_memwatch.py's
              capture suite (tiny Llama fused and chunked, on an int8 pool,
              N = 2 and N = 2 int8 + int4; tiny GPT generic and a train
              step; a tiny MoE-GPT train step) banked and checked against
              itself: 8 rows, each temp > 0, no program grown;
  4. parity   the same engine in fp32 at full width with 2 layers, prompts
              of 17 to 700 tokens (two of them chunked), its per-token
              logits held against a teacher-forced no-cache forward of the
              model on the card, with fused decode one layer and two
              layers a launch, and with the generic decode. That forward
              runs the flash-attention forward kernel, which train_kernels
              holds to its plain version;
              then the sched phase's ladder and preemption on this fp32
              model: a migrating run equal to a fixed (8,) run, and every
              stream of the preemption run equal to the same request's
              without the arrival, token for token; then the prefix
              phase's traffic, the hits' streams equal to the cold
              run's, token for token; then the recovery phase's traffic
              and spec, the streams equal to the fault-free run's, token
              for token; then the spec phase's batch-1 and serve traffic
              with a 1-layer TinyLlama-shaped draft, the streams equal to
              the plain engine's token for token, and its sampled
              requests equal over two runs and under its fault spec;
              then the model as its own draft (acceptance >= 0.95, γ
              reaches 8); then generate, generate_paged, sampled top-k = 1
              and generate_speculative (a 1-layer draft) equal to a
              no-cache argmax loop token for token, and beam search's
              rescored log-probability no lower than greedy's; then a
              harvested request decoded to the end in a spawned process on
              the card, which rebuilds the model from its seed
              (testing.transport.adopt_and_decode_in_child): its stream
              equal to the solo one; then tp_parity: the engine at
              tp_degree=2 on the card, at tp = 2 on a CPU copy (the plain
              versions) and at tp = 1 on the card, three prompts of 17 to
              130 tokens, the three streams equal token for token, and a
              TP fleet through one replica loss equal to them; then a
              2-replica fleet through two
              replica losses equal to one engine, token for token; the
              model int8-quantized: the engine's streams equal to its
              generate's; then GPT-3 345M's width at 2 layers: the
              engine's streams (two prompts chunked) equal to a no-cache
              argmax loop, and with a 1-layer GPT draft equal to the plain
              engine;
  5. train_kernels
              the training attention kernels (forward, dq, dk/dv) against
              autograd of the dense flash_attention_ref on the card, causal,
              at Llama-2-7B heads (S=4096), Llama-2-70B heads (GQA, S=2048)
              and a ragged length (S=1000), at the hybrid phases' mp = 2
              shard (S=4096, 16 of Llama-2-7B's 32 heads), at GPT-3 345M's
              heads (B=4,
              S=1024, 16 heads of 64) causal and not, and at SD-1.5's UNet
              attention (B=2, 8 heads, not causal): self-attention at
              (S, D) = (4096, 40), (1024, 80), (256, 160), (64, 160) and
              cross-attention of the same queries against 77 keys; bf16
              (out within 1e-3 + one
              bf16 ulp of the reference, lse 1e-3, grads 2e-2 of their
              largest element) and fp32 (1e-4 each), with kernel, plain,
              library (SDPA forward, forward + backward, and its backward
              alone) and bound times (forward, dq and dk/dv also
              bound_frac); then flash_attention_with_lse at the 7B and
              70B head shapes, bf16 and fp32: out, lse and dq/dk/dv under
              a seeded (dO, dlse) against autograd of the plain forward
              (the same tolerances), each kernel launched once; two
              non-causal calls over the halves of the keys merged in log
              space against the whole call (out 2e-3 bf16 / 1e-4 fp32
              abs, lse as above); with_lse forward and forward + backward
              timed beside flash_attention's on the same shape;
     unet     UNetConfig.sd15() at full width and
              depth (859,520,964 parameters; heads of 40, 80 and 160),
              bf16 with f32 masters, seeded, TrainStep(UNetDenoiseLoss) +
              AdamW 1e-4 (the JAX bench's recipe), without remat: 2
              warm-up steps, then 5 measured, on one fixed batch of 2 x 4 x
              64 x 64 latents, timesteps in [0, 1000), a 77 x 768 context
              and unit noise: finite losses, #7, #8 and #9 launched 32
              times a step each (16 transformers x self and cross) and no
              other kernel; step ms, images/s, peak memory;
     unet_parity
              one fp32 step of SD-1.5's widths cut to 3 blocks (320, 640,
              1280) of 1 layer at 32 x 32 latents (heads of 40 and 80 in
              the blocks, 160 in the mid block), batch 2, 77 context
              tokens, on the card and on a CPU copy: the loss within 1e-4
              and every gradient within 1e-3 (rel L2);
     bert     BertConfig.bert_base() (bert-base-uncased: 12 layers, hidden
              768, 12 heads, vocab 30522), BertForPretraining +
              BertPretrainingCriterion through TrainStep + AdamW 1e-4,
              bf16 with f32 masters, dropout 0.1 from the model's
              generator: 2 warm-up steps then 5 measured on one fixed
              batch of 8 x 512 tokens (ragged real lengths padded with
              pad_token_id, two segments, 15 % of the real tokens
              labelled for the MLM, NSP labels): finite losses, no kernel
              launched (the padding mask takes SDPA's dense path); step
              ms, tokens/s, peak memory; then a
              BertForSequenceClassification eval forward on the batch;
     bert_parity
              one fp32 step of bert-base at 2 layers without dropout on
              the card and on a CPU copy: the loss within 1e-4 and every
              gradient within 1e-3 (rel L2);
     moe      MoEGPTConfig() (GPT-3 345M widths:
              vocab 50304, hidden 1024, 24 layers, 16 heads of 64, inter
              4096, tied head; 8 experts, top-2, an MoE FFN every 2nd
              block, capacity factor 1.2, aux weight 0.01; 1.06 B
              parameters), bf16 with f32 masters, seeded, TrainStep +
              AdamW + global-norm clip + warmup/cosine LR, 5 steps on one
              fixed batch of 4 x 1024 tokens: finite, falling losses, #7,
              #8 and #9 launched 24 times a step each and no other kernel,
              every gate's loss collected by the step, memwatch's
              train_step row for the model; step ms, tokens/s, MFU on the
              model's work (and the work the capacity padding and the
              dispatch/combine products add), peak memory, and before and
              after the steps each MoE block's aux loss and the choices
              dropped at capacity (its gate's logits tapped in a forward);
     moe_parity
              one fp32 step of the same width at 2 layers (a dense and an
              MoE block), S=512, on the card and on a CPU copy: the loss
              within 1e-4 and every gradient within 1e-3 (rel L2);
     fused_layers
              FusedTransformerEncoderLayer (hidden 1024, 16 heads, FFN
              4096, GELU) in eval mode on B=4 x S=1024 bf16 against the
              same layer on the dense attention, and
              fused_multi_head_attention (pre-LN, biases) forward and
              backward against the dense reference: within 2e-2 of the
              largest element; #7 non-causal once a call, #8 and #9 once a
              backward; both timed beside the dense route;
  6. train    Llama-2-7B width cut to 8 layers, bf16 with f32 masters,
              TrainStep(grad_accum_steps=2) + AdamW + global-norm clip +
              warmup/cosine LR, 5 steps on one fixed batch of 2 x 4096
              tokens: finite, falling losses, each flash kernel launched
              8 layers x 2 micro-batches x 5 steps = 80 times; the step's
              memwatch row (its first step's rise of the allocator peak
              as temp) printed;
     train_remat
              the same model, batch and trainer with remat=True: the first
              step's gradients equal (bit for bit) to the same step
              without remat, then 5 steps timed as train, with a lower
              peak memory than train's and the forward kernel launched
              twice a layer and micro-batch (160), dq and dk/dv 80;
     hybrid   the same model, batch and recipe
              through the reference's hybrid recipe on one NCCL rank
              (init_parallel_env over a one-rank world on a free
              localhost port, fleet.init with dp = mp = 1,
              annotate_llama_tp, fleet.distributed_model /
              distributed_optimizer, TrainStep(mesh=hcg.get_mesh())): the
              5 losses bit for bit train's (at mp = 1 the Megatron layers
              are their serial selves; a one-rank all-reduce is exact),
              each flash kernel launched 80 times; step ms beside train's,
              the collectives a step by name, peak memory;
     hybrid_ranks
              several ranks on the one card, started by the port's spawn,
              over gloo with CUDA tensors (NCCL refuses two ranks on one
              device; a gloo all-reduce crosses the host, so the step
              times are no performance figure; run after zero, one world
              of each size running hybrid_ranks', zero_ranks' and
              pipeline_ranks' rows, one world after another):
              fp32 at 7B width and 1 layer, batch 2 x 1024, 2
              warmup/cosine AdamW steps with the clip, at dp = 2 and mp
              =
              2 (a world of 2) and dp = 2 x mp = 2 (a world of 4): every
              rank's losses equal, within 1e-5 relative of the same steps
              in one process, the parameters gathered whole on the card
              (the replicas' fingerprints equal) within 1e-5 of the
              one-process run except at most 1e-3 of the elements, each
              within 3 lr (how many is reported); then bf16 at train's
              depth, batch and recipe at mp = 2 (two micro-batches of 1 x
              4096 a rank): finite, falling losses within 1e-2 relative
              of train's first 2, each rank's #7-#9 launched 8 x 2 x 2
              times at 16 heads;
     zero     train's model, batch and recipe on
              one NCCL rank through fleet.init (sharding_degree = 1),
              annotate_llama_tp, group_sharded_parallel at "os", "os_g"
              and "p_g_os" in turn and TrainStep(mesh=hcg.get_mesh(),
              data_axes=("dp", "sharding")): at one sharding rank the ZeRO
              plan is empty, so each level's 3 losses equal train's first
              3 bit for bit, with hybrid's collectives a step and no
              other; #7-#9 launched 8 x 2 x 3 times a level; step ms and
              peak memory; then strategy.dgc (a Momentum turned into
              DGCMomentum by fleet.distributed_optimizer, rampup from step
              0, sparsity 0.999) 3 steps with finite losses, its step ms
              beside the plain Momentum's;
     zero_ranks
              ZeRO across ranks on the one card, through hybrid_ranks'
              rank body, checks and schedule: fp32 at 7B width and 1
              layer, 2 warmup/cosine AdamW steps with the clip, at
              sharding = 2 and stages 1, 2, 3 and LocalSGD at dp = 2 with
              k = 2 (a world of 2), dp = 2 x sharding = 2 at stage 2 (4 x
              512 tokens: 2 rows do not split over 4 data ranks) and
              sharding = 2 x mp = 2 at stage 3 (a world of 4), held as
              hybrid_ranks' fp32 rows (LocalSGD: two replicas in one
              process, averaged every second step); then, in the world of
              2, bf16 at train's depth, sharding = 2, each rank 1 x 4096
              of train's batch, at stage 3 (held as hybrid_ranks' bf16
              row, each rank's #7-#9 launched 8 x 2 times) and one step at
              stage 1 (its loss train's first within 1e-2): stage 3's
              resting memory (between steps) below stage 1's;
     pipeline_ranks
              pipeline parallelism across ranks
              on the one card through hybrid_ranks' rank body, checks and
              schedule, train's model carried into LlamaForCausalLMPipe
              (convert.pipe_name_map), each rank building only its stage,
              and PipelineTrainStep: fp32 at 7B width, 2 warmup/cosine
              AdamW steps with the clip, held as hybrid_ranks' fp32 rows
              to one process running the pipe built whole on the same
              microbatches (the stages gathered onto rank 0 under the
              whole model's names): pp = 2 at 2 layers on 2 x 1024 tokens in 2
              microbatches under 1F1B (remat), FThenB and zbh1 (no
              remat), pp = 2 at V = 2 (4 layers, 4 x 512), then bf16 at
              train's depth, batch and recipe at pp = 2 under 1F1B (2
              microbatches of 1 x 4096, 4 layers a rank), its 3 losses
              within 1e-2 of train's (a world of 2); pp = 2 x mp = 2
              (tensor_parallel=True) and pp = 2 x dp = 2 with ZeRO-1 over
              dp on 4 x 512 (a world of 4). Each rank's #8-#9 launched
              layers-on-the-rank x microbatches x steps times (and #7
              twice that under remat), its stage, peak and resting
              memory; activations and gradients cross between ranks
              through pinned host memory (gloo), so the step times are no
              performance figure;
     ep, sp_recompute (before the rank phases), ring_ranks, ep_ranks
              this slice's main paths: long context and experts across
              ranks. ep: MoEGPTConfig() widths at 4 layers, bf16, with
              expert_axis="dp" through fleet.init and TrainStep(mesh=
              hcg.get_mesh()) on one NCCL rank, 3 steps of 4 x 1024
              tokens bit for bit the same model's plain TrainStep, #7-#9
              12 each; sp_recompute: fleet.utils.recompute around each
              decoder layer of the 7B-width Llama at 2 layers (1 x 4096,
              bf16): gradients bit for bit without it, #7 4 and #8 / #9
              2, less memory added at the peak; and (a rank row in the
              world of 2) ColumnSequenceParallelLinear ->
              RowSequenceParallelLinear at 4096 -> 11008 -> 4096 over
              4096 tokens at mp = 2, fp32, with the hooks, every rank's
              out and gradients within 1e-4 of the pair on the whole
              sequence; ring_ranks (the worlds of 2 and 4): Llama-2-7B's
              attention (32 heads of 128, B = 1) over 16384 tokens, fp32
              and bf16, forward and backward, each rank on its contiguous
              chunk: the ring contiguous causal (ring_flash_attention) and
              not causal at sep = 2, zigzag causal at sep = 4
              (sep_scaled_dot_product_attention), Ulysses at sep = 4 with
              the flash kernel as attn_fn, the zigzag ring at 70B's heads
              (64 over 8) at sep = 4: each rank's out, dq, dk, dv within
              RING_TOL (fp32 1e-4, bf16 3e-2 of the largest element) of
              the whole sequence's flash_attention_bshd in its process,
              #7-#9 launched once a ring unit (the schedule's count);
              ep_ranks: MoEGPTConfig() widths at 2 layers, 4 x 1024
              tokens, 3 steps, fp32 at dp = 2 without expert parallelism
              (the routing of the global batch), with expert_axis="dp" at
              dp = 2 (4 experts a rank) and dp = 4 (2), bf16 EP at dp = 2:
              every rank's losses equal; fp32 within 1e-5 relative of one
              process on the same rows, the parameters gathered whole
              (expert slices all-gathered over dp) held as hybrid_ranks';
              bf16 within 1e-2; #7-#9 2 x 3 a rank;
     fit      the slice's main path: Model.fit on the same width at 4
              layers, amp.decorate(O2, bf16) without f32 masters (its two
              checkpoints and fit_faults' two must stay within what a call
              may write), AdamW over
              two parameter groups with no decay on the norms,
              warmup/cosine LR, global-norm clip and
              LlamaPretrainingCriterion, over a DataLoader of 16 seeded
              4096-token rows (batch 2, shuffled under a seed, split in 2
              micro-batches, prefetched to the card), 6 steps, the loss
              pulled every 2 steps, with the LRScheduler, EarlyStopping
              and ModelCheckpoint callbacks (under build/fit_ckpt, removed
              after): finite losses, the first equal to a bare
              TrainStep's on the same first batch, each flash kernel
              launched 48 times, the final checkpoint loading back into a
              fresh model with equal parameters; step time on the card's
              clock beside a bare TrainStep loop's on the same batches,
              tokens/s, MFU, peak memory and the host's share of time
              blocked on loss reads;
     io       the rest of training input at fit's model (2 layers, amp
              O2, AdamW over two groups, batch 2 of 4096 tokens, one
              epoch of 8 steps, the loss read every step): Model.fit over
              fit's shuffled TensorDataset served by the native C++
              prefetcher (io_core.cpp built with g++ into build/native/),
              its batches in native.shuffled_indices' order at seed + 1;
              a map-style dataset whose __getitem__ runs a GIL-bound
              pure-Python transform (48 passes over a 4097-token row)
              under 4 thread workers, then 4 process workers
              (use_process_workers=True), then 4 process workers under
              FLAGS_fault_inject="dataloader_worker:every=2" (8 restarts a
              worker allowed): the same batches in sampler order and the
              same per-step losses as the thread run, bit for bit;
              io_worker_restarts equal to the workers replaced, each dead
              with the fault's exit code 3; the transform alone under 4
              threads and 4 processes over 64 rows (rows/s, seconds to the
              first batch, rows/s after it); fit step ms on the card's
              clock beside a bare TrainStep over the same batches (idle
              share 1 - bare / fit); #7-#9 2 layers x 8 steps a run;
     fit_faults
              fit's recipe at 2 layers under FLAGS_fault_inject=
              "train_dispatch:every=4:times=1;train_sync:every=2:times=1;
              checkpoint_save:every=1:times=1" with its save_dir under
              build/fit_faults (a ModelCheckpoint without a directory, so
              only emergency checkpoints are written): every fault
              recovered, the recovery counters and faults_injected{site}
              equal to the schedule, the emergency checkpoint loading
              back, the final parameters bit for bit those of a
              fault-free fit over the same batches, each flash kernel
              launched 2 x 2 x 6 times (the failed dispatch launched
              nothing); train_max_retries=1 under train_dispatch:every=1
              raising InjectedFault; nan_policy="stop" on a NaN loss at
              the end of epoch 0 (of 2) writing the checkpoint and
              stopping after that epoch; the recovery ms and the
              emergency save's seconds and bytes;
  7. train_parity
              one fp32 TrainStep at full width, 2 layers, S=512 on the card
              (kernels) and on a CPU copy (plain versions): losses and every
              gradient before the update agree;
  8. train_varlen
              packed-sequence training and the fused RMSNorm, bf16, through
              the public entry points with the launch counts read around
              them (exact): fused_rms_norm with a residual, forward and
              backward, at 8192 x 4096 (7B) and 4096 x 8192 (70B);
              flash_attn_unpadded, forward and backward, on an 8192-token
              pack of 6 documents at Llama-2-7B heads and a 4096-token pack
              of 4 at Llama-2-70B heads (GQA); variable_length_memory_
              efficient_attention forward at B=4, S=2048, ragged lengths.
              The packs are held document by document to the plain causal
              attention of each document alone, the RMSNorm to autograd of
              its plain twin. Then each kernel (RMSNorm forward and dx, the
              segment-id variants of the flash kernels) against its plain
              twin on the same card tensors, bf16 and fp32 (the flash twins
              in groups of kv heads, so the dense f32 scores stay small),
              with kernel, plain, library (torch.nn.functional.rms_norm;
              SDPA per document, summed) and bound times (the flash
              kernels also bound_frac).
  9. nan_check
              FLAGS_check_nan_inf on a 2-layer bf16 Llama at 7B width, a
              forward and backward of one 1024-token row: off, no dispatch
              mode installed; on, a clean step's loss equal to the
              unchecked one; a NaN planted in layer 1's down projection
              raises FloatingPointError naming the first ATen op whose
              output is not finite (a matmul), the op the level-1 run
              warns about first, and level 1 completes with a NaN loss;
              the checked step's ms against the unchecked one.
Then the card's name and power limit (nvidia-smi), the per-kernel summary
line, and as the last line {"ok": true, "device": {...}}.

Without a CUDA card the script exits with code 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,         # dense tensor-core bf16
              torch.float32: 67e12}           # f32 outside the tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
DTYPE_NAME = {torch.bfloat16: "bf16", torch.float32: "fp32"}

# Llama-2-7B geometry (the serving path's kernel shapes)
HIDDEN, HEADS, KV_HEADS, HEAD_DIM, INTER = 4096, 32, 32, 128, 11008
PAGE, MAX_SEQ, BATCH = 64, 1024, 4
PREFILL_LENS = (77, 256)
PROMPT_LENS = (17, 256, 64, 100, 200, 33, 128, 250)
NEW_TOKENS = 32
SEED = 1234
# serve_long: the model's whole context, the default 256-token chunk
LONG_MAX_SEQ, CHUNK = 4096, 256
LONG_PROMPT_LENS = (3500, 40, 1800, 257, 700, 120, 2900, 512)
# the decode contexts of serve_long's four long prompts (one batch slot each)
LONG_DECODE_LENS = (3500, 2900, 1800, 700)
GROUP_LAYERS = 4                  # FLAGS_fused_block_layers of the N run
# chunk attention: (start, S) of the main chunk and of a ragged final one
CHUNK_SHAPES = ((3840, 100), (3328, 256))
# and a second query, 8x the first: logits spread ~8, so a few keys carry
# each row's softmax and the outputs are O(1) (at spread 1 over ~3.4 k keys
# they are ~0.03), where one key masked or paged wrongly shows
PEAKED_Q = 8.0
PARITY_LENS, PARITY_NEW_TOKENS = (17, 77, 130, 256, 300, 700), 8
PARITY_TOL = 1e-3      # fp32 logits: kernel sums vs torch.matmul order

# training attention: (case, batch, S, heads, kv heads), head_dim 128
TRAIN_SHAPES = (("llama2_7b heads", 1, 4096, 32, 32),
                ("llama2_70b heads, GQA", 1, 2048, 64, 8),
                ("ragged, GQA", 2, 1000, 32, 8))
# GPT-3 345M's heads (16 MHA heads of dim 64, the moe phase's batch of 4 x
# 1024 tokens): (case, batch, S, heads, kv heads, head_dim, causal); the
# moe phase runs them causal, the fused attention layers not causal
GPT_TRAIN_SHAPES = (("gpt3_345m heads", 4, 1024, 16, 16, 64, True),
                    ("gpt3_345m heads, non-causal", 4, 1024, 16, 16, 64,
                     False))
# SD-1.5's UNet attention (the unet phase's batch of 2, 8 heads, not
# causal): self-attention over the latent tokens at each resolution, and
# cross-attention of the same queries against the 77 text tokens. Case,
# batch, Sq, heads, kv heads, head_dim, causal, Skv
UNET_CONTEXT = 77
UNET_ATTN_SHAPES = tuple(
    (f"sd15 {kind} attention, D={d}", 2, s, 8, 8, d, False, skv)
    for s, d in ((4096, 40), (1024, 80), (256, 160), (64, 160))
    for kind, skv in (("self", s), ("cross", UNET_CONTEXT)))
# the hybrid phases' attention at mp = 2: Llama-2-7B's 32 heads cut to a
# rank's 16 (case, batch, S, heads, kv heads), head_dim 128, causal
HYBRID_SHARD_SHAPES = (("llama2_7b heads, mp=2 shard", 1, 4096, 16, 16),)
# ring_ranks' chunk attention at Llama-2-7B's heads over S = 16384: a ring
# unit is one chunk against one chunk, causal on the diagonal and full off
# it, at C = 8192 (sep = 2) and C = 4096 (sep = 4, and the zigzag ring's
# half-chunks at sep = 2); TRAIN_SHAPES' first row is the C = 4096
# diagonal (case, batch, S, heads, kv heads, head_dim, causal, Skv)
RING_CHUNK_SHAPES = tuple(
    (f"ring chunk C={c}, {'causal diagonal' if causal else 'full'}", 1, c,
     32, 32, HEAD_DIM, causal, c)
    for c, causal in ((8192, True), (8192, False), (4096, False)))
# every shape check_flash_attention holds, in UNET_ATTN_SHAPES' layout
FLASH_ATTN_SHAPES = (tuple(t + (HEAD_DIM, True, t[2])
                           for t in TRAIN_SHAPES + HYBRID_SHARD_SHAPES)
                     + tuple(t + (t[2],) for t in GPT_TRAIN_SHAPES)
                     + UNET_ATTN_SHAPES + RING_CHUNK_SHAPES)
# flash forward: out within atol + rtol |ref| elementwise (rtol: one bf16
# ulp, as both sides round the same f32 value), the f32 lse within abs
OUT_TOL = {torch.bfloat16: (1e-3, 2.0 ** -7), torch.float32: (1e-4, 0.0)}
# the int8-pool attention kernels against their plain versions on the same
# pool bits (the dequantized values are identical; only sums differ)
QUANT_OUT_TOL = {torch.bfloat16: (1e-3, 2.0 ** -7),
                 torch.float32: (1e-5, 0.0)}
# a new token's appended int8 row, kernel vs plain: the two f32 k/v may
# differ in the last bits (another summation order), so a payload may
# differ by 1 and a scale by relative 1e-6; in bf16 the row is quantized
# from bf16 k/v, where such a difference can become one bf16 step of the
# row's amax (2^-8 relative)
SCALE_RTOL = {torch.bfloat16: 2.0 ** -8, torch.float32: 1e-6}
# #4's int8 variant at the spec phase's chunk shapes: QUANT_OUT_TOL, but
# in fp32 the native variant's OUT_TOL. From 700 tokens a chunk of S <= 9
# walks its prefix in more parts than S = 100 or 256 (prefill_splits), so
# the kernel's partial sums combine in another order than the plain
# version's: the native rows at these shapes read up to 2e-5 in fp32 too
SPEC_QUANT_OUT_TOL = {torch.bfloat16: QUANT_OUT_TOL[torch.bfloat16],
                      torch.float32: OUT_TOL[torch.float32]}
LSE_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-4}
GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # max|a-b|/max|b|
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM = 8, 4096, 2, 2
TRAIN_STEPS = 5
TRAIN_PARITY_LAYERS, TRAIN_PARITY_SEQ = 2, 512
TRAIN_PARITY_LOSS_TOL = 1e-4    # relative, fp32 (TF32 off)
TRAIN_PARITY_GRAD_TOL = 1e-3    # relative L2 per parameter
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
# flash_attention_with_lse: the Llama-2-7B and Llama-2-70B head shapes; the
# log-space merge of two half-key calls against the whole call, abs
WITH_LSE_SHAPES = TRAIN_SHAPES[:2]
MERGE_TOL = {torch.bfloat16: 2e-3, torch.float32: 1e-4}
# moe: MoEGPTConfig() at full depth, MOE_STEPS steps of MOE_BATCH x MOE_SEQ
# tokens; moe_parity at its width, 2 layers (one dense, one MoE block), fp32
MOE_STEPS, MOE_BATCH, MOE_SEQ = 5, 4, 1024
MOE_PARITY_LAYERS, MOE_PARITY_SEQ = 2, 512
# fused_layers: the fused attention layers at GPT-3 345M's width
FUSED_BATCH, FUSED_SEQ = 4, 1024
# unet: UNetConfig.sd15() at full depth, UNET_WARMUP then UNET_STEPS steps
# of UNET_BATCH latents (the JAX bench's batch, AdamW and learning rate);
# unet_parity at SD-1.5's widths cut to 3 blocks of 1 layer at 32 x 32
UNET_BATCH, UNET_WARMUP, UNET_STEPS, UNET_LR = 2, 2, 5, 1e-4
UNET_SD15_ATTENTION_CALLS = 32          # 16 transformers x self and cross
UNET_PARITY_BLOCKS, UNET_PARITY_SIZE = (320, 640, 1280), 32
# bert: bert-base pretraining on BERT_BATCH x BERT_SEQ tokens, ragged real
# lengths of at least BERT_MIN_LEN; bert_parity at 2 layers, no dropout
BERT_BATCH, BERT_SEQ, BERT_MIN_LEN = 8, 512, 128
BERT_WARMUP, BERT_STEPS, BERT_LR = 2, 5, 1e-4
BERT_MLM_SHARE, BERT_MASK_ID = 0.15, 103  # [MASK] in bert-base-uncased
BERT_PARITY_LAYERS, BERT_PARITY_BATCH, BERT_PARITY_SEQ = 2, 2, 256
# fit: Model.fit at the train phase's width, 2 layers, over a DataLoader of
# seeded 4096-token rows, batch 2 split in 2 micro-batches, 6 steps. The
# depth keeps what a chip call may write (fit's two checkpoints, 12 bytes a
# parameter: bf16 saved as f32 and AdamW's two f32 slots, and fit_faults'
# two emergency checkpoints) under 45 GiB together, and the script's time
# under its limit (4 layers until the pipeline's rows joined)
FIT_LAYERS = 2
FIT_ROWS, FIT_BATCH, FIT_ACCUM, FIT_STEPS, FIT_METRICS_EVERY = 16, 2, 2, 6, 2
FIT_CKPT_DIR = "build/fit_ckpt"
# fit_faults: fit's recipe at 2 layers under a fault schedule (the dispatch
# fault's recovery meets the sync fault in its drain and the save fault in
# its emergency checkpoint); its checkpoints under build/fit_faults
FAULTS_LAYERS = 2
FIT_FAULT_SPEC = ("train_dispatch:every=4:times=1;train_sync:every=2:times=1;"
                  "checkpoint_save:every=1:times=1")
FIT_FAULTS_DIR = "build/fit_faults"
# nan_check: a 2-layer bf16 forward and backward of one 1024-token row
NAN_LAYERS, NAN_SEQ = 2, 1024
# train_varlen: fused RMSNorm (case, rows, width), eps of Llama-2
RMS_SHAPES = (("llama2_7b width", 8192, 4096),
              ("llama2_70b width", 4096, 8192))
RMS_EPS = 1e-5
# packed documents through flash_attn_unpadded: (case, lengths, H, Hkv)
VARLEN_PACKS = (("llama2_7b heads, 8192-token pack",
                 (3500, 2900, 1000, 700, 75, 17), 32, 32),
                ("llama2_70b heads, 4096-token pack, GQA",
                 (2000, 1500, 300, 296), 64, 8))
# variable_length_memory_efficient_attention: B x S at 7B heads
VLMEA_LENS, VLMEA_SEQ = (2048, 1500, 700, 33), 2048
PLAIN_KV_GROUPS = 8     # the dense twins run over 8 slices of the kv heads
VARLEN_KERNELS = ("rms_norm_fwd", "rms_norm_bwd_dx",
                  "flash_attention_fwd_seg", "flash_attention_bwd_dq_seg",
                  "flash_attention_bwd_dkv_seg")

# the quantized variants of a kernel: an int8 KV pool, int4 weight tiles
# and the flash kernels' segment-id variant
VARIANTS = {"paged_attention": ("int8",), "paged_chunk_attention": ("int8",),
            "fused_block_decode": ("int8",),
            "fused_multi_block_decode": ("int8", "int4", "int8_int4"),
            "flash_attention_fwd": ("seg",),
            "flash_attention_bwd_dq": ("seg",),
            "flash_attention_bwd_dkv": ("seg",)}
SOURCES = {
    "flash_prefill": ("paddle_tpu_torch/kernels/csrc/flash_prefill.cu",
                      "paddle_tpu/kernels/decode_attention.py:140"),
    "paged_attention": ("paddle_tpu_torch/kernels/csrc/paged_attention.cu",
                        "paddle_tpu/kernels/paged_attention.py:154"),
    "paged_chunk_attention": (
        "paddle_tpu_torch/kernels/csrc/paged_chunk_attention.cu",
        "paddle_tpu/kernels/paged_attention.py:311"),
    "fused_block_decode": (
        "paddle_tpu_torch/kernels/csrc/fused_block_decode.cu",
        "paddle_tpu/kernels/fused_block_decode.py:265"),
    "fused_multi_block_decode": (
        "paddle_tpu_torch/kernels/csrc/fused_multi_block_decode.cu",
        "paddle_tpu/kernels/fused_block_decode.py:903"),
    "flash_attention_fwd": (
        "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
        "paddle_tpu/kernels/flash_attention.py:253"),
    "flash_attention_bwd_dq": (
        "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
        "paddle_tpu/kernels/flash_attention.py:453"),
    "flash_attention_bwd_dkv": (
        "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
        "paddle_tpu/kernels/flash_attention.py:486"),
    "rms_norm_fwd": ("paddle_tpu_torch/kernels/csrc/rms_norm.cu",
                     "paddle_tpu/kernels/rms_norm.py:46"),
    "rms_norm_bwd_dx": ("paddle_tpu_torch/kernels/csrc/rms_norm.cu",
                        "paddle_tpu/kernels/rms_norm.py:53"),
}
# each variant is a branch of its kernel's source and of its TPU kernel
SOURCES = {name: entry for base, src in SOURCES.items()
           for name, entry in [(base, src)] + [
               (f"{base}_{v}", src) for v in VARIANTS.get(base, ())]}


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line of ``phase``'s fields and the script's seconds so
    far (``at_s``)."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - _T0}), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
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


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``calls`` back-to-back calls
    captured in one CUDA graph and replayed, so the host's enqueue cost is
    left out (a kernel of a few tens of microseconds is otherwise timed at
    the pace of the host's Python)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, iters=reps, warmup=2) / calls


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa(q, k, v, **kw):
    """The library yardstick: PyTorch's fused attention, (B, H, S, D)."""
    if q.shape[1] != k.shape[1]:
        kw["enable_gqa"] = True
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, **kw)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def excess(a: torch.Tensor, ref: torch.Tensor, rtol: float) -> float:
    """The largest amount by which |a - ref| exceeds rtol |ref|, held to
    an atol (OUT_TOL's elementwise check)."""
    ref = ref.detach().float()
    return float(((a.detach().float() - ref).abs() - rtol * ref.abs()).max())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def quantized(pool):
    """A native pool, quantized per row into an int8 QuantizedPages."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    return pa.QuantizedPages(*pa.quantize_kv_rows(pool))


def clone_pool(pool):
    if isinstance(pool, torch.Tensor):
        return pool.clone()
    return type(pool)(pool.q.clone(), pool.scale.clone())


def copy_pool(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        dst.q.copy_(src.q)
        dst.scale.copy_(src.scale)


def row_bytes(quant: bool, elem: int) -> int:
    """Bytes of one stored k or v row: D + 4 (int8 + f32 scale) or D elem."""
    return HEAD_DIM + 4 if quant else HEAD_DIM * elem


def rows_differ(got, want, dtype, what):
    """Appended int8 rows, kernel vs plain: payload within 1, scales within
    SCALE_RTOL; returns how many payload and scale elements differ."""
    dq = (got.q.int() - want.q.int()).abs()
    rel = ((got.scale - want.scale).abs()
           / want.scale.abs().clamp_min(1e-30))
    require(int(dq.max()) <= 1, f"{what}: payload off by {int(dq.max())}")
    require(float(rel.max()) <= SCALE_RTOL[dtype],
            f"{what}: scale off by {float(rel.max())} relative")
    return int((dq > 0).sum()), int((rel > 0).sum())


# --------------------------------------------------------------- kernels
def _rand(gen, shape, dtype, device, scale=1.0):
    t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (t * scale).to(dtype)


def _block_tables(seq_lens, extra_tokens, device, max_seq=MAX_SEQ):
    """Shuffled block tables over a pool whose page 0 is the null page;
    an idle row (seq_len 0) keeps an all-zero table."""
    maxp = -(-max_seq // PAGE)
    num_pages = 1 + BATCH * maxp
    perm = np.random.default_rng(SEED).permutation(num_pages - 1) + 1
    bt = np.zeros((len(seq_lens), maxp), np.int32)
    used = 0
    for i, n in enumerate(seq_lens):
        pages = -(-(n + extra_tokens) // PAGE) if n else 0
        bt[i, :pages] = perm[used:used + pages]
        used += pages
    return torch.from_numpy(bt).to(device), num_pages


def check_flash_prefill(dtype, device, results):
    from paddle_tpu_torch.kernels import decode_attention as da
    gen = torch.Generator(device=device).manual_seed(SEED)
    for s in PREFILL_LENS:
        q = _rand(gen, (1, s, HEADS, HEAD_DIM), dtype, device)
        k = _rand(gen, (1, s, KV_HEADS, HEAD_DIM), dtype, device)
        v = _rand(gen, (1, s, KV_HEADS, HEAD_DIM), dtype, device)
        got = da.flash_prefill(q, k, v, s)
        want = da.flash_prefill_ref(q, k, v, s)
        torch.cuda.synchronize()
        err = max_err(got, want)
        require(err <= TOL[dtype], f"flash_prefill S={s} {dtype}: max err "
                f"{err} > {TOL[dtype]}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
        elem = q.element_size()
        nbytes = elem * (2 * q.numel() + k.numel() + v.numel())
        pairs = s * (s + 1) // 2                 # causal (query, key) pairs
        flops = 4.0 * pairs * HEADS * HEAD_DIM
        bms, by = bound_ms(nbytes, flops, dtype)
        kms = time_ms(lambda: da.flash_prefill(q, k, v, s))
        results.append(dict(
            kernel="flash_prefill", dtype=DTYPE_NAME[dtype], S=s,
            max_err=err, tol=TOL[dtype], kernel_ms=kms,
            plain_ms=time_ms(lambda: da.flash_prefill_ref(q, k, v, s)),
            library_ms=lib, bound_ms=bms, bound_by=by, bound_frac=bms / kms))
    # GQA, a cache longer than the prompt (cur_len > S) and a ragged tail
    q = _rand(gen, (2, 50, HEADS, HEAD_DIM), dtype, device)
    k = _rand(gen, (2, 301, HEADS // 4, HEAD_DIM), dtype, device)
    v = _rand(gen, (2, 301, HEADS // 4, HEAD_DIM), dtype, device)
    err = max_err(da.flash_prefill(q, k, v, 290),
                  da.flash_prefill_ref(q, k, v, 290))
    require(err <= TOL[dtype], f"flash_prefill GQA/ragged {dtype}: {err}")
    results.append(dict(kernel="flash_prefill", dtype=DTYPE_NAME[dtype],
                        case="gqa rep=4, T=301, cur_len=290, S=50",
                        max_err=err, tol=TOL[dtype]))


# #1 at generation's shapes: (case, B, S, T, cur_len, H, Hkv, D). The
# draft's prefill (TinyLlama-1.1B heads, 32 over 4 of dim 64), generate's
# prefill into its P + N ring buffer, and generate_speculative's verify of
# γ + 1 = 3, 5, 9 queries from 700 written tokens of an 800-position ring
# buffer at 7B heads. Past cur_len the caches hold junk (+-1e4), so a row
# that reads a masked position shows a large error
GEN_PREFILL_CASES = (
    ("draft prefill, D=64, 32 over 4 heads", 1, 256, 256, 256, 32, 4, 64),
    ("ring buffer T=P+N", 4, 128, 160, 128, HEADS, KV_HEADS, HEAD_DIM),
) + tuple((f"speculative verify S={s}", 1, s, 800, 700 + s, HEADS, KV_HEADS,
           HEAD_DIM) for s in (3, 5, 9))
RING_JUNK = 1e4


def check_generation_prefill(dtype, device, results):
    """#1 at GEN_PREFILL_CASES (prefill_row)."""
    from paddle_tpu_torch.kernels import decode_attention as da
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    for case in GEN_PREFILL_CASES:
        results.append(prefill_row(da, gen, dtype, device, *case,
                                   mark="generation"))
    torch.cuda.empty_cache()


def prefill_row(da, gen, dtype, device, case, b, s, t, cur, h, hkv, d,
                mark):
    """#1 at one shape against flash_prefill_ref (caches +-RING_JUNK past
    cur_len), with SDPA over the valid prefix (the queries' causal order
    as a mask: they sit at the prefix's end) and the bound of the work the
    valid prefix needs; the back-to-back times and device_ms from calls
    replayed from a CUDA graph (a verify's calls are tens of
    microseconds). The row carries ``mark`` (True), which keeps it out of
    the summary's main row."""
    q = _rand(gen, (b, s, h, d), dtype, device)
    k = _rand(gen, (b, t, hkv, d), dtype, device)
    v = _rand(gen, (b, t, hkv, d), dtype, device)
    k[:, cur:] = RING_JUNK
    v[:, cur:] = -RING_JUNK
    got = da.flash_prefill(q, k, v, cur)
    want = da.flash_prefill_ref(q, k, v, cur)
    torch.cuda.synchronize()
    err = max_err(got, want)
    require(err <= TOL[dtype], f"flash_prefill {case} {dtype}: max err "
            f"{err} > {TOL[dtype]}")
    qt = q.transpose(1, 2)
    kt, vt = (x[:, :cur].transpose(1, 2) for x in (k, v))
    mask = (torch.arange(cur, device=device)[None, :]
            <= (cur - s + torch.arange(s, device=device))[:, None])
    elem = q.element_size()
    nbytes = elem * (2 * q.numel() + 2 * b * cur * hkv * d)
    pairs = s * (cur - s) + s * (s + 1) // 2      # visible (query, key)
    flops = 4.0 * b * pairs * h * d
    bms, by = bound_ms(nbytes, flops, dtype)

    def call():
        da.flash_prefill(q, k, v, cur)

    def lib():
        sdpa(qt, kt, vt, attn_mask=mask)

    kms = time_ms(call)
    return dict(
        kernel="flash_prefill", dtype=DTYPE_NAME[dtype], case=case,
        B=b, S=s, T=t, cur_len=cur, heads=h, kv_heads=hkv, head_dim=d,
        max_err=err, tol=TOL[dtype], kernel_ms=kms,
        plain_ms=time_ms(lambda: da.flash_prefill_ref(q, k, v, cur)),
        library_ms=time_ms(lib), bound_ms=bms, bound_by=by,
        bound_frac=bms / kms,
        device_ms=dict(kernel=graph_ms(call), library=graph_ms(lib)),
        **{mark: True})


# paged_attention's shapes: (case, seq_lens, the table's max_seq, whether
# page 0 is the null page); at serve_long's decode contexts the split-KV
# walk has the most parts to fill. generate_paged's last step: 4 equal rows
# (P = 128, N = 32) over a pool with no null page, each row's pages
# consecutive from page 0, as its allocator hands them out
# (case, lengths, table span, null page, tp): at tp > 1 the kernel runs
# on one shard's kv-head partition of a 7B pool (a view, as the TP decode
# chain passes it), 32 / tp heads over 32 / tp kv heads
PAGED_SHAPES = (("generate_paged", (160,) * BATCH, 160, False, 1),
                ("serve", (MAX_SEQ, MAX_SEQ // 2 + 5, MAX_SEQ // 13 + 1, 0),
                 MAX_SEQ, True, 1),
                ("serve_long decode", LONG_DECODE_LENS, LONG_MAX_SEQ, True,
                 1),
                ("tp shard", (MAX_SEQ, MAX_SEQ // 2 + 5, MAX_SEQ // 13 + 1,
                              0), MAX_SEQ, True, 2))


def _rect_tables(rows, max_seq, device):
    """Block tables of a pool with no null page: row i owns pages
    i * maxp .. (i + 1) * maxp - 1."""
    maxp = -(-max_seq // PAGE)
    bt = torch.arange(rows * maxp, dtype=torch.int32, device=device)
    return bt.reshape(rows, maxp), rows * maxp


def check_paged_attention(dtype, device, results):
    """The split-KV decode attention on native and int8 pools against its
    plain version, at serve's ragged lengths (1024, 517, 79 at 7B, one
    idle row) and at serve_long's decode contexts; SDPA over the gathered
    pool (native) and the bytes bound beside each, and bound_frac. Besides
    the back-to-back times (the host's pace at these sizes), device_ms
    replays the kernel's and SDPA's calls from a CUDA graph."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    for case, seq_lens, max_seq, null_page, tp in PAGED_SHAPES:
        seq_lens = list(seq_lens)
        bt, num_pages = (_block_tables(seq_lens, 0, device, max_seq)
                         if null_page else
                         _rect_tables(len(seq_lens), max_seq, device))
        mark = {} if null_page else {"generation": True}
        if tp > 1:
            mark = {"tp": tp}
        sl = torch.tensor(seq_lens, dtype=torch.int32, device=device)
        idle = sl == 0
        heads, kv_heads = HEADS // tp, KV_HEADS // tp
        shape = (KV_HEADS, num_pages, PAGE, HEAD_DIM)
        kf, vf = (_rand(gen, shape, dtype, device) for _ in range(2))
        # the last shard's partition (a view at an offset into the pool)
        kp, vp = (pa.shard_pool(x, tp - 1, tp) for x in (kf, vf))
        q = _rand(gen, (BATCH, heads, HEAD_DIM), dtype, device)
        got = pa.paged_attention(q, kp, vp, bt, sl)
        want = pa.paged_attention_ref(q, kp, vp, bt, sl)
        torch.cuda.synchronize()
        err = max_err(got, want)
        require(err <= TOL[dtype], f"paged_attention {case} {dtype}: max "
                f"err {err}")
        require(not got[idle].any(), "paged_attention: idle row must read "
                "zeros")
        # library yardstick: SDPA over the gathered contiguous view
        t = bt.shape[1] * PAGE
        kg, vg = (x[:, bt.long()].movedim(1, 0).reshape(
            BATCH, kv_heads, t, HEAD_DIM) for x in (kp, vp))
        mask = (torch.arange(t, device=device)[None, :] < sl[:, None])
        mask = mask[:, None, None, :]
        qs = q[:, :, None, :]
        lib = time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask))
        elem = q.element_size()
        live = sum(seq_lens)
        index_bytes = 4 * (bt.numel() + sl.numel())
        nbytes = (elem * (2 * q.numel() + 2 * live * kv_heads * HEAD_DIM)
                  + index_bytes)
        flops = 4.0 * live * heads * HEAD_DIM
        bms, by = bound_ms(nbytes, flops, dtype)
        kms = time_ms(lambda: pa.paged_attention(q, kp, vp, bt, sl))
        dev_ms = dict(
            kernel=graph_ms(lambda: pa.paged_attention(q, kp, vp, bt, sl)),
            library=graph_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask)))
        del kg, vg
        results.append(dict(
            kernel="paged_attention", dtype=DTYPE_NAME[dtype], case=case,
            seq_lens=seq_lens, max_err=err, tol=TOL[dtype], kernel_ms=kms,
            plain_ms=time_ms(lambda: pa.paged_attention_ref(q, kp, vp, bt,
                                                            sl)),
            library_ms=lib, bound_ms=bms, bound_by=by, bound_frac=bms / kms,
            device_ms=dev_ms, **mark))
        # the int8 pool: the same rows quantized, kernel vs plain on its bits
        kq, vq = (pa.shard_pool(quantized(x), tp - 1, tp) for x in (kf, vf))
        got = pa.paged_attention(q, kq, vq, bt, sl)
        want = pa.paged_attention_ref(q, kq, vq, bt, sl)
        torch.cuda.synchronize()
        atol, rtol = QUANT_OUT_TOL[dtype]
        err, over = max_err(got, want), excess(got, want, rtol)
        require(over <= atol, f"paged_attention int8 {case} {dtype}: {over} "
                f"over {rtol} |ref|, max err {err}")
        require(not got[idle].any(), "paged_attention int8: idle row must "
                "read 0")
        nbytes = (elem * 2 * q.numel()
                  + 2 * live * kv_heads * row_bytes(True, 0) + index_bytes)
        bms, by = bound_ms(nbytes, flops, dtype)
        kms = time_ms(lambda: pa.paged_attention(q, kq, vq, bt, sl))
        results.append(dict(
            kernel="paged_attention_int8", dtype=DTYPE_NAME[dtype],
            case=case, seq_lens=seq_lens, max_err=err, excess=over,
            atol=atol, rtol=rtol, kernel_ms=kms,
            plain_ms=time_ms(lambda: pa.paged_attention_ref(q, kq, vq, bt,
                                                            sl)),
            library_ms=None, bound_ms=bms, bound_by=by, bound_frac=bms / kms,
            device_ms=dict(kernel=graph_ms(
                lambda: pa.paged_attention(q, kq, vq, bt, sl))), **mark))
        del kf, vf, kp, vp, kq, vq
        torch.cuda.empty_cache()


def check_paged_chunk_attention(dtype, device, results):
    """A prefill chunk at Llama-2-7B heads against the 4096-token table of
    serve_long: its k/v written first (write-then-attend), then the kernel
    against the plain version for a spread and a peaked softmax, each
    within OUT_TOL elementwise (in bf16 1e-3 + one bf16 ulp of the plain
    output), SDPA on the gathered prefix with an explicit bottom-right
    causal mask, and the bound."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    bt, num_pages = _block_tables([LONG_MAX_SEQ], 0, device, LONG_MAX_SEQ)
    shape = (KV_HEADS, num_pages, PAGE, HEAD_DIM)
    for start, s in CHUNK_SHAPES:
        kp, vp = (_rand(gen, shape, dtype, device) for _ in range(2))
        st = torch.tensor([start], dtype=torch.int32, device=device)
        k_new, v_new = (_rand(gen, (1, s, KV_HEADS, HEAD_DIM), dtype, device)
                        for _ in range(2))
        pa.write_paged_prompt_at(kp, vp, k_new, v_new, bt, st)
        q = _rand(gen, (1, s, HEADS, HEAD_DIM), dtype, device)
        atol, rtol = OUT_TOL[dtype]
        errs, over = {}, {}
        for case, qc in (("spread", q), ("peaked", q * PEAKED_Q)):
            got = pa.paged_chunk_attention(qc, kp, vp, bt, st)
            want = pa.paged_chunk_attention_ref(qc, kp, vp, bt, st)
            torch.cuda.synchronize()
            errs[case], over[case] = max_err(got, want), excess(got, want,
                                                                rtol)
            require(over[case] <= atol, f"paged_chunk_attention start="
                    f"{start} S={s} {dtype} {case}: {over[case]} over "
                    f"{rtol} |ref|, max err {errs[case]}")
        t = start + s
        kg, vg = (p[:, bt[0].long()].reshape(KV_HEADS, -1, HEAD_DIM)
                  [None, :, :t] for p in (kp, vp))
        mask = (torch.arange(t, device=device)[None, :]
                <= start + torch.arange(s, device=device)[:, None])
        qt = q.transpose(1, 2)
        lib = time_ms(lambda: sdpa(qt, kg, vg, attn_mask=mask))
        elem = q.element_size()
        nbytes = (elem * (2 * q.numel() + 2 * t * KV_HEADS * HEAD_DIM)
                  + 4 * (bt.numel() + 1))
        pairs = s * start + s * (s + 1) // 2     # (query, key) pairs seen
        bms, by = bound_ms(nbytes, 4.0 * pairs * HEADS * HEAD_DIM, dtype)
        kms = time_ms(lambda: pa.paged_chunk_attention(q, kp, vp, bt, st))
        results.append(dict(
            kernel="paged_chunk_attention", dtype=DTYPE_NAME[dtype],
            start=start, S=s, max_err=max(errs.values()),
            max_err_spread=errs["spread"], max_err_peaked=errs["peaked"],
            excess=max(over.values()), atol=atol, rtol=rtol, kernel_ms=kms,
            plain_ms=time_ms(lambda: pa.paged_chunk_attention_ref(
                q, kp, vp, bt, st), iters=5, warmup=1),
            library_ms=lib, bound_ms=bms, bound_by=by, bound_frac=bms / kms))
        # the int8 pool: the written pool quantized, kernel vs plain on its
        # bits, spread and peaked
        kq, vq = quantized(kp), quantized(vp)
        del kp, vp, kg, vg
        atol, rtol = QUANT_OUT_TOL[dtype]
        for case, qc in (("spread", q), ("peaked", q * PEAKED_Q)):
            got = pa.paged_chunk_attention(qc, kq, vq, bt, st)
            want = pa.paged_chunk_attention_ref(qc, kq, vq, bt, st)
            torch.cuda.synchronize()
            errs[case], over[case] = max_err(got, want), excess(got, want,
                                                                rtol)
            require(over[case] <= atol, f"paged_chunk_attention int8 start="
                    f"{start} S={s} {dtype} {case}: {over[case]} over "
                    f"{rtol} |ref|, max err {errs[case]}")
        nbytes = (elem * 2 * q.numel() + 2 * t * KV_HEADS
                  * row_bytes(True, 0) + 4 * (bt.numel() + 1))
        bms, by = bound_ms(nbytes, 4.0 * pairs * HEADS * HEAD_DIM, dtype)
        kms = time_ms(lambda: pa.paged_chunk_attention(q, kq, vq, bt, st))
        results.append(dict(
            kernel="paged_chunk_attention_int8", dtype=DTYPE_NAME[dtype],
            start=start, S=s, max_err=max(errs.values()),
            max_err_spread=errs["spread"], max_err_peaked=errs["peaked"],
            excess=max(over.values()), atol=atol, rtol=rtol, kernel_ms=kms,
            plain_ms=time_ms(lambda: pa.paged_chunk_attention_ref(
                q, kq, vq, bt, st), iters=5, warmup=1),
            library_ms=None, bound_ms=bms, bound_by=by, bound_frac=bms / kms))
        del kq, vq
        torch.cuda.empty_cache()


def block_weights(gen, dtype, device):
    """One 7B decoder layer's weights, (in, out) layout, scaled so the
    activations stay below 2 in magnitude, where one bf16 rounding step
    (2^-7 .. 2^-6) stays inside the bf16 tolerance."""
    from paddle_tpu_torch.kernels.fused_block_decode import BlockDecodeWeights
    qd, kd = HEADS * HEAD_DIM, KV_HEADS * HEAD_DIM

    def mat(k, n):
        return _rand(gen, (k, n), dtype, device, 0.5 / math.sqrt(k))

    def norm():
        return (1.0 + 0.1 * torch.randn(HIDDEN, generator=gen, device=device)
                ).to(dtype)

    return BlockDecodeWeights(
        ln1=norm(), wq=mat(HIDDEN, qd), wk=mat(HIDDEN, kd),
        wv=mat(HIDDEN, kd), wo=mat(qd, HIDDEN), ln2=norm(),
        wg=mat(HIDDEN, INTER), wu=mat(HIDDEN, INTER), wd=mat(INTER, HIDDEN))


def weight_bytes(weights) -> int:
    """Stored bytes of a layer's or a group's weights (tensors or int4
    tiles: packed payload and f32 tile scales)."""
    from paddle_tpu_torch.kernels.fused_block_decode import Int4Tiles
    return sum(t.q.numel() + 4 * t.scale.numel() if isinstance(t, Int4Tiles)
               else t.numel() * t.element_size() for t in weights)


def block_bytes(weights, layers, x, live, quant) -> float:
    """Least bytes of a decode step of ``layers`` layers: the weights and x
    read once, out written once, each layer's live k and v rows read and
    the new ones written once."""
    elem = x.element_size()
    return (weight_bytes(weights) + elem * 2 * x.numel()
            + layers * 2 * (live + BATCH) * KV_HEADS * row_bytes(quant, elem))


def pool_err(a, b) -> float:
    """Max abs difference of two pools' values; for int8 pools beyond one
    quantization step of the row (the larger of the two scales)."""
    if isinstance(a, torch.Tensor):
        return max_err(a, b)
    diff = (a.q.float() * a.scale - b.q.float() * b.scale).abs()
    return float((diff - torch.maximum(a.scale, b.scale)).clamp_min(0).max())


def pool_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)


# the fused decode rows: (case, tokens already in the pool, table width):
# serve's (1023, 517, 78 at 7B, one idle row) and serve_long's decode
# contexts in its 4096-token table
FUSED_SHAPES = (("serve", (MAX_SEQ - 1, MAX_SEQ // 2 + 5, MAX_SEQ // 13, 0),
                 MAX_SEQ),
                ("serve_long decode", LONG_DECODE_LENS, LONG_MAX_SEQ))


def check_fused_block_decode(dtype, device, results):
    """The one-layer kernel on a native and on an int8 pool at FUSED_SHAPES:
    output within TOL of the plain version, the appended rows as the plain
    version's (an int8 row within one payload step and SCALE_RTOL); the
    bound and bound_frac beside each, and device_ms from a CUDA graph."""
    from paddle_tpu_torch.kernels import fused_block_decode as fb
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    kw = dict(num_heads=HEADS, num_kv_heads=KV_HEADS, rope_theta=10000.0,
              epsilon=1e-5)
    w = None
    for case, seq_lens, max_seq in FUSED_SHAPES:
        seq_lens = list(seq_lens)
        bt, num_pages = _block_tables(seq_lens, 1, device, max_seq)
        sl = torch.tensor(seq_lens, dtype=torch.int32, device=device)
        shape = (KV_HEADS, num_pages, PAGE, HEAD_DIM)
        kp, vp = (_rand(gen, shape, dtype, device),
                  _rand(gen, shape, dtype, device))
        if w is None:
            w = block_weights(gen, dtype, device)
            x = _rand(gen, (BATCH, HIDDEN), dtype, device, 0.3)
        live = sum(seq_lens)
        mats = sum(t.numel() for t in w if t.dim() == 2)
        flops = (2.0 * BATCH * mats
                 + 4.0 * (live + BATCH) * HEADS * HEAD_DIM)
        for quant in (False, True):
            pools = (quantized(kp), quantized(vp)) if quant else (kp, vp)
            kk, vk = (clone_pool(t) for t in pools)
            got, kk, vk = fb.fused_block_decode(x, w, kk, vk, bt, sl, **kw)
            kr, vr = (clone_pool(t) for t in pools)
            want, kr, vr = fb.fused_block_decode_ref(x, w, kr, vr, bt, sl,
                                                     **kw)
            torch.cuda.synchronize()
            name = "fused_block_decode" + ("_int8" if quant else "")
            err = max_err(got, want)
            extra = {}
            if quant:
                for half, a, b in (("k", kk, kr), ("v", vk, vr)):
                    nq, ns = rows_differ(a, b, dtype,
                                         f"{name} {case} {dtype} {half}")
                    extra[f"{half}_payload_diffs"] = nq
                    extra[f"{half}_scale_diffs"] = ns
                extra["scale_rtol"] = SCALE_RTOL[dtype]
            else:
                err = max(err, max_err(kk, kr), max_err(vk, vr))
            require(err <= TOL[dtype], f"{name} {case} {dtype}: max err "
                    f"{err}")
            nbytes = (block_bytes(w, 1, x, live, quant)
                      + 4 * (bt.numel() + sl.numel()))
            bms, by = bound_ms(nbytes, flops, dtype)

            def call():
                fb.fused_block_decode(x, w, kk, vk, bt, sl, **kw)

            kms = time_ms(call)
            results.append(dict(
                kernel=name, dtype=DTYPE_NAME[dtype], case=case,
                seq_lens=seq_lens, max_err=err, tol=TOL[dtype], **extra,
                kernel_ms=kms,
                plain_ms=time_ms(lambda: fb.fused_block_decode_ref(
                    x, w, kr, vr, bt, sl, **kw), iters=5),
                library_ms=None, bound_ms=bms, bound_by=by,
                bound_frac=bms / kms,
                device_ms=dict(kernel=graph_ms(call, calls=5, reps=4))))
            del kk, vk, kr, vr, pools
        del kp, vp
        torch.cuda.empty_cache()


def check_public_fused_block_decode(dtype, device, results):
    """#3 through Paddle's entry point
    (``incubate.nn.functional.fused_block_decode``, the weights as nine
    tensors) at serve's ragged lengths: the output and the appended rows
    within TOL of the plain version, timed beside it."""
    from paddle_tpu_torch.incubate.nn import functional as FF
    from paddle_tpu_torch.kernels import fused_block_decode as fb
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    kw = dict(num_heads=HEADS, num_kv_heads=KV_HEADS, rope_theta=10000.0,
              epsilon=1e-5)
    case, seq_lens, max_seq = FUSED_SHAPES[0]
    seq_lens = list(seq_lens)
    bt, num_pages = _block_tables(seq_lens, 1, device, max_seq)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=device)
    shape = (KV_HEADS, num_pages, PAGE, HEAD_DIM)
    kp, vp = (_rand(gen, shape, dtype, device) for _ in range(2))
    w = block_weights(gen, dtype, device)
    x = _rand(gen, (BATCH, HIDDEN), dtype, device, 0.3)
    kk, vk = kp.clone(), vp.clone()
    got, kk2, vk2 = FF.fused_block_decode(x, *w, kk, vk, bt, sl, **kw)
    require(kk2 is kk and vk2 is vk, "fused_block_decode: pools in place")
    kr, vr = kp.clone(), vp.clone()
    want, kr, vr = fb.fused_block_decode_ref(x, w, kr, vr, bt, sl, **kw)
    torch.cuda.synchronize()
    err = max(max_err(got, want), max_err(kk, kr), max_err(vk, vr))
    require(err <= TOL[dtype], f"public fused_block_decode {dtype}: max "
            f"err {err}")
    live = sum(seq_lens)
    mats = sum(t.numel() for t in w if t.dim() == 2)
    flops = 2.0 * BATCH * mats + 4.0 * (live + BATCH) * HEADS * HEAD_DIM
    bms, by = bound_ms(block_bytes(w, 1, x, live, False)
                       + 4 * (bt.numel() + sl.numel()), flops, dtype)

    def call():
        FF.fused_block_decode(x, *w, kk, vk, bt, sl, **kw)

    kms = time_ms(call)
    results.append(dict(
        kernel="fused_block_decode", dtype=DTYPE_NAME[dtype],
        case=f"{case}, incubate.nn.functional.fused_block_decode",
        generation=True, seq_lens=seq_lens, max_err=err, tol=TOL[dtype],
        kernel_ms=kms,
        plain_ms=time_ms(lambda: fb.fused_block_decode_ref(
            x, w, kr, vr, bt, sl, **kw), iters=5),
        library_ms=None, bound_ms=bms, bound_by=by, bound_frac=bms / kms,
        device_ms=dict(kernel=graph_ms(call, calls=5, reps=4))))
    del kp, vp, kk, vk, kr, vr, w
    torch.cuda.empty_cache()


def check_fused_multi_block_decode(dtype, device, results):
    """A group of 4 Llama-2-7B layers at #3's FUSED_SHAPES: the N-layer
    kernel against the plain version for native and int8 pools and native
    and int4 weights; with native weights also bit for bit against 4
    launches of the one-layer kernel on the same kind of pool, timed beside
    them; bound and bound_frac beside each row."""
    from paddle_tpu_torch.kernels import fused_block_decode as fb
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    kw = dict(num_heads=HEADS, num_kv_heads=KV_HEADS, rope_theta=10000.0,
              epsilon=1e-5)
    layers = None
    for case, seq_lens, max_seq in FUSED_SHAPES:
        seq_lens = list(seq_lens)
        bt, num_pages = _block_tables(seq_lens, 1, device, max_seq)
        sl = torch.tensor(seq_lens, dtype=torch.int32, device=device)
        shape = (KV_HEADS, num_pages, PAGE, HEAD_DIM)
        pools = [(_rand(gen, shape, dtype, device),
                  _rand(gen, shape, dtype, device))
                 for _ in range(GROUP_LAYERS)]
        qpools = [(quantized(k), quantized(v)) for k, v in pools]
        if layers is None:
            layers = [block_weights(gen, dtype, device)
                      for _ in range(GROUP_LAYERS)]
            stacks = {"native": fb.stack_block_weights(layers),
                      "int4": fb.stack_block_weights(layers,
                                                     weight_dtype="int4")}
            x = _rand(gen, (BATCH, HIDDEN), dtype, device, 0.3)
        live = sum(seq_lens)
        mats = (sum(t.numel() for t in layers[0] if t.dim() == 2)
                * GROUP_LAYERS)
        flops = (2.0 * BATCH * mats
                 + GROUP_LAYERS * 4.0 * (live + BATCH) * HEADS * HEAD_DIM)
        for quant, wdt in ((False, "native"), (True, "native"),
                           (False, "int4"), (True, "int4")):
            results.append(_check_group(fb, case, dtype, x, layers,
                                        stacks[wdt], wdt, quant,
                                        qpools if quant else pools, bt, sl,
                                        kw, seq_lens, live, flops))
        del pools, qpools
        torch.cuda.empty_cache()
    del layers, stacks
    torch.cuda.empty_cache()


def _check_group(fb, case, dtype, x, layers, mw, wdt, quant, group, bt, sl,
                 kw, seq_lens, live, flops) -> dict:
    """One N-layer variant at one FUSED_SHAPES case (see
    check_fused_multi_block_decode): its result row."""
    def fresh():
        return ([clone_pool(k) for k, _ in group],
                [clone_pool(v) for _, v in group])

    tags = [t for t, on in (("int8", quant), ("int4", wdt == "int4")) if on]
    name = "_".join(["fused_multi_block_decode"] + tags)
    got, gk, gv = fb.fused_multi_block_decode(x, mw, *fresh(), bt, sl, **kw)
    want, wk, wv = fb.fused_multi_block_decode_ref(x, mw, *fresh(), bt, sl,
                                                   **kw)
    torch.cuda.synchronize()
    err = max_err(got, want)
    row = dict(kernel=name, dtype=DTYPE_NAME[dtype], case=case,
               layers=GROUP_LAYERS, seq_lens=seq_lens, tol=TOL[dtype])
    # past the first layer the kernel's and the plain version's inputs
    # differ by the earlier layers' rounding: the pools are held to the
    # output's tolerance, an int8 row's values beyond one quantization
    # step of the row (a payload one step apart)
    for i in range(GROUP_LAYERS):
        err = max(err, pool_err(gk[i], wk[i]), pool_err(gv[i], wv[i]))
    require(err <= TOL[dtype], f"{name} {case} {dtype}: max err {err}")
    if wdt == "native":
        # the same pools through 4 launches of the one-layer kernel
        out, ck, cv = x, *fresh()
        for i, w in enumerate(layers):
            out, ck[i], cv[i] = fb.fused_block_decode(
                out, w, ck[i], cv[i], bt, sl, **kw)
        torch.cuda.synchronize()
        same = torch.equal(got, out) and all(
            pool_equal(a, b) for a, b in zip(gk + gv, ck + cv))
        require(same, f"{name} {case} {dtype}: not bit for bit the chain "
                "of one-layer launches")

        def chain():
            o = x
            for i, w in enumerate(layers):
                o, _, _ = fb.fused_block_decode(o, w, ck[i], cv[i], bt, sl,
                                                **kw)

        row.update(bitwise_vs_one_layer_chain=same,
                   one_layer_kernel_x4_ms=time_ms(chain))
    nbytes = (block_bytes(mw, GROUP_LAYERS, x, live, quant)
              + 4 * (bt.numel() + sl.numel()))
    bms, by = bound_ms(nbytes, flops, dtype)

    def call():
        fb.fused_multi_block_decode(x, mw, gk, gv, bt, sl, **kw)

    kms = time_ms(call)
    row.update(
        max_err=err, kernel_ms=kms,
        plain_ms=time_ms(lambda: fb.fused_multi_block_decode_ref(
            x, mw, wk, wv, bt, sl, **kw), iters=5, warmup=1),
        library_ms=None, bound_ms=bms, bound_by=by, bound_frac=bms / kms,
        device_ms=dict(kernel=graph_ms(call, calls=5, reps=4)),
        weight_bytes=weight_bytes(mw))
    return row


# ----------------------------------------------------------------- serve
# ------------------------------------------------ spec: kernels at new shapes
# the TinyLlama-1.1B geometry of the spec phase's draft
# (TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T)
DRAFT_GEOM = dict(vocab=32000, hidden=2048, layers=22, heads=32, kv_heads=4,
                  head_dim=64, inter=5632, max_pos=2048)
# the verify chunk's widths (γ + 1 for the rungs 2, 4, 8) and its start in
# serve's 1024-token table; the draft's sync chunk and its decode context
SPEC_VERIFY_S, SPEC_START = (3, 5, 9), 700
SPEC_SYNC_S, SPEC_SYNC_START, SPEC_DRAFT_LEN = 64, 192, 700


def layer_weights(gen, dtype, device, hidden, heads, kv_heads, head_dim,
                  inter):
    """One decoder layer's weights at any geometry, scaled as
    block_weights."""
    from paddle_tpu_torch.kernels.fused_block_decode import BlockDecodeWeights
    qd, kd = heads * head_dim, kv_heads * head_dim

    def mat(k, n):
        return _rand(gen, (k, n), dtype, device, 0.5 / math.sqrt(k))

    def norm():
        return (1.0 + 0.1 * torch.randn(hidden, generator=gen, device=device)
                ).to(dtype)

    return BlockDecodeWeights(
        ln1=norm(), wq=mat(hidden, qd), wk=mat(hidden, kd),
        wv=mat(hidden, kd), wo=mat(qd, hidden), ln2=norm(),
        wg=mat(hidden, inter), wu=mat(hidden, inter), wd=mat(inter, hidden))


def one_table(lens, pages, device):
    """Block tables of ``pages`` pages a row, each row's pages distinct and
    every one in use (a full table), over a pool whose page 0 is null."""
    bt = 1 + np.arange(len(lens) * pages, dtype=np.int32).reshape(
        len(lens), pages)
    return torch.from_numpy(bt).to(device), 1 + len(lens) * pages


def kv_row_bytes(quant: bool, elem: int, d: int) -> int:
    """Bytes of one stored k or v row of head dim ``d``."""
    return d + 4 if quant else d * elem


def chunk_rows(pa, gen, dtype, device, case, s, start, heads, kv_heads, d,
               mark="spec"):
    """#4 at one speculative (or, ``mark="gpt"``, GPT) shape: write-then-attend against a
    1024-token table, spread and peaked, on the native pool (OUT_TOL, with
    SDPA on the gathered prefix) and on the same pool quantized (the
    int8 variant against its plain version, SPEC_QUANT_OUT_TOL); times
    and a bound for each. Returns the two rows."""
    bt, num_pages = one_table([MAX_SEQ], MAX_SEQ // PAGE, device)
    shape = (kv_heads, num_pages, PAGE, d)
    kp, vp = (_rand(gen, shape, dtype, device) for _ in range(2))
    st = torch.tensor([start], dtype=torch.int32, device=device)
    k_new, v_new = (_rand(gen, (1, s, kv_heads, d), dtype, device)
                    for _ in range(2))
    pa.write_paged_prompt_at(kp, vp, k_new, v_new, bt, st)
    q = _rand(gen, (1, s, heads, d), dtype, device)
    t = start + s
    kg, vg = (p[:, bt[0].long()].reshape(kv_heads, -1, d)[None, :, :t]
              for p in (kp, vp))
    mask = (torch.arange(t, device=device)[None, :]
            <= start + torch.arange(s, device=device)[:, None])
    qt = q.transpose(1, 2)
    elem = q.element_size()
    pairs = s * start + s * (s + 1) // 2
    rows = []
    for quant in (False, True):
        kk, vv = (quantized(kp), quantized(vp)) if quant else (kp, vp)
        name = "paged_chunk_attention" + ("_int8" if quant else "")
        atol, rtol = (SPEC_QUANT_OUT_TOL if quant else OUT_TOL)[dtype]
        errs, over = {}, {}
        for kind, qc in (("spread", q), ("peaked", q * PEAKED_Q)):
            got = pa.paged_chunk_attention(qc, kk, vv, bt, st)
            want = pa.paged_chunk_attention_ref(qc, kk, vv, bt, st)
            torch.cuda.synchronize()
            errs[kind], over[kind] = (max_err(got, want),
                                      excess(got, want, rtol))
            require(over[kind] <= atol, f"{name} {case} S={s} {dtype} "
                    f"{kind}: {over[kind]} over {rtol} |ref|, max err "
                    f"{errs[kind]}")
        nbytes = (elem * 2 * q.numel()
                  + 2 * t * kv_heads * kv_row_bytes(quant, elem, d)
                  + 4 * (bt.numel() + 1))
        bms, by = bound_ms(nbytes, 4.0 * pairs * heads * d, dtype)

        def call():
            pa.paged_chunk_attention(q, kk, vv, bt, st)

        kms = time_ms(call)
        rows.append(dict(
            kernel=name, dtype=DTYPE_NAME[dtype], **{mark: case},
            start=start, S=s, heads=heads, kv_heads=kv_heads, head_dim=d,
            max_err=max(errs.values()), excess=max(over.values()),
            atol=atol, rtol=rtol, kernel_ms=kms,
            plain_ms=time_ms(lambda: pa.paged_chunk_attention_ref(
                q, kk, vv, bt, st), iters=5, warmup=1),
            library_ms=(None if quant else
                        time_ms(lambda: sdpa(qt, kg, vg, attn_mask=mask))),
            bound_ms=bms, bound_by=by, bound_frac=bms / kms,
            device_ms=dict(kernel=graph_ms(call))))
    return rows


def check_spec_kernels(dtype, device, results):
    """The kernels at the spec phase's new shapes, each against its plain
    version within this phase's tolerances, on a native pool and on the
    same pool quantized (the int8 variant, as the spec phase's int8 run
    launches it), with times and a bound: #4 as the verify (S = 3, 5, 9
    at Llama-2-7B heads from 700 in a 1024-token table) and as the
    draft's sync chunk (S = 64 at TinyLlama's heads, 32 over 4 of dim
    64); #2 and #3 as the draft scan's step (B = 1, 700 tokens), #3's
    appended rows held as the plain version's (an int8 row within one
    payload step and SCALE_RTOL)."""
    from paddle_tpu_torch.kernels import fused_block_decode as fb
    from paddle_tpu_torch.kernels import paged_attention as pa
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    g = DRAFT_GEOM
    dh, dkv, dd = g["heads"], g["kv_heads"], g["head_dim"]
    for s in SPEC_VERIFY_S:
        results.extend(chunk_rows(pa, gen, dtype, device, "verify", s,
                                  SPEC_START, HEADS, KV_HEADS, HEAD_DIM))
    results.extend(chunk_rows(pa, gen, dtype, device, "draft sync",
                              SPEC_SYNC_S, SPEC_SYNC_START, dh, dkv, dd))
    torch.cuda.empty_cache()
    # the draft scan's step: #2 (generic route) and #3 (fused) at B = 1
    bt, num_pages = one_table([MAX_SEQ], MAX_SEQ // PAGE, device)
    sl = torch.tensor([SPEC_DRAFT_LEN], dtype=torch.int32, device=device)
    kp, vp = (_rand(gen, (dkv, num_pages, PAGE, dd), dtype, device)
              for _ in range(2))
    q = _rand(gen, (1, dh, dd), dtype, device)
    t = bt.shape[1] * PAGE
    kg, vg = (x[:, bt.long()].movedim(1, 0).reshape(1, dkv, t, dd)
              for x in (kp, vp))
    mask = (torch.arange(t, device=device)[None, :] < sl[:, None])
    mask = mask[:, None, None, :]
    qs = q[:, :, None, :]
    elem = q.element_size()
    w = layer_weights(gen, dtype, device, g["hidden"], dh, dkv, dd,
                      g["inter"])
    kw = dict(num_heads=dh, num_kv_heads=dkv, rope_theta=10000.0,
              epsilon=1e-5)
    x = _rand(gen, (1, g["hidden"]), dtype, device, 0.3)
    mats = sum(t.numel() for t in w if t.dim() == 2)
    for quant in (False, True):
        kk0, vv0 = (quantized(kp), quantized(vp)) if quant else (kp, vp)
        tag = "_int8" if quant else ""
        row_b = kv_row_bytes(quant, elem, dd)
        # #2
        got = pa.paged_attention(q, kk0, vv0, bt, sl)
        want = pa.paged_attention_ref(q, kk0, vv0, bt, sl)
        torch.cuda.synchronize()
        err = max_err(got, want)
        if quant:
            atol, rtol = QUANT_OUT_TOL[dtype]
            over = excess(got, want, rtol)
            require(over <= atol, f"paged_attention_int8 draft {dtype}: "
                    f"{over} over {rtol} |ref|, max err {err}")
            tols = dict(excess=over, atol=atol, rtol=rtol)
        else:
            require(err <= TOL[dtype], f"paged_attention draft {dtype}: "
                    f"{err}")
            tols = dict(tol=TOL[dtype])
        nbytes = (elem * 2 * q.numel() + 2 * SPEC_DRAFT_LEN * dkv * row_b
                  + 4 * (bt.numel() + 1))
        bms, by = bound_ms(nbytes, 4.0 * SPEC_DRAFT_LEN * dh * dd, dtype)

        def attn():
            pa.paged_attention(q, kk0, vv0, bt, sl)

        kms = time_ms(attn)
        dev = dict(kernel=graph_ms(attn))
        lib = None
        if not quant:
            lib = time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask))
            dev["library"] = graph_ms(lambda: sdpa(qs, kg, vg,
                                                   attn_mask=mask))
        results.append(dict(
            kernel="paged_attention" + tag, dtype=DTYPE_NAME[dtype],
            spec="draft", seq_lens=[SPEC_DRAFT_LEN], heads=dh, kv_heads=dkv,
            head_dim=dd, max_err=err, **tols, kernel_ms=kms,
            plain_ms=time_ms(lambda: pa.paged_attention_ref(
                q, kk0, vv0, bt, sl)),
            library_ms=lib, bound_ms=bms, bound_by=by, bound_frac=bms / kms,
            device_ms=dev))
        # #3
        name = "fused_block_decode" + tag
        kk, vk = clone_pool(kk0), clone_pool(vv0)
        got, kk, vk = fb.fused_block_decode(x, w, kk, vk, bt, sl, **kw)
        kr, vr = clone_pool(kk0), clone_pool(vv0)
        want, kr, vr = fb.fused_block_decode_ref(x, w, kr, vr, bt, sl, **kw)
        torch.cuda.synchronize()
        err = max_err(got, want)
        extra = {}
        if quant:
            for half, a, b in (("k", kk, kr), ("v", vk, vr)):
                nq, ns = rows_differ(a, b, dtype,
                                     f"{name} draft {dtype} {half}")
                extra[f"{half}_payload_diffs"] = nq
                extra[f"{half}_scale_diffs"] = ns
            extra["scale_rtol"] = SCALE_RTOL[dtype]
        else:
            err = max(err, max_err(kk, kr), max_err(vk, vr))
        require(err <= TOL[dtype], f"{name} draft {dtype}: {err}")
        nbytes = (weight_bytes(w) + elem * 2 * x.numel()
                  + 2 * (SPEC_DRAFT_LEN + 1) * dkv * row_b
                  + 4 * (bt.numel() + 1))
        bms, by = bound_ms(nbytes, 2.0 * mats + 4.0 * (SPEC_DRAFT_LEN + 1)
                           * dh * dd, dtype)

        def call():
            fb.fused_block_decode(x, w, kk, vk, bt, sl, **kw)

        kms = time_ms(call)
        results.append(dict(
            kernel=name, dtype=DTYPE_NAME[dtype], spec="draft",
            seq_lens=[SPEC_DRAFT_LEN], hidden=g["hidden"], heads=dh,
            kv_heads=dkv, head_dim=dd, inter=g["inter"], max_err=err,
            tol=TOL[dtype], **extra, kernel_ms=kms,
            plain_ms=time_ms(lambda: fb.fused_block_decode_ref(
                x, w, kr, vr, bt, sl, **kw), iters=5),
            library_ms=None, bound_ms=bms, bound_by=by, bound_frac=bms / kms,
            device_ms=dict(kernel=graph_ms(call, calls=5, reps=4))))
        del kk0, vv0, kk, vk, kr, vr
    del kp, vp, kg, vg, w
    torch.cuda.empty_cache()


def prompts(vocab: int, lens) -> list:
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def serve(model, fused: bool, new_tokens: int, lens, record_logits=False,
          max_seq=MAX_SEQ, group=1, kv_dtype="native", weight_dtype="native",
          want_fused=None, tp_degree=1):
    """One engine run over ``lens`` prompts, half submitted up front and
    the rest mid-run, with ``FLAGS_fused_block_decode=fused``,
    ``FLAGS_fused_block_layers=group`` and the engine's ``kv_dtype``,
    ``weight_dtype`` and ``tp_degree``; the fused route must be taken as
    ``want_fused``
    says (default: ``fused``; a GPT or a weight-quantized model takes the
    generic route under the flag). Returns (engine, [(rid,
    prompt, tokens)], seconds, launch counts, peak device bytes of the run,
    engine included)."""
    from paddle_tpu_torch import flags, kernels
    from paddle_tpu_torch.generation.serving import ServingEngine

    class Engine(ServingEngine):
        """Times each prefill chunk, a synchronise on both sides (the
        engine's next host->device copy synchronises the stream anyway)."""

        def _prefill_chunk(self, req):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._prefill_chunk(req)
            torch.cuda.synchronize()
            self.chunk_seconds.append(time.perf_counter() - t0)

    torch.cuda.reset_peak_memory_stats()
    flags.set_flags({"fused_block_decode": fused,
                     "fused_block_layers": group})
    eng = Engine(model, max_batch=BATCH, page_size=PAGE, max_seq_len=max_seq,
                 record_logits=record_logits, kv_dtype=kv_dtype,
                 weight_dtype=weight_dtype, tp_degree=tp_degree)
    eng.chunk_seconds = []
    fused_route = fused if want_fused is None else want_fused
    require((eng._spec is not None) == fused_route,
            "decode route not as asked")
    require((eng._stacked is not None) == (fused and group > 1
                                           and tp_degree == 1),
            "N-layer route not as asked")
    require((eng._tp_shards is not None) == (fused_route and tp_degree > 1),
            "tensor-parallel route not as asked")
    # warm-up requests, one whole and one chunked (first-call costs:
    # library loads, cuBLAS handles)
    for p in prompts(model.config.vocab_size, (9, CHUNK + 9)):
        eng.submit(p, 2)
    eng.run()
    for probe in (eng.decode_step_seconds, eng.prefill_seconds,
                  eng.ttft_seconds, eng.logits, eng.chunk_seconds):
        probe.clear()
    eng.chunk_dispatches = 0
    ps = prompts(model.config.vocab_size, lens)
    half = len(ps) // 2
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, new_tokens) for p in ps[:half]]
    for _ in range(6):
        eng.step()
    rids += [eng.submit(p, new_tokens) for p in ps[half:]]
    out = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    flags.reset_flags()
    return (eng, [(r, ps[i], out[r]) for i, r in enumerate(rids)],
            seconds, counts, torch.cuda.max_memory_allocated())


def check_tokens(res, vocab, new_tokens):
    for _, prompt, toks in res:
        require(len(toks) == new_tokens,
                f"request of {len(prompt)} tokens returned {len(toks)}")
        require(all(0 <= t < vocab for t in toks),
                "token out of the vocabulary")


def expected_launches(counts, layers, steps, whole, chunks, fused, group,
                      kv_dtype, weight_dtype, tp=1) -> dict:
    """Every kernel variant's launches in one serving run: ``whole``
    whole-prompt prefills and ``chunks`` chunks over ``layers`` layers,
    ``steps`` decode steps through the route asked for; 0 for the rest.
    A fused route at ``tp`` > 1 is the tensor-parallel chain: the decode
    attention once a layer and shard."""
    int8 = kv_dtype == "int8"
    if not fused:
        decode = "paged_attention", layers * steps, [int8]
    elif tp > 1:
        decode = "paged_attention", layers * tp * steps, [int8]
    elif group == 1:
        decode = "fused_block_decode", layers * steps, [int8]
    else:
        decode = ("fused_multi_block_decode", -(-layers // group) * steps,
                  [int8, weight_dtype == "int4"])
    base, n, flags = decode
    name = "_".join([base] + [t for t, on in zip(("int8", "int4"), flags)
                              if on])
    want = dict.fromkeys(counts, 0)
    want["flash_prefill"] = layers * whole
    want["paged_chunk_attention" + ("_int8" if int8 else "")] = (
        layers * chunks)
    want[name] = n
    return want


def require_launches(counts, want, what):
    for name, n in want.items():
        require(counts[name] == n,
                f"{what}: {name} ran {counts[name]} times, want {n}")


# (fused decode, FLAGS_fused_block_layers, kv_dtype, weight_dtype)
SERVE_RUNS = ((True, 1, "native", "native"), (False, 1, "native", "native"),
              (False, 1, "int8", "native"),
              (True, GROUP_LAYERS, "int8", "native"),
              (True, GROUP_LAYERS, "native", "int4"))
LONG_RUNS = ((1, "native", "native"), (GROUP_LAYERS, "native", "native"),
             (1, "int8", "native"), (GROUP_LAYERS, "int8", "int4"))


def run_serve(device):
    """The serving phases, then generate, handoff, fleet, quant and
    memwatch, on one Llama-2-7B. Returns the kernel launch counts of every
    run, summed, and by path: the serving phases, generate, handoff, fleet,
    quant, memwatch."""
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device, dtype=torch.bfloat16,
                             generator=seed(SEED, device))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    layers = cfg.num_hidden_layers
    total: dict = {}
    for fused, group, kv_dtype, weight_dtype in SERVE_RUNS:
        eng, res, seconds, counts, peak = serve(
            model, fused, NEW_TOKENS, PROMPT_LENS, group=group,
            kv_dtype=kv_dtype, weight_dtype=weight_dtype)
        check_tokens(res, cfg.vocab_size, NEW_TOKENS)
        steps = len(eng.decode_step_seconds)
        require_launches(counts, expected_launches(
            counts, layers, steps, len(PROMPT_LENS), 0, fused, group,
            kv_dtype, weight_dtype),
            f"serve {'fused' if fused else 'generic'} N={group} "
            f"{kv_dtype}/{weight_dtype}")
        gen = sum(len(t) for _, _, t in res)
        if (fused, kv_dtype) == (False, "native"):
            generic_step_ms = 1e3 * float(np.median(eng.decode_step_seconds))
        emit("serve", model="llama2_7b", layers=layers, dtype="bf16",
             decode="fused" if fused else "generic",
             fused_block_layers=group, kv_dtype=kv_dtype,
             weight_dtype=weight_dtype,
             requests=len(res), prompt_lens=list(PROMPT_LENS),
             new_tokens=NEW_TOKENS, generated=gen, seconds=seconds,
             tokens_per_s=gen / seconds,
             ttft_ms_median=1e3 * float(np.median(
                 list(eng.ttft_seconds.values()))),
             ttft_ms_max=1e3 * max(eng.ttft_seconds.values()),
             prefill_ms_median=1e3 * float(np.median(eng.prefill_seconds)),
             decode_steps=steps,
             decode_step_ms_median=1e3 * float(
                 np.median(eng.decode_step_seconds)),
             launches=counts, model_build_s=build_s,
             peak_mem_gb=peak / 1e9)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        del eng
        torch.cuda.empty_cache()
    counts = run_serve_long(model)
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    counts = run_sched(model)
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    counts = run_prefix(model)
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    counts = run_recovery(model)
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    counts = run_spec(model)
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    by_path = {"serve": dict(total)}
    for path, run in (("generate", run_generate), ("handoff", run_handoff),
                      ("tp", run_tp), ("fleet", run_fleet),
                      ("quant", lambda m: run_quant(m, generic_step_ms)),
                      ("memwatch", run_memwatch)):
        counts = run(model)
        by_path[path] = counts
        total = {k: total.get(k, 0) + counts.get(k, 0) for k in total}
    del model
    torch.cuda.empty_cache()
    return total, by_path


def run_serve_long(model) -> dict:
    """Prompts up to 3500 tokens of a 4096-token context, chunked, with one
    fused kernel a layer and one a group of GROUP_LAYERS layers, on the
    native pool and weights, then on the int8 pool (one layer a launch)
    and the int8 pool with int4 weights (a group a launch): exact launch
    counts; the native runs' streams identical, the int8 runs' first
    tokens identical (their prefill and chunks are the same). Returns the
    summed launch counts."""
    cfg = model.config
    layers = cfg.num_hidden_layers
    chunks = sum(-(-n // CHUNK) for n in LONG_PROMPT_LENS if n > CHUNK)
    whole = sum(1 for n in LONG_PROMPT_LENS if n <= CHUNK)
    streams, total = {}, {}
    for group, kv_dtype, weight_dtype in LONG_RUNS:
        eng, res, seconds, counts, peak = serve(
            model, True, NEW_TOKENS, LONG_PROMPT_LENS, max_seq=LONG_MAX_SEQ,
            group=group, kv_dtype=kv_dtype, weight_dtype=weight_dtype)
        check_tokens(res, cfg.vocab_size, NEW_TOKENS)
        steps = len(eng.decode_step_seconds)
        require_launches(counts, expected_launches(
            counts, layers, steps, whole, chunks, True, group, kv_dtype,
            weight_dtype), f"serve_long N={group} {kv_dtype}/{weight_dtype}")
        require(eng.chunk_dispatches == chunks,
                f"serve_long: {eng.chunk_dispatches} chunks, want {chunks}")
        streams[group, kv_dtype] = [toks for _, _, toks in res]
        ttft = {True: [], False: []}
        for rid, prompt, _ in res:
            ttft[len(prompt) > CHUNK].append(1e3 * eng.ttft_seconds[rid])
        gen = sum(len(t) for t in streams[group, kv_dtype])
        emit("serve_long", model="llama2_7b", layers=layers, dtype="bf16",
             fused_block_layers=group, kv_dtype=kv_dtype,
             weight_dtype=weight_dtype, max_seq_len=LONG_MAX_SEQ,
             prefill_chunk=CHUNK, requests=len(res),
             prompt_lens=list(LONG_PROMPT_LENS), new_tokens=NEW_TOKENS,
             generated=gen, seconds=seconds, tokens_per_s=gen / seconds,
             ttft_ms_long_median=float(np.median(ttft[True])),
             ttft_ms_long_max=max(ttft[True]),
             ttft_ms_short_median=float(np.median(ttft[False])),
             ttft_ms_short_max=max(ttft[False]),
             chunks=eng.chunk_dispatches,
             chunk_ms_median=1e3 * float(np.median(eng.chunk_seconds)),
             prefill_ms_median=1e3 * float(np.median(eng.prefill_seconds)),
             decode_steps=steps,
             decode_step_ms_median=1e3 * float(
                 np.median(eng.decode_step_seconds)),
             launches=counts, peak_mem_gb=peak / 1e9)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        del eng
        torch.cuda.empty_cache()
    require(streams[1, "native"] == streams[GROUP_LAYERS, "native"],
            f"serve_long: the N={GROUP_LAYERS} streams differ from N=1")
    first = {key: [t[0] for t in toks] for key, toks in streams.items()}
    require(first[1, "int8"] == first[GROUP_LAYERS, "int8"],
            "serve_long: the int8 runs' first tokens differ")
    return total


# ----------------------------------------------------------------- sched
# the scheduler on serve's model: max_batch 8 under the default ladder
# (rungs 4 and 8), shrink patience 2, 12 prompts of 17 to 256 tokens, half
# submitted after 6 steps
SCHED_BATCH, SCHED_PATIENCE, SCHED_STAGGER = 8, 2, 6
SCHED_LENS = (17, 256, 64, 100, 200, 33, 128, 250, 40, 180, 90, 230)
# graphs vs eager at one rung (BATCH): (route, fused decode,
# FLAGS_fused_block_layers, kv_dtype, weight_dtype), on a state of serve's
# ragged lengths with one idle row
GRAPH_RUNS = (("fused N=1", True, 1, "native", "native"),
              (f"fused N={GROUP_LAYERS} int8 + int4", True, GROUP_LAYERS,
               "int8", "int4"),
              ("generic", False, 1, "native", "native"))
GRAPH_LENS = (MAX_SEQ // 2 + 5, MAX_SEQ // 13 + 1, MAX_SEQ - 2, 0)
GRAPH_ITERS = 20
# the tight arrival's deadline, seconds: FLAGS_serving_preempt_horizon's
# default, so its slack is inside the horizon from its first step
PREEMPT_DEADLINE, PREEMPT_NEW = 1.0, 8


def sched_engine(model, fused=True, group=1, **kw):
    """A plain ServingEngine on serve's pages and context, built under
    FLAGS_fused_block_decode / _layers and the shrink patience."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.generation.serving import ServingEngine
    flags.set_flags({"fused_block_decode": fused,
                     "fused_block_layers": group,
                     "serving_bucket_patience": SCHED_PATIENCE})
    try:
        return ServingEngine(model, page_size=PAGE, max_seq_len=MAX_SEQ,
                             **kw)
    finally:
        flags.reset_flags()


def sched_ladder(model, ladder, new_tokens):
    """SCHED_LENS through an engine of SCHED_BATCH slots under ``ladder``
    (None: the flag's default), the second half submitted after
    SCHED_STAGGER steps. Returns (engine, streams in submit order, the rung
    after each step, launch counts, seconds)."""
    from paddle_tpu_torch import kernels
    eng = sched_engine(model, max_batch=SCHED_BATCH, bucket_ladder=ladder,
                       record_logits=True)
    ps = prompts(model.config.vocab_size, SCHED_LENS)
    half = len(ps) // 2
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, new_tokens) for p in ps[:half]]
    buckets = []
    for _ in range(SCHED_STAGGER):
        eng.step()
        buckets.append(eng.bucket)
    rids += [eng.submit(p, new_tokens) for p in ps[half:]]
    while eng.has_work():
        eng.step()
        buckets.append(eng.bucket)
    out = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require(all(eng.status(r) == "OK" for r in rids),
            f"sched: statuses {eng.statuses()}")
    return (eng, rids, [out[r] for r in rids], buckets,
            kernels.launch_counts(), seconds)


def first_difference(a, b):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def top2_margin(row: np.ndarray) -> float:
    top = np.sort(row)[-2:]
    return float(top[1] - top[0])


def sched_preempt(model, tight: bool, pump: bool):
    """BATCH requests of NEW_TOKENS seated, then (``tight``) one of
    PREEMPT_NEW tokens with a PREEMPT_DEADLINE deadline into the full batch;
    drained by ``run`` or (``pump``) by run_step / poll / take_results.
    Every request streams through on_token. Returns (engine, rids, streams,
    statuses, events by rid, the tight request's polls)."""
    eng = sched_engine(model, max_batch=BATCH, bucket_ladder=(BATCH,))
    ps = prompts(model.config.vocab_size, PROMPT_LENS)
    events: dict = {}

    def on_token(rid, tok, done):
        events.setdefault(rid, []).append((tok, done))

    rids = [eng.submit(p, NEW_TOKENS, on_token=on_token)
            for p in ps[:BATCH]]
    for _ in range(BATCH):
        eng.step()
    require(all(r is not None for r in eng._slots),
            "sched: the batch is not full")
    if tight:
        rids.append(eng.submit(ps[BATCH], PREEMPT_NEW,
                               deadline=PREEMPT_DEADLINE, on_token=on_token))
    polls = []
    if pump:
        while eng.run_step():
            polls.append(eng.poll(rids[-1]))
        statuses = [eng.status(r) for r in rids]
        out = eng.take_results()
        require(eng.results() == {} and eng.statuses() == {},
                "sched: take_results left results behind")
    else:
        out = eng.run()
        statuses = [eng.status(r) for r in rids]
    return eng, rids, [out[r] for r in rids], statuses, events, polls


def graph_vs_eager(model, route, fused, group, kv_dtype, weight_dtype,
                   tp_degree=1, phase="sched"):
    """One rung's decode graph against the eager step it captured, on the
    same inputs and pools: logits and pool writes bit for bit, the same
    launches counted; then the step's time, graphed and eager (CUDA events
    around GRAPH_ITERS calls that each return the tokens to the host), the
    replays alone back to back (the step's device time) and each call's
    host seconds. Returns the launches of one step."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.generation.serving import _EagerDecode
    eng = sched_engine(model, fused, group, max_batch=BATCH,
                       bucket_ladder=(BATCH,), kv_dtype=kv_dtype,
                       weight_dtype=weight_dtype, tp_degree=tp_degree)
    vocab = model.config.vocab_size
    for p in prompts(vocab, PROMPT_LENS[:BATCH]):
        eng.submit(p, 4)
    eng.run()
    graph = eng._decode_fns[BATCH]
    require(graph.graph is not None, f"graphs {route}: nothing captured")
    for s, n in enumerate(GRAPH_LENS):
        if n:
            eng.pool.allocate(s, n + 1)
            eng.pool.seq_lens[s] = n
    toks = np.random.default_rng(SEED).integers(0, vocab, (BATCH, 1))
    bt = eng.pool.block_tables[:BATCH].copy()
    sl = eng.pool.seq_lens[:BATCH].copy()
    pools = eng.pool.take_pools()
    saved = [(clone_pool(k), clone_pool(v)) for k, v in pools]
    torch.cuda.synchronize()
    kernels.reset_launches()
    next_g, logits_g, _ = graph(toks, bt, sl, pools)
    replay_counts = kernels.launch_counts()
    logits_g = logits_g.clone()
    after_g = [(clone_pool(k), clone_pool(v)) for k, v in pools]
    for pair, pair_saved in zip(pools, saved):
        for dst, src in zip(pair, pair_saved):
            copy_pool(dst, src)
    kernels.reset_launches()

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(model.device)

    logits_e, _ = graph.program(graph.weights, dev(toks), pools, dev(bt),
                                dev(sl))
    torch.cuda.synchronize()
    eager_counts = kernels.launch_counts()
    require(replay_counts == eager_counts,
            f"graphs {route}: a replay counted {replay_counts}, the eager "
            f"step {eager_counts}")
    require(torch.equal(logits_g, logits_e),
            f"graphs {route}: logits differ by {max_err(logits_g, logits_e)}")
    require(np.array_equal(next_g, logits_e.argmax(-1).cpu().numpy()),
            f"graphs {route}: argmax differs")
    require(all(pool_equal(a, b) for pg, pe in zip(after_g, pools)
                for a, b in zip(pg, pe)),
            f"graphs {route}: pool writes differ")

    def graphed():
        graph(toks, bt, sl, pools)

    def eager():
        _EagerDecode.__call__(graph, toks, bt, sl, pools)

    def host_s(fn):
        out = []
        for _ in range(GRAPH_ITERS):
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
        return float(np.median(out))

    graphed_ms = time_ms(graphed, iters=GRAPH_ITERS)
    eager_ms = time_ms(eager, iters=GRAPH_ITERS)
    replay_ms = time_ms(graph.graph.replay, iters=GRAPH_ITERS)
    graphed_host, eager_host = host_s(graphed), host_s(eager)
    eng.pool.install_pools(pools)
    emit(phase, part="graphs", route=route, kv_dtype=kv_dtype,
         weight_dtype=weight_dtype, tp_degree=tp_degree, batch=BATCH,
         seq_lens=list(GRAPH_LENS), logits_bit_equal=True,
         pools_bit_equal=True, launches_per_step=replay_counts,
         graphed_step_ms=graphed_ms, eager_step_ms=eager_ms,
         replay_ms=replay_ms, graphed_step_host_s=graphed_host,
         eager_step_host_s=eager_host,
         engine_decode_step_ms_median=1e3 * float(
             np.median(eng.decode_step_seconds)))
    del eng, saved, after_g
    torch.cuda.empty_cache()
    return replay_counts


def run_sched(model) -> dict:
    """The sched phase on serve's model: the ladder (exact launches, one
    capture per rung, every request OK; agreement with a fixed top-rung
    run reported), graphs vs eager for three routes, then deadlines,
    max_wall, preemption, streaming and the pump surface. Returns the
    ladder runs' summed launch counts."""
    from paddle_tpu_torch.generation.program_cache import (
        clear_decode_program_cache, decode_program_cache)
    t_phase = time.perf_counter()
    cfg = model.config
    layers = cfg.num_hidden_layers
    clear_decode_program_cache()
    cache = decode_program_cache()
    runs, total = {}, {}
    for ladder in (None, (SCHED_BATCH,)):
        eng, rids, streams, buckets, counts, seconds = sched_ladder(
            model, ladder, NEW_TOKENS)
        check_tokens(list(zip(rids, prompts(cfg.vocab_size, SCHED_LENS),
                              streams)), cfg.vocab_size, NEW_TOKENS)
        steps = len(eng.decode_step_seconds)
        what = f"sched ladder {eng.ladder}"
        require_launches(counts, expected_launches(
            counts, layers, steps, len(SCHED_LENS), 0, True, 1, "native",
            "native"), what)
        captures = {b: cache.trace_count(k)
                    for b, k in eng._decode_keys.items()}
        if ladder is None:
            require(eng.ladder == (4, SCHED_BATCH), f"{what}: rungs")
            require(eng.bucket_migrations >= 2 and set(buckets) == set(
                eng.ladder), f"{what}: {eng.bucket_migrations} migrations,"
                f" rungs {sorted(set(buckets))}")
            require(sorted(captures) == list(eng.ladder)
                    and set(captures.values()) == {1},
                    f"{what}: captures by rung {captures}")
        runs[ladder] = (eng, rids, streams)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        gen = sum(len(t) for t in streams)
        emit("sched", part="ladder", model="llama2_7b", layers=layers,
             dtype="bf16", ladder=list(eng.ladder),
             patience=SCHED_PATIENCE, requests=len(rids),
             prompt_lens=list(SCHED_LENS), new_tokens=NEW_TOKENS,
             migrations=eng.bucket_migrations,
             steps_at_rung={b: buckets.count(b) for b in eng.ladder},
             captures_by_rung=captures, decode_steps=steps,
             decode_step_ms_median=1e3 * float(
                 np.median(eng.decode_step_seconds)),
             seconds=seconds, tokens_per_s=gen / seconds, launches=counts)
    (leng, lrids, lstreams), (feng, frids, fstreams) = (
        runs[None], runs[(SCHED_BATCH,)])
    diffs = []
    for lr, fr, a, b in zip(lrids, frids, lstreams, fstreams):
        j = first_difference(a, b)
        if j is not None:
            diffs.append(dict(request=lr, token=j, ladder=a[j], fixed=b[j],
                              fixed_top2_margin=top2_margin(
                                  feng.logits[fr][j]),
                              ladder_top2_margin=top2_margin(
                                  leng.logits[lr][j])))
    emit("sched", part="ladder vs fixed", dtype="bf16",
         streams_equal=len(lrids) - len(diffs), requests=len(lrids),
         first_differences=diffs)
    del runs, leng, feng
    torch.cuda.empty_cache()

    for run in GRAPH_RUNS:
        graph_vs_eager(model, *run)

    # deadlines and the max_wall watchdog
    eng = sched_engine(model, max_batch=BATCH, bucket_ladder=(BATCH,))
    ps = prompts(cfg.vocab_size, PROMPT_LENS)
    rid = eng.submit(ps[0], PREEMPT_NEW, deadline=0)
    out = eng.run()
    require(out == {rid: []} and eng.status(rid) == "TIMEOUT",
            f"sched: deadline=0 gave {out}, {eng.statuses()}")
    rids = [eng.submit(p, PREEMPT_NEW) for p in ps[:3]]
    out = eng.run(max_wall=0)
    require(sorted(out) == rids and not eng.has_work()
            and all(eng.status(r) == "TIMEOUT" for r in rids),
            f"sched: run(max_wall=0) gave {eng.statuses()}")
    del eng
    # preemption: drained by run, by the pump, and without the arrival
    results = {}
    for tight, pump in ((True, False), (True, True), (False, False)):
        eng, rids, streams, statuses, events, polls = sched_preempt(
            model, tight, pump)
        require(all(s == "OK" for s in statuses),
                f"sched preempt: statuses {statuses}")
        require(eng.preemptions >= 1 if tight else eng.preemptions == 0,
                f"sched preempt: {eng.preemptions} preemptions")
        for r, toks in zip(rids, streams):
            evs = events[r]
            require([t for t, d in evs if not d] == toks
                    and [d for _, d in evs].count(True) == 1 and evs[-1][1],
                    f"sched preempt: request {r}'s on_token events")
        if pump:
            toks = [p["tokens"] for p in polls]
            require(all(len(a) <= len(b) for a, b in zip(toks, toks[1:]))
                    and polls[-1] == {"status": "OK", "tokens": streams[-1],
                                      "done": True},
                    "sched preempt: polls")
        results[tight, pump] = (streams, eng.preemptions)
        del eng
    require(results[True, True] == results[True, False],
            "sched preempt: the pump's results differ from run's")
    tight, _ = results[True, False]
    solo, _ = results[False, False]
    victims = [first_difference(a, b) for a, b in zip(tight, solo)]
    emit("sched", part="deadlines and preemption", dtype="bf16",
         deadline_0="TIMEOUT", max_wall_0="TIMEOUT",
         preemptions=results[True, False][1],
         pump_equals_run=True, on_token_once_per_token_and_end=True,
         streams_equal_to_uninterrupted=victims.count(None),
         seated=BATCH, first_differences=[
             dict(request=i, token=j) for i, j in enumerate(victims)
             if j is not None], phase_seconds=time.perf_counter() - t_phase)
    torch.cuda.empty_cache()
    return total


def run_sched_parity(model):
    """The fp32 parity model: a migrating run equals a fixed top-rung run
    token for token, and every stream of the preemption scenario equals
    the same request's stream without the arrival."""
    t_phase = time.perf_counter()
    _, _, ladder, _, _, _ = sched_ladder(model, None, PARITY_NEW_TOKENS)
    eng, _, fixed, _, _, _ = sched_ladder(model, (SCHED_BATCH,),
                                          PARITY_NEW_TOKENS)
    require(ladder == fixed, "sched parity: the migrating run's streams "
            f"differ from the fixed run's: {ladder} / {fixed}")
    tight = sched_preempt(model, True, False)
    solo = sched_preempt(model, False, False)
    require(tight[0].preemptions >= 1, "sched parity: no preemption")
    require(tight[2][:BATCH] == solo[2],
            "sched parity: a preempted request's stream changed")
    emit("sched", part="parity", model="llama2_7b width, 2 layers",
         dtype="fp32", ladder_equals_fixed=True,
         preemptions=tight[0].preemptions, victims_equal=True,
         requests=len(SCHED_LENS), new_tokens=PARITY_NEW_TOKENS,
         phase_seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------- prefix
# the prefix cache on serve_long's configuration (max_batch 4, pages of 64,
# a 4096-token context, 256-token chunks): one shared 2048-token prefix (32
# pages) and 8 requests of 32 new tokens. The first is cold (its whole
# prompt in chunks from 0); of the others, the suffixes over two pages are
# chunked from the adopted cursor (2048) and the rest are teacher-forced
# through the decode step. Three arrive once the cold one has its first
# token, four PREFIX_STAGGER steps later.
PREFIX_LEN, PREFIX_STAGGER = 2048, 6
PREFIX_SUFFIXES = (300, 17, 511, 40, 760, 77, 1000, 120)
# the host tier: one slot, a pool of TIER_PAGES - 1 usable pages (below two
# prefixes and a live sequence), TIER_HOST_PAGES host pages, requests of a
# prefix and TIER_SUFFIX tokens: prefix A, prefix B (spills A), A again
# (restores it); against a pool that holds everything
TIER_PAGES, TIER_ROOMY_PAGES, TIER_HOST_PAGES, TIER_SUFFIX = 35, 129, 96, 64
SPILL_ITERS = 8


def prefix_prompts(vocab, suffixes=None, seed=11):
    """Prompts of one seeded PREFIX_LEN-token prefix and seeded suffixes
    (PREFIX_SUFFIXES by default)."""
    rng = np.random.default_rng(SEED + seed)
    prefix = rng.integers(0, vocab, (PREFIX_LEN,)).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, (n,))])
            .astype(np.int32) for n in suffixes or PREFIX_SUFFIXES]


def prefix_engine(model, prefix_cache, **kw):
    """A ServingEngine on serve_long's pages, context and chunk that
    records each shared admission's (pages, cursor) and each request's
    chunks, by rid."""
    from paddle_tpu_torch.generation.serving import ServingEngine

    class Engine(ServingEngine):
        def _admit_shared(self, req, slot, pages, n_cached):
            self.adopted[req.rid] = (len(pages), n_cached)
            super()._admit_shared(req, slot, pages, n_cached)

        def _prefill_chunk(self, req):
            self.chunks_by_rid[req.rid] = (
                self.chunks_by_rid.get(req.rid, 0) + 1)
            super()._prefill_chunk(req)

    kw = dict(dict(max_batch=BATCH, max_seq_len=LONG_MAX_SEQ), **kw)
    eng = Engine(model, page_size=PAGE, prefill_chunk=CHUNK,
                 prefix_cache=prefix_cache, **kw)
    eng.adopted, eng.chunks_by_rid = {}, {}
    return eng


def prefix_traffic(eng, vocab, new_tokens):
    """The cold request, three hits once it has its first token, four
    PREFIX_STAGGER steps later. Returns (rids, prompts, streams, statuses,
    seconds, launch counts)."""
    from paddle_tpu_torch import kernels
    ps = prefix_prompts(vocab)
    half = len(ps) // 2
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(ps[0], new_tokens)]
    while not eng.poll(rids[0])["tokens"]:
        eng.step()
    rids += [eng.submit(p, new_tokens) for p in ps[1:half]]
    for _ in range(PREFIX_STAGGER):
        eng.step()
    rids += [eng.submit(p, new_tokens) for p in ps[half:]]
    out = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (rids, ps, [out[r] for r in rids], [eng.status(r) for r in rids],
            seconds, kernels.launch_counts())


def prefix_run(model, prefix_cache, new_tokens, record_logits=False):
    """One engine through prefix_traffic after a warm-up (one whole and
    one chunked prompt of another prefix: library loads, the chunk and
    decode captures), its probes cleared. Returns (engine, rids, prompts,
    streams, seconds, launch counts)."""
    eng = prefix_engine(model, prefix_cache, record_logits=record_logits)
    for p in prompts(model.config.vocab_size, (9, CHUNK + 9)):
        eng.submit(p, 2)
    eng.run()
    for probe in (eng.decode_step_seconds, eng.prefill_seconds,
                  eng.ttft_seconds, eng.logits, eng.adopted,
                  eng.chunks_by_rid):
        probe.clear()
    eng.chunk_dispatches = 0
    rids, ps, streams, statuses, seconds, counts = prefix_traffic(
        eng, model.config.vocab_size, new_tokens)
    require(statuses == ["OK"] * len(rids), f"prefix: statuses {statuses}")
    return eng, rids, ps, streams, seconds, counts


def hit_routes(eng, rids):
    """Require each hit's adoption (32 pages at the prefix's end) and its
    chunks (ceil(suffix / CHUNK) above two pages, none below; the cold
    request its whole prompt's); returns the chunks the run should have."""
    pages = PREFIX_LEN // PAGE
    want_chunks = 0
    for i, (rid, n) in enumerate(zip(rids, PREFIX_SUFFIXES)):
        if i == 0:
            require(rid not in eng.adopted, "prefix: the cold request hit")
            want = -(-(PREFIX_LEN + n) // CHUNK)
        else:
            require(eng.adopted.get(rid) == (pages, PREFIX_LEN),
                    f"prefix: request {rid} adopted {eng.adopted.get(rid)}")
            want = -(-n // CHUNK) if n > 2 * PAGE else 0
        got = eng.chunks_by_rid.get(rid, 0)
        require(got == want, f"prefix: request {rid} (suffix {n}) ran "
                f"{got} chunks, want {want}")
        want_chunks += want
    require(eng.chunk_dispatches == want_chunks,
            f"prefix: {eng.chunk_dispatches} chunks, want {want_chunks}")
    return want_chunks


def page_rows(pool, pid):
    return [t[:, pid].clone() for half in (pool.k_pages, pool.v_pages)
            for layer in half for t in
            ((layer,) if isinstance(layer, torch.Tensor)
             else (layer.q, layer.scale))]


def spill_restore(eng, chunk_ms):
    """Spill a cached page of the engine's pool and restore it into a free
    one: equal bit for bit, the pools at their addresses; then the median
    ms of a spill and of a restore (SPILL_ITERS each, synchronised)."""
    from paddle_tpu_torch.generation.serving import _pool_ptrs
    pool = eng.pool
    ptrs = _pool_ptrs(zip(pool.k_pages, pool.v_pages))
    pid = next(n["page"] for n in eng._prefix._nodes.values()
               if n["host"] is None)
    want = page_rows(pool, pid)
    new = pool.take_free_page()
    spill_s, restore_s = [], []
    for _ in range(SPILL_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = pool.spill_page(pid)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pool.restore_page(host, new)
        torch.cuda.synchronize()
        spill_s.append(t1 - t0)
        restore_s.append(time.perf_counter() - t1)
        got = page_rows(pool, new)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                "prefix: a restored page differs from the spilled one")
    pool.unref_page(new)
    require(_pool_ptrs(zip(pool.k_pages, pool.v_pages)) == ptrs
            and pool.ledger()["pages_spilled"] == 0,
            "prefix: spill / restore moved the pools or the count")
    spill_ms = 1e3 * float(np.median(spill_s))
    restore_ms = 1e3 * float(np.median(restore_s))
    return dict(bytes_per_page=pool.bytes_per_page,
                spill_ms_per_page=spill_ms, restore_ms_per_page=restore_ms,
                spill_gb_per_s=pool.bytes_per_page / spill_ms / 1e6,
                restore_gb_per_s=pool.bytes_per_page / restore_ms / 1e6,
                chunk_ms_per_page=chunk_ms * PAGE / CHUNK,
                pages_bit_equal=True)


def chunk_graph_vs_eager(eng):
    """The engine's chunk graph against the eager program it captured: a
    256-token chunk at cursor PREFIX_LEN of a fresh slot, logits row and
    pool writes bit for bit, the same launches counted; then the chunk's
    time graphed and eager (CUDA events around 20 calls), the replays
    alone, and each call's host seconds."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.generation.serving import _EagerChunk
    graph = eng._chunk_fn
    require(graph.graph is not None, "prefix: the chunk was not captured")
    vocab = eng.model.config.vocab_size
    eng.pool.allocate(0, PREFIX_LEN + CHUNK)
    ids = np.random.default_rng(SEED).integers(0, vocab, (1, CHUNK))
    bt = eng.pool.block_tables[:1].copy()
    sl = np.array([PREFIX_LEN], np.int32)
    last = np.array([CHUNK - 1], np.int64)
    pools = eng.pool.take_pools()
    saved = [(clone_pool(k), clone_pool(v)) for k, v in pools]
    torch.cuda.synchronize()
    kernels.reset_launches()
    row_g, tok_g, _ = graph(ids, bt, sl, last, pools)
    row_g, tok_g = row_g.clone(), int(tok_g)
    replay_counts = kernels.launch_counts()
    after_g = [(clone_pool(k), clone_pool(v)) for k, v in pools]
    for pair, pair_saved in zip(pools, saved):
        for dst, src in zip(pair, pair_saved):
            copy_pool(dst, src)
    kernels.reset_launches()
    row_e, _ = graph.run((ids, bt, sl, last), pools)
    torch.cuda.synchronize()
    require(replay_counts == kernels.launch_counts(),
            f"prefix chunk graph: a replay counted {replay_counts}")
    require(torch.equal(row_g, row_e) and tok_g == int(row_e.argmax()),
            f"prefix chunk graph: logits differ by {max_err(row_g, row_e)}")
    require(all(pool_equal(a, b) for pg, pe in zip(after_g, pools)
                for a, b in zip(pg, pe)),
            "prefix chunk graph: pool writes differ")

    def graphed():
        graph(ids, bt, sl, last, pools)

    def eager():
        _EagerChunk.__call__(graph, ids, bt, sl, last, pools)

    def host_s(fn):
        out = []
        for _ in range(GRAPH_ITERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return float(np.median(out))

    row = dict(graphed_chunk_ms=time_ms(graphed, iters=GRAPH_ITERS),
               eager_chunk_ms=time_ms(eager, iters=GRAPH_ITERS),
               replay_ms=time_ms(graph.graph.replay, iters=GRAPH_ITERS),
               graphed_chunk_host_s=host_s(graphed),
               eager_chunk_host_s=host_s(eager),
               chunk_logits_bit_equal=True, chunk_pools_bit_equal=True,
               launches_per_chunk=replay_counts)
    eng.pool.install_pools(pools)
    eng.pool.free_sequence(0)
    del saved, after_g
    return row


def tier_run(model, num_pages, host_pages):
    """Prefix A, prefix B, A again (TIER_SUFFIX-token suffixes, NEW_TOKENS
    each) through one slot. Returns (engine, streams, A's spilled pages
    once B is seated, restores, A again's adoption)."""
    vocab = model.config.vocab_size
    a_first, a_again = prefix_prompts(vocab, (TIER_SUFFIX,) * 2, seed=21)
    (b_first,) = prefix_prompts(vocab, (TIER_SUFFIX,), seed=22)
    eng = prefix_engine(model, True, max_batch=1, num_pages=num_pages,
                        host_tier_pages=host_pages)
    restores, restore = [0], eng.pool.restore_page

    def counted(*args):
        restores[0] += 1
        return restore(*args)
    eng.pool.restore_page = counted
    streams, spilled = [], None
    for p in (a_first, b_first, a_again):
        rid = eng.submit(p, NEW_TOKENS)
        eng.step()
        if p is b_first:
            spilled = eng._prefix.spilled_page_count()
        streams.append(eng.run()[rid])
    return eng, streams, spilled, restores[0], eng.adopted.get(rid)


def run_prefix(model) -> dict:
    """The prefix phase (serve_long's configuration, the shared prefix):
    exact launches, every request OK, each hit's adoption and chunks; the
    cold run (prefix_cache=False) for the chunks and launches saved and
    the bf16 agreement; the chunk graph against eager; spill / restore bit
    for bit and timed; the host tier spilling prefix A for B and restoring
    it, its streams equal to a pool that holds everything. Returns the
    cached run's launch counts."""
    t_phase = time.perf_counter()
    cfg = model.config
    layers = cfg.num_hidden_layers
    eng, rids, ps, streams, seconds, counts = prefix_run(
        model, True, NEW_TOKENS, record_logits=True)
    check_tokens(list(zip(rids, ps, streams)), cfg.vocab_size, NEW_TOKENS)
    chunks = hit_routes(eng, rids)
    steps = len(eng.decode_step_seconds)
    require_launches(counts, expected_launches(
        counts, layers, steps, 0, chunks, True, 1, "native", "native"),
        "prefix")
    ledger = eng.pool.ledger()
    require(ledger["pages_in_use"] == len(eng._prefix._nodes)
            and ledger["pages_shared"] == 0
            and eng._prefix.pinned_page_count() == 0,
            f"prefix: the pool after drain {ledger}")
    ttft = [1e3 * eng.ttft_seconds[r] for r in rids]
    cold, c_rids, _, c_streams, c_seconds, c_counts = prefix_run(
        model, False, NEW_TOKENS, record_logits=True)
    c_chunks = sum(-(-(PREFIX_LEN + n) // CHUNK) for n in PREFIX_SUFFIXES)
    require(cold.chunk_dispatches == c_chunks,
            f"prefix cold: {cold.chunk_dispatches} chunks, want {c_chunks}")
    c_ttft = [1e3 * cold.ttft_seconds[r] for r in c_rids]
    diffs = []
    for r, cr, a, b in zip(rids, c_rids, streams, c_streams):
        j = first_difference(a, b)
        if j is not None:
            diffs.append(dict(request=r, token=j, hit=a[j], cold=b[j],
                              hit_top2_margin=top2_margin(eng.logits[r][j]),
                              cold_top2_margin=top2_margin(
                                  cold.logits[cr][j])))
    del cold
    torch.cuda.empty_cache()
    graph_row = chunk_graph_vs_eager(eng)
    spill_row = spill_restore(eng, graph_row["graphed_chunk_ms"])
    gen = sum(len(t) for t in streams)
    emit("prefix", model="llama2_7b", layers=layers, dtype="bf16",
         batch=BATCH, page_size=PAGE, max_seq_len=LONG_MAX_SEQ,
         prefill_chunk=CHUNK, prefix_tokens=PREFIX_LEN,
         suffixes=list(PREFIX_SUFFIXES), new_tokens=NEW_TOKENS,
         requests=len(rids), generated=gen, seconds=seconds,
         tokens_per_s=gen / seconds, cold_run_seconds=c_seconds,
         ttft_ms_cold_request=ttft[0],
         ttft_ms_hits_median=float(np.median(ttft[1:])),
         cold_run_ttft_ms_same_requests_median=float(np.median(c_ttft[1:])),
         pages_adopted=sum(n for n, _ in eng.adopted.values()),
         chunks=eng.chunk_dispatches, cold_run_chunks=c_chunks,
         chunks_saved=c_chunks - eng.chunk_dispatches,
         prefill_launches_saved=(c_counts["paged_chunk_attention"]
                                 - counts["paged_chunk_attention"]),
         decode_steps=steps,
         decode_step_ms_median=1e3 * float(
             np.median(eng.decode_step_seconds)),
         ledger_after_drain=ledger, cached_nodes=len(eng._prefix._nodes),
         hit_vs_cold_streams_equal=len(rids) - len(diffs),
         hit_vs_cold_first_differences=diffs, launches=counts,
         **graph_row, **spill_row)
    del eng
    torch.cuda.empty_cache()
    # the host tier: B spills A, A again restores it
    tier, t_streams, spilled, restores, adopted = tier_run(
        model, TIER_PAGES, TIER_HOST_PAGES)
    pages = PREFIX_LEN // PAGE
    require(spilled >= pages, f"prefix tier: B spilled {spilled} pages")
    require(restores == pages and adopted == (pages, PREFIX_LEN),
            f"prefix tier: {restores} restores, adopted {adopted}")
    t_ledger = tier.pool.ledger()
    del tier
    roomy, r_streams, r_spilled, r_restores, _ = tier_run(
        model, TIER_ROOMY_PAGES, 0)
    require(r_spilled == 0 and r_restores == 0, "prefix tier: roomy spilled")
    require(t_streams == r_streams, "prefix tier: streams from restored "
            "pages differ from resident pages'")
    del roomy
    torch.cuda.empty_cache()
    emit("prefix", part="host tier", dtype="bf16", device_pages=TIER_PAGES - 1,
         host_tier_pages=TIER_HOST_PAGES, prefixes=2, suffix=TIER_SUFFIX,
         spilled_when_b_seated=spilled, restored_for_a_again=restores,
         streams_equal_to_resident=True, ledger_after_drain=t_ledger,
         phase_seconds=time.perf_counter() - t_phase)
    return counts


def run_prefix_parity(model):
    """The fp32 parity model: the prefix traffic's hit streams equal the
    cold engine's (prefix_cache=False), token for token."""
    t_phase = time.perf_counter()
    eng, rids, _, streams, _, _ = prefix_run(model, True, PARITY_NEW_TOKENS)
    hit_routes(eng, rids)
    del eng
    _, _, _, cold, _, _ = prefix_run(model, False, PARITY_NEW_TOKENS)
    require(streams == cold, "prefix parity: hit streams differ from cold "
            f"ones: {streams} / {cold}")
    emit("prefix", part="parity", model="llama2_7b width, 2 layers",
         dtype="fp32", hit_streams_equal_cold=True, requests=len(rids),
         new_tokens=PARITY_NEW_TOKENS,
         phase_seconds=time.perf_counter() - t_phase)
    torch.cuda.empty_cache()


# --------------------------------------------------------------- recovery
# replay recovery on serve's model and pages: max_batch 4, a 1024-token
# context, the prefix cache on, 256-token chunks; 8 requests of 32 new
# tokens (the 300- and 700-token prompts chunked), half submitted after
# RECOVERY_STAGGER steps, under RECOVERY_SPEC. Every fault replays every
# request in flight, and at the default no-progress budget (3) the two
# chunked prompts end FAILED under this spec, in the JAX engine as well:
# the schedule depends on the spec and the traffic only, and
# test_recovery_drill_schedule_matches_the_jax_engine (in
# tests/test_torch_recovery.py) runs this traffic and spec through both
# engines on the CPU at both budgets. The drill runs at RECOVERY_RETRIES,
# and reports the statuses at the default budget too.
RECOVERY_LENS = (17, 77, 130, 256, 300, 700, 33, 200)
RECOVERY_STAGGER = 6
RECOVERY_SPEC = "prefill:every=5;chunk_prefill:every=4;decode_dispatch:every=9"
RECOVERY_RETRIES, RECOVERY_BACKOFF = 20, 0.001
# retry exhaustion: every dispatch fails (a decode fault alone does not
# exhaust the budget: each replay's prefill emits a token, which is
# progress), at a budget of 2
EXHAUST_SPEC = ("prefill:every=1;chunk_prefill:every=1;"
                "decode_dispatch:every=1")
EXHAUST_RETRIES = 2
# telemetry's cost: steady decode steps at B = 4, alternating on and off
TELEMETRY_BLOCKS, TELEMETRY_STEPS, TELEMETRY_NEW = 4, 10, 60
RECOVERY_TRACE = "build/recovery_trace.json"


def recovery_engine(model, replica, spec="", retries=None, telemetry=True,
                    record_logits=False):
    """A ServingEngine on serve's pages and context with the prefix cache,
    built under ``spec`` (FLAGS_fault_inject), the no-progress budget and
    FLAGS_telemetry. Its ``recovery_samples`` list holds the wall clock of
    each recovery, the values serving_recovery_seconds observes."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.generation.serving import ServingEngine
    from paddle_tpu_torch.testing import faults
    extra = dict(serving_retry_backoff=RECOVERY_BACKOFF, telemetry=telemetry)
    if retries is not None:
        extra["serving_max_retries"] = retries
    with faults.armed(spec, **extra):
        eng = ServingEngine(model, max_batch=BATCH, page_size=PAGE,
                            max_seq_len=MAX_SEQ, prefix_cache=True,
                            replica=replica, record_logits=record_logits)
    flags.reset_flags()
    eng.recovery_samples = []
    observe = eng._observe_recovery

    def observe_recovery(n_replayed, n_failed, dt):
        eng.recovery_samples.append(dt)
        observe(n_replayed, n_failed, dt)
    eng._observe_recovery = observe_recovery
    return eng


def recovery_traffic(eng, vocab, new_tokens):
    """RECOVERY_LENS, half submitted after RECOVERY_STAGGER steps. Returns
    (rids, streams, statuses, seconds, launch counts)."""
    from paddle_tpu_torch import kernels
    ps = prompts(vocab, RECOVERY_LENS)
    half = len(ps) // 2
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, new_tokens) for p in ps[:half]]
    for _ in range(RECOVERY_STAGGER):
        eng.step()
    rids += [eng.submit(p, new_tokens) for p in ps[half:]]
    out = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (rids, [out[r] for r in rids], [eng.status(r) for r in rids],
            seconds, kernels.launch_counts())


def replica_series(name, replica):
    """The series of metric ``name`` whose replica label is ``replica``."""
    from paddle_tpu_torch import observability as obs
    fam = obs.snapshot()["metrics"][name]
    for s in fam["series"]:
        if s["labels"].get("replica") == replica:
            return s
    raise KeyError(f"{name}{{replica={replica}}}")


def injected():
    """faults_injected by site, as the registry holds it now."""
    from paddle_tpu_torch import observability as obs
    fam = obs.snapshot()["metrics"].get("faults_injected")
    return {s["labels"]["site"]: s["value"]
            for s in (fam or {}).get("series", [])}


def captures(cache, eng):
    keys = list(eng._decode_keys.values()) + [eng.chunk_key]
    return {k: cache.trace_count(k) for k in keys}


def recovery_run(model, replica, spec, new_tokens, record_logits=False,
                 retries=RECOVERY_RETRIES):
    """One engine through recovery_traffic; requires the pools at their
    addresses and the ledger balanced after the drain. Returns (engine,
    rids, streams, statuses, seconds, launch counts, faults fired)."""
    from paddle_tpu_torch.generation.serving import _pool_ptrs
    eng = recovery_engine(model, replica, spec, retries=retries,
                          record_logits=record_logits)
    ptrs = _pool_ptrs(zip(eng.pool.k_pages, eng.pool.v_pages))
    before = injected()
    rids, streams, statuses, seconds, counts = recovery_traffic(
        eng, model.config.vocab_size, new_tokens)
    fired = {k: v - before.get(k, 0.0) for k, v in injected().items()
             if v != before.get(k, 0.0)}
    require(_pool_ptrs(zip(eng.pool.k_pages, eng.pool.v_pages)) == ptrs,
            f"recovery {replica}: the pools moved")
    graphs = list(eng._decode_fns.values()) + (
        [eng._chunk_fn] if eng._chunk_fn is not None else [])
    require(all(g.graph is not None and g.ptrs == ptrs for g in graphs),
            f"recovery {replica}: a graph is missing or names other pools")
    ledger = eng.pool.ledger()
    require(ledger["pages_in_use"] == len(eng._prefix._nodes)
            and ledger["pages_shared"] == 0
            and eng._prefix.pinned_page_count() == 0,
            f"recovery {replica}: the pool after drain {ledger}")
    return eng, rids, streams, statuses, seconds, counts, fired


def telemetry_cost(model):
    """The graphed fused step at B = 4 with FLAGS_telemetry on and off:
    TELEMETRY_BLOCKS alternating blocks of TELEMETRY_STEPS steady decode
    steps on two engines. Returns the medians of step() wall ms, the
    decode call's ms (dispatch to tokens on the host) and their difference
    (the step's host ms outside the decode call)."""
    engines = {}
    for on in (True, False):
        eng = recovery_engine(model, f"telemetry-{on}", telemetry=on)
        for p in prompts(model.config.vocab_size, PROMPT_LENS[:BATCH]):
            eng.submit(p, TELEMETRY_NEW)
        while any(r is None or r.tokens == [] for r in eng._slots):
            eng.step()                       # all four seated and decoding
        eng.step()                           # the rung's capture
        engines[on] = eng
    walls = {True: [], False: []}
    calls = {True: [], False: []}
    for block in range(TELEMETRY_BLOCKS):
        for on in ((True, False) if block % 2 == 0 else (False, True)):
            eng = engines[on]
            for _ in range(TELEMETRY_STEPS):
                n = len(eng.decode_step_seconds)
                t0 = time.perf_counter()
                eng.step()
                walls[on].append(time.perf_counter() - t0)
                calls[on].extend(eng.decode_step_seconds[n:])
    out = {}
    for on in (True, False):
        require(engines[on]._m.enabled == on, "telemetry binding")
        step = 1e3 * float(np.median(walls[on]))
        call = 1e3 * float(np.median(calls[on]))
        out["on" if on else "off"] = dict(step_ms=step, decode_call_ms=call,
                                         host_ms_outside_call=step - call,
                                         steps=len(walls[on]))
    del engines
    torch.cuda.empty_cache()
    return out


def run_recovery(model) -> dict:
    """The recovery phase on serve's model: a fault-free run, the same
    traffic under RECOVERY_SPEC (every request OK, recoveries equal to the
    faults fired, one capture per rung and one for the chunk as in the
    fault-free run, the pools at their addresses, the ledger balanced,
    exact launches, serving_decode_steps equal to the decode steps
    dispatched (bookkeeping); the bf16 agreement, recovery seconds and
    retries reported),
    the statuses at the default budget, retry exhaustion (every request
    FAILED, run returns, the disarmed engine serves OK as a fault-free
    engine does), a kernel error that raises out of step, telemetry's cost,
    and a Chrome trace of the phase. Returns the drill's launch counts."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.generation.program_cache import (
        clear_decode_program_cache, decode_program_cache)
    from paddle_tpu_torch.kernels._build import KernelError
    from paddle_tpu_torch.testing import faults
    t_phase = time.perf_counter()
    cfg = model.config
    layers = cfg.num_hidden_layers
    clear_decode_program_cache()
    cache = decode_program_cache()
    obs.tracer().clear()
    clean, rids, want, statuses, c_seconds, _, _ = recovery_run(
        model, "recovery-clean", "", NEW_TOKENS, record_logits=True)
    require(statuses == ["OK"] * len(rids), f"recovery clean: {statuses}")
    check_tokens(list(zip(rids, prompts(cfg.vocab_size, RECOVERY_LENS),
                          want)), cfg.vocab_size, NEW_TOKENS)
    clean_caps = captures(cache, clean)
    require(set(clean_caps.values()) == {1},
            f"recovery clean: captures {clean_caps}")
    step_ms = 1e3 * float(np.median(clean.decode_step_seconds))
    eng, rids, got, statuses, seconds, counts, fired = recovery_run(
        model, "recovery", RECOVERY_SPEC, NEW_TOKENS, record_logits=True)
    require(statuses == ["OK"] * len(rids), f"recovery: {statuses}")
    check_tokens(list(zip(rids, prompts(cfg.vocab_size, RECOVERY_LENS),
                          got)), cfg.vocab_size, NEW_TOKENS)
    caps = captures(cache, eng)
    require(set(caps) == set(clean_caps)
            and all(caps[k] == clean_caps[k] + 1 for k in caps),
            f"recovery: captures {caps}, fault-free {clean_caps}")
    recoveries = replica_series("serving_recoveries", "recovery")["value"]
    require(fired and recoveries == sum(fired.values()),
            f"recovery: {recoveries} recoveries, faults fired {fired}")
    steps = len(eng.decode_step_seconds)
    # bookkeeping: the counter is written on the host before the fault
    # check and the graph call; the exact launches below show the replays
    dispatched = steps + eng._f_decode.fires
    decode_steps = replica_series("serving_decode_steps",
                                  "recovery")["value"]
    require(decode_steps == dispatched,
            f"recovery: serving_decode_steps {decode_steps}, dispatched "
            f"{dispatched}")
    require_launches(counts, expected_launches(
        counts, layers, steps, len(eng.prefill_seconds),
        eng.chunk_dispatches, True, 1, "native", "native"), "recovery")
    diffs = []
    for r, a, b in zip(rids, got, want):
        j = first_difference(a, b)
        if j is not None:
            diffs.append(dict(request=r, token=j, faulted=a[j], clean=b[j],
                              faulted_top2_margin=top2_margin(
                                  eng.logits[r][j]),
                              clean_top2_margin=top2_margin(
                                  clean.logits[r][j])))
    rec = replica_series("serving_recovery_seconds", "recovery")
    samples = eng.recovery_samples
    require(len(samples) == rec["count"] == recoveries,
            f"recovery: {len(samples)} timed recoveries, histogram "
            f"{rec['count']}, counter {recoveries}")
    retries = replica_series("serving_retries_total", "recovery")["value"]
    gen = sum(len(t) for t in got)
    row = dict(
        model="llama2_7b", layers=layers, dtype="bf16", batch=BATCH,
        page_size=PAGE, max_seq_len=MAX_SEQ, prefill_chunk=CHUNK,
        prefix_cache=True, prompt_lens=list(RECOVERY_LENS),
        new_tokens=NEW_TOKENS, spec=RECOVERY_SPEC,
        max_retries=RECOVERY_RETRIES, retry_backoff_s=RECOVERY_BACKOFF,
        statuses_ok=len(rids), faults_fired=fired, recoveries=recoveries,
        retries=retries,
        requests_failed=replica_series("serving_requests_failed",
                                       "recovery")["value"],
        captures_fault_free=len(clean_caps), captures_faulted=len(caps),
        pool_addresses_unchanged=True, ledger_balanced=True,
        decode_steps_counter=decode_steps, decode_steps_dispatched=dispatched,
        decode_steps_completed=steps, whole_prefills=len(eng.prefill_seconds),
        chunks=eng.chunk_dispatches, launches=counts, seconds=seconds,
        fault_free_seconds=c_seconds, tokens_per_s=gen / seconds,
        fault_free_tokens_per_s=gen / c_seconds,
        recovery_ms_median=1e3 * float(np.median(samples)),
        recovery_ms_max=1e3 * max(samples),
        recovery_ms_mean=1e3 * float(np.mean(samples)),
        fault_free_decode_step_ms_median=step_ms,
        streams_equal_to_fault_free=len(rids) - len(diffs),
        first_differences=diffs)
    del clean, eng
    torch.cuda.empty_cache()

    # the default budget: the same traffic and spec, statuses reported
    eng, rids, _, d_statuses, _, _, d_fired = recovery_run(
        model, "recovery-default", RECOVERY_SPEC, NEW_TOKENS, retries=None)
    row.update(default_budget=eng.max_retries,
               default_budget_statuses=d_statuses,
               default_budget_faults_fired=d_fired)
    del eng
    torch.cuda.empty_cache()

    # retry exhaustion, then the disarmed engine serves
    eng = recovery_engine(model, "recovery-exhaust", EXHAUST_SPEC,
                          retries=EXHAUST_RETRIES)
    ps = prompts(cfg.vocab_size, RECOVERY_LENS)
    rids = [eng.submit(p, NEW_TOKENS) for p in ps]
    out = eng.run()
    require(sorted(out) == sorted(rids) and not eng.has_work()
            and all(eng.status(r) == "FAILED" for r in rids),
            f"recovery exhaustion: {eng.statuses()}")
    eng._f_prefill = eng._f_chunk = eng._f_decode = faults.NULL_SITE
    rid = eng.submit(ps[0], NEW_TOKENS)
    served = eng.run()[rid]
    require(eng.status(rid) == "OK", "recovery exhaustion: not served")
    ref = recovery_engine(model, "recovery-exhaust-ref")
    rrid = ref.submit(ps[0], NEW_TOKENS)
    require(ref.run()[rrid] == served, "recovery exhaustion: the disarmed "
            "engine's stream differs from a fault-free engine's")
    del ref
    failed = replica_series("serving_requests_failed",
                            "recovery-exhaust")["value"]
    # a kernel error is not replayed: injected into the decode call, and a
    # graph given a pool at another address
    graph = eng._decode_fns[BATCH]

    def broken(*args):
        raise KernelError("injected KernelError")

    eng._decode_fns[BATCH] = broken
    eng.submit(ps[0], 4)
    raised = []
    for _ in range(3):
        try:
            eng.step()
        except KernelError as e:
            raised.append(str(e))
            break
    require(raised and eng._consec_failures == 0,
            "recovery: a KernelError did not raise out of step")
    eng._decode_fns[BATCH] = graph
    eng.pool.install_pools(eng.pool._detached)
    eng.pool.k_pages[0] = eng.pool.k_pages[0].clone()
    moved = []
    for _ in range(3):
        try:
            eng.step()
        except KernelError as e:
            moved.append(str(e))
            break
    require(moved and "addresses" in moved[0],
            f"recovery: a moved pool did not raise a KernelError: {moved}")
    row.update(exhaustion_spec=EXHAUST_SPEC,
               exhaustion_max_retries=EXHAUST_RETRIES,
               exhaustion_failed=failed, exhaustion_requests=len(rids),
               disarmed_serves_ok_equal_to_fault_free=True,
               kernel_error_injected=True, moved_pool_raised=moved[0])
    del eng, graph
    torch.cuda.empty_cache()

    os.makedirs(os.path.dirname(RECOVERY_TRACE), exist_ok=True)
    events = obs.tracer().events()
    obs.save_chrome_trace(RECOVERY_TRACE, events)
    row.update(trace=RECOVERY_TRACE, trace_events=len(events),
               trace_spans=sum(1 for e in events if e["ph"] == "X"),
               trace_by_name={n: sum(1 for e in events if e["name"] == n)
                              for n in sorted({e["name"] for e in events})})
    watermarks = obs.memory.sample_device_memory()
    require(set(watermarks["devices"].get("0", {})) == set(
        obs.memory.DEVICE_STATS), f"recovery: watermarks {watermarks}")
    row.update(telemetry_cost=telemetry_cost(model),
               memory_watermarks=watermarks,
               phase_seconds=time.perf_counter() - t_phase)
    emit("recovery", **row)
    return counts


def run_recovery_parity(model):
    """The fp32 parity model under the same spec and traffic: every
    request OK, the streams equal to the fault-free run token for
    token."""
    t_phase = time.perf_counter()
    clean, _, want, statuses, _, _, _ = recovery_run(
        model, "recovery-parity-clean", "", NEW_TOKENS)
    require(statuses == ["OK"] * len(want), f"recovery parity: {statuses}")
    del clean
    eng, _, got, statuses, _, _, fired = recovery_run(
        model, "recovery-parity", RECOVERY_SPEC, NEW_TOKENS)
    require(statuses == ["OK"] * len(got), f"recovery parity: {statuses}")
    require(got == want, "recovery parity: the replayed streams differ "
            f"from the fault-free run: {got} / {want}")
    emit("recovery", part="parity", model="llama2_7b width, 2 layers",
         dtype="fp32", spec=RECOVERY_SPEC, faults_fired=fired,
         recoveries=replica_series("serving_recoveries",
                                   "recovery-parity")["value"],
         streams_equal_to_fault_free=True, requests=len(got),
         new_tokens=NEW_TOKENS, phase_seconds=time.perf_counter() - t_phase)
    del eng
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ spec
# the spec phase: Llama-2-7B (serve's model) drafted by a TinyLlama-1.1B-
# shaped seeded model; batch 1 at a 9-slot budget (rungs 2, 4, 8, adaptive)
SPEC_LENS, SPEC_NEW, SPEC_SLOTS = (17, 100, 200, 256), 64, 9
SPEC_RUNGS = (2, 4, 8)            # FLAGS_serving_spec_rungs' default
# bf16: the RMS difference of a speculative engine's logits row and the
# plain engine's at the same position, over the plain row's standard
# deviation. The two paths round differently (the verify's chunk and
# torch.matmul over γ + 1 rows against #3's GEMV, the KV written by
# either), and the seeded 7B carries that through 32 layers: the plain
# engine's own generic and fused routes part by 4-7 % of the spread, which
# the phase measures beside (the yardstick); a wrong position, mask or
# page would move a row by its whole spread
SPEC_LOGIT_TOL = 2.0 ** -3
SPEC_SAMPLE = dict(temperature=0.8, top_k=50, top_p=0.95)
SPEC_SEEDS = (1, 2, 3, 4)
# bounded (times=4): a sampled replay emits nothing at its prefill, and
# once its draft needs two sync chunks every=3 fires within every replay,
# so without a bound it never progresses and ends FAILED (as in the JAX
# engine)
SPEC_FAULTS = "spec_draft:every=3:times=4;spec_verify:every=4:times=4"
SPEC_RETRIES = 20
SPEC_WARM = (9, 16)               # warm-up request: prompt, new tokens
# the request that fills its table: prompt + new tokens == max_seq_len
SPEC_TABLE_END = MAX_SEQ - SPEC_NEW


def draft_model(device, dtype, layers=None, seed_offset=21, zero=False):
    """The TinyLlama-1.1B-shaped draft (22 layers unless ``layers``),
    seeded, or all zeros (it proposes token 0 forever)."""
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    g = DRAFT_GEOM
    cfg = LlamaConfig(
        vocab_size=g["vocab"], hidden_size=g["hidden"],
        num_hidden_layers=layers or g["layers"],
        num_attention_heads=g["heads"], num_key_value_heads=g["kv_heads"],
        intermediate_size=g["inter"], max_position_embeddings=g["max_pos"])
    model = LlamaForCausalLM(cfg, device=device, dtype=dtype,
                             generator=seed(SEED + seed_offset, device))
    if zero:
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
    return model


def spec_engine(model, draft, max_batch=1, slots=SPEC_SLOTS,
                kv_dtype="native", fused=True, spec="", record_logits=False,
                extra_flags=None):
    """A ServingEngine on serve's pages and context with ``draft``
    (None: the plain engine) at a slot budget (None: the default pricing),
    under FLAGS_fault_inject=``spec`` and ``extra_flags``. Its
    ``round_log`` holds (γ, accepted, tokens emitted, wall s) of every
    completed round."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.generation.serving import ServingEngine
    from paddle_tpu_torch.testing import faults
    extra = dict(serving_retry_backoff=RECOVERY_BACKOFF,
                 serving_max_retries=SPEC_RETRIES, fused_block_decode=fused)
    if slots is not None:
        extra["serving_spec_max_slots"] = slots
    extra.update(extra_flags or {})
    with faults.armed(spec, **extra):
        eng = ServingEngine(model, max_batch=max_batch, page_size=PAGE,
                            max_seq_len=MAX_SEQ, draft_model=draft,
                            kv_dtype=kv_dtype, record_logits=record_logits)
    flags.reset_flags()
    eng.round_log = []
    if draft is None:
        return eng
    inner = eng._spec_round

    def spec_round(req, gamma):
        a0, n0 = eng.spec_tokens_accepted, len(req.tokens)
        t0 = time.perf_counter()
        inner(req, gamma)
        eng.round_log.append((gamma, eng.spec_tokens_accepted - a0,
                              len(req.tokens) - n0,
                              time.perf_counter() - t0))
    eng._spec_round = spec_round
    return eng


def spec_warm(eng, vocab):
    """One short request (the first calls and captures), then the probes
    cleared."""
    p = prompts(vocab, (SPEC_WARM[0],))[0]
    eng.submit(p, SPEC_WARM[1])
    eng.run()
    for probe in (eng.decode_step_seconds, eng.prefill_seconds,
                  eng.ttft_seconds, eng.logits, eng.round_log):
        probe.clear()
    eng.chunk_dispatches = 0
    if eng.draft_model is not None:
        eng.spec_rounds = eng.spec_tokens_accepted = 0
        eng.spec_tokens_rejected = eng.spec_sync_chunks = 0


def spec_traffic(eng, vocab, lens, new, stagger=0, law=None):
    """``lens`` prompts of ``new`` tokens each (half after ``stagger``
    steps when given), run to the end. Returns (streams, statuses,
    seconds, launch counts)."""
    from paddle_tpu_torch import kernels
    ps = prompts(vocab, lens)
    head = len(ps) // 2 if stagger else len(ps)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, new, **(law or {})) for p in ps[:head]]
    for _ in range(stagger):
        eng.step()
    rids += [eng.submit(p, new, **(law or {})) for p in ps[head:]]
    out = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return ([out[r] for r in rids], [eng.status(r) for r in rids],
            seconds, kernels.launch_counts(), rids)


def spec_launches(counts, eng, layers, dlayers, fused=True,
                  kv_dtype="native"):
    """Every kernel's launches in a fault-free run of a speculative engine:
    #1 a layer per whole prefill; #4 a layer per verify and per target
    chunk and a draft layer per sync chunk; the draft scan's γ + 1 steps
    a draft layer each and the plain steps a layer each, on #3 (fused)
    or #2 (generic)."""
    int8 = "_int8" if kv_dtype == "int8" else ""
    want = dict.fromkeys(counts, 0)
    rounds = eng.round_log
    want["flash_prefill"] = layers * len(eng.prefill_seconds)
    want["paged_chunk_attention" + int8] = (
        layers * (len(rounds) + eng.chunk_dispatches)
        + dlayers * eng.spec_sync_chunks)
    step = ("fused_block_decode" if fused else "paged_attention") + int8
    want[step] = (layers * len(eng.decode_step_seconds)
                  + dlayers * sum(r[0] + 1 for r in rounds))
    return want


def spec_keys(eng):
    """Every program key this engine bound: its rungs', the chunk's and
    the speculative ones."""
    keys = list(eng._decode_keys.values()) + list(eng._spec_keys.values())
    return keys + ([eng.chunk_key] if eng.chunk_key is not None else [])


def spec_captures(cache, eng, before):
    """Captures of each of the engine's keys during its life (trace counts
    against ``before``); at most one a key."""
    caps = {k: cache.trace_count(k) - before.get(k, 0)
            for k in spec_keys(eng)}
    require(all(0 <= n <= 1 for n in caps.values()),
            f"spec: captures per key {sorted(caps.values())}")
    return sum(caps.values())


def replay_ms(fn) -> float:
    """Device ms of one replay of an engine program's CUDA graph."""
    return time_ms(fn.graph.replay, iters=10, warmup=2)


def spec_graph_ms(eng):
    """Device ms of one replay of each captured draft scan and verify,
    by kind and γ (CUDA events over replays of the engine's graphs)."""
    out = {}
    for memo, fn in eng._spec_fns.items():
        if memo[0] in ("spec_draft", "spec_verify") and \
                getattr(fn, "graph", None) is not None:
            gamma = memo[1] - (memo[0] == "spec_verify")
            mode = "sample" if "sample" in memo else "greedy"
            out.setdefault(f"{memo[0][5:]}_{mode}", {})[gamma] = \
                replay_ms(fn)
    return out


def break_even(round_ms, step_ms, gamma):
    """The acceptance rate α at which a round of cost ``round_ms``, which
    yields (1 - α^(γ+1)) / (1 - α) tokens in expectation (each proposal
    accepted with probability α), matches plain steps of ``step_ms`` a
    token; None if even full acceptance does not."""
    want = round_ms / step_ms
    if want > gamma + 1:
        return None
    if want <= 1.0:
        return 0.0
    lo, hi = 0.0, 1.0
    for _ in range(60):
        mid = (lo + hi) / 2
        if (1 - mid ** (gamma + 1)) / (1 - mid) < want:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def agreement(got, want, eng_got, eng_want, rids_got, rids_want, what):
    """Streams equal, each first difference with both sides' top-2 margins
    (from the engines' recorded logits), and the logits themselves: at
    every position both engines decided from the same tokens (up to and
    including the first difference) the ``got`` engine's row (a verify's,
    or the prefill's for the first token) is held to the ``want``
    engine's: the RMS of their difference within SPEC_LOGIT_TOL of the
    ``want`` row's standard deviation; and each first difference must
    fall where the ``want`` row's top-2 margin is below twice that (the
    tolerated difference of two entries: a near tie). Returns (equal
    streams, first differences, the largest relative RMS gap)."""
    diffs, worst = [], 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        j = first_difference(a, b)
        rows_got = eng_got.logits[rids_got[i]]
        rows_want = eng_want.logits[rids_want[i]]
        upto = len(a) if j is None else j + 1
        require(len(rows_got) >= upto and len(rows_want) >= upto,
                f"{what}: logits rows not recorded")
        for k in range(upto):
            spread = float(rows_want[k].std())
            gap = float(np.sqrt(np.mean(
                (rows_got[k] - rows_want[k]) ** 2))) / spread
            require(gap <= SPEC_LOGIT_TOL, f"{what}: request {i} token "
                    f"{k}: logits {gap} of the row's spread apart")
            worst = max(worst, gap)
        if j is not None:
            margin = top2_margin(rows_want[j])
            spread = float(rows_want[j].std())
            require(margin < 2 * SPEC_LOGIT_TOL * spread, f"{what}: request "
                    f"{i} parts at token {j} where the plain top-2 margin "
                    f"is {margin}, {margin / spread} of the row's spread "
                    "(not a near tie)")
            diffs.append(dict(
                request=i, token=j, got=a[j], want=b[j],
                got_top2_margin=top2_margin(rows_got[j]),
                want_top2_margin=margin, want_row_std=spread))
    return len(got) - len(diffs), diffs, worst


def runs_of(seq) -> list:
    """``seq`` as [value, run length] pairs."""
    out: list = []
    for v in seq:
        if out and out[-1][0] == v:
            out[-1][1] += 1
        else:
            out.append([v, 1])
    return out


def spec_summary(eng):
    rounds = eng.round_log
    acc = eng.spec_tokens_accepted
    prop = acc + eng.spec_tokens_rejected
    return dict(
        rounds=len(rounds), accepted=acc, rejected=eng.spec_tokens_rejected,
        acceptance=acc / prop if prop else None,
        tokens_per_round=(sum(r[2] for r in rounds) / len(rounds)
                          if rounds else None),
        gamma_trajectory=runs_of([r[0] for r in rounds]),
        round_ms_median_by_gamma={
            g: 1e3 * float(np.median([r[3] for r in rounds if r[0] == g]))
            for g in sorted({r[0] for r in rounds})},
        sync_chunks=eng.spec_sync_chunks)


def run_spec(model) -> dict:
    """The spec phase on serve's model (see the module docstring). Returns
    the launch counts of its fault-free runs, summed."""
    from paddle_tpu_torch.generation.program_cache import (
        clear_decode_program_cache, decode_program_cache)
    t_phase = time.perf_counter()
    cfg = model.config
    vocab, layers = cfg.vocab_size, cfg.num_hidden_layers
    dlayers = DRAFT_GEOM["layers"]
    clear_decode_program_cache()
    cache = decode_program_cache()
    device = model.device
    t0 = time.perf_counter()
    draft = draft_model(device, torch.bfloat16)
    torch.cuda.synchronize()
    row = dict(model="llama2_7b", layers=layers, dtype="bf16",
               draft="tinyllama_1.1b shape, seeded", draft_layers=dlayers,
               draft_build_s=time.perf_counter() - t0, page_size=PAGE,
               max_seq_len=MAX_SEQ, prompt_lens=list(SPEC_LENS),
               new_tokens=SPEC_NEW, spec_max_slots=SPEC_SLOTS)
    total: dict = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # 1. batch 1: the draft, the plain engine, the target as its own draft
    # and the all-zero draft
    plain = spec_engine(model, None, record_logits=True)
    spec_warm(plain, vocab)
    p_streams, _, p_seconds, _, p_rids = spec_traffic(plain, vocab,
                                                      SPEC_LENS, SPEC_NEW)
    step_ms = 1e3 * float(np.median(plain.decode_step_seconds))
    step_dev = replay_ms(plain._decode_fns[1])
    row["plain"] = dict(tokens_per_s=sum(map(len, p_streams)) / p_seconds,
                        step_ms_median=step_ms, step_device_ms=step_dev)
    # the yardstick: the plain engine's generic route against its fused
    # one, two correct bf16 paths, held to the same tolerance
    yard = spec_engine(model, None, fused=False, record_logits=True)
    spec_warm(yard, vocab)
    y_streams, _, _, _, y_rids = spec_traffic(yard, vocab, SPEC_LENS,
                                              SPEC_NEW)
    same, diffs, gap = agreement(y_streams, p_streams, yard, plain, y_rids,
                                 p_rids, "spec yardstick")
    row["yardstick"] = dict(route="plain generic vs plain fused",
                            streams_equal=same, first_differences=diffs,
                            max_logit_gap=gap, logit_tol=SPEC_LOGIT_TOL)
    del yard
    runs = {}
    for name, d, fused in (("draft", draft, True),
                           ("draft generic", draft, False),
                           ("self", model, True)):
        before = {k: cache.trace_count(k) for k in cache.keys()}
        eng = spec_engine(model, d, fused=fused, record_logits=True)
        require((eng._draft_fspec is not None) == fused,
                f"spec {name}: draft route not as asked")
        spec_warm(eng, vocab)
        streams, statuses, seconds, counts, rids = spec_traffic(
            eng, vocab, SPEC_LENS, SPEC_NEW)
        require(statuses == ["OK"] * len(SPEC_LENS),
                f"spec {name}: {statuses}")
        check_tokens(list(zip(rids, prompts(vocab, SPEC_LENS), streams)),
                     vocab, SPEC_NEW)
        dl = layers if d is model else dlayers
        require_launches(counts, spec_launches(counts, eng, layers, dl,
                                               fused), f"spec {name}")
        # gap-free rounds: at batch 1 the draft syncs only at admission
        syncs = sum(-(-n // eng.spec_sync_chunk) for n in SPEC_LENS)
        require(eng.spec_sync_chunks == syncs,
                f"spec {name}: {eng.spec_sync_chunks} sync chunks, want "
                f"{syncs} (one catch-up a request)")
        add(counts)
        same, diffs, gap = agreement(streams, p_streams, eng, plain, rids,
                                     p_rids, f"spec {name}")
        gen = sum(map(len, streams))
        out = dict(spec_summary(eng), tokens_per_s=gen / seconds,
                   streams_equal_to_plain=same, first_differences=diffs,
                   max_logit_gap=gap, logit_tol=SPEC_LOGIT_TOL,
                   graph_ms=spec_graph_ms(eng), launches=counts)
        # the request that fills its table, on the same engine
        tp = prompts(vocab, (SPEC_TABLE_END,))[0]
        rid = eng.submit(tp, SPEC_NEW)
        toks = eng.run()[rid]
        require(eng.status(rid) == "OK" and len(toks) == SPEC_NEW
                and all(0 <= t < vocab for t in toks),
                f"spec {name}: the table's-end request {eng.status(rid)}")
        out["table_end"] = dict(prompt=SPEC_TABLE_END, new=SPEC_NEW,
                                status="OK")
        out["captures"] = spec_captures(cache, eng, before)
        runs[name] = out
        if name == "self":
            require(max(r[0] for r in eng.round_log) == max(SPEC_RUNGS),
                    f"spec self: γ never reached 8: "
                    f"{out['gamma_trajectory']}")
        del eng
        torch.cuda.empty_cache()
    zero = draft_model(device, torch.bfloat16, zero=True)
    eng = spec_engine(model, zero)
    spec_warm(eng, vocab)
    streams, statuses, seconds, counts, rids = spec_traffic(
        eng, vocab, SPEC_LENS, SPEC_NEW)
    require(statuses == ["OK"] * len(SPEC_LENS), f"spec zero: {statuses}")
    require_launches(counts, spec_launches(counts, eng, layers, dlayers),
                     "spec zero")
    add(counts)
    out = dict(spec_summary(eng), tokens_per_s=sum(map(len, streams))
               / seconds)
    require(eng.round_log[-1][0] == min(SPEC_RUNGS),
            f"spec zero: γ did not fall to 2: {out['gamma_trajectory']}")
    runs["zero"] = out
    del eng, zero
    torch.cuda.empty_cache()
    # the break-even acceptance per γ against the plain step, from the
    # draft's rounds (device: the graphs' replays; wall: the rounds')
    d = runs["draft"]
    be = {}
    for g in sorted(d["graph_ms"].get("draft_greedy", {})):
        dev = (d["graph_ms"]["draft_greedy"][g]
               + d["graph_ms"]["verify_greedy"][g])
        wall = d["round_ms_median_by_gamma"].get(g)
        be[g] = dict(round_device_ms=dev,
                     alpha_device=break_even(dev, step_dev, g),
                     round_wall_ms=wall,
                     alpha_wall=(break_even(wall, step_ms, g)
                                 if wall is not None else None))
    row.update(runs=runs, break_even=be,
               plain_step_device_ms=step_dev, plain_step_wall_ms=step_ms)
    del plain
    torch.cuda.empty_cache()

    # 2. serve's traffic at max_batch 4 under the default pricing
    eng = spec_engine(model, draft, max_batch=BATCH, slots=None,
                      record_logits=True)
    ref = spec_engine(model, None, max_batch=BATCH, record_logits=True)
    for e in (eng, ref):
        spec_warm(e, vocab)
    streams, statuses, seconds, counts, rids = spec_traffic(
        eng, vocab, PROMPT_LENS, NEW_TOKENS, stagger=6)
    require(statuses == ["OK"] * len(PROMPT_LENS), f"spec serve: {statuses}")
    require_launches(counts, spec_launches(counts, eng, layers, dlayers),
                     "spec serve")
    require(eng.round_log and eng.decode_step_seconds,
            "spec serve: the steps did not mix")
    add(counts)
    r_streams, _, r_seconds, _, r_rids = spec_traffic(
        ref, vocab, PROMPT_LENS, NEW_TOKENS, stagger=6)
    same, diffs, gap = agreement(streams, r_streams, eng, ref, rids, r_rids,
                                 "spec serve")
    gen = sum(map(len, streams))
    row["serve"] = dict(
        spec_summary(eng), batch=BATCH, prompt_lens=list(PROMPT_LENS),
        new_tokens=NEW_TOKENS, spec_slots=eng.spec_slots,
        plain_steps=len(eng.decode_step_seconds), tokens_per_s=gen / seconds,
        plain_engine_tokens_per_s=gen / r_seconds,
        streams_equal_to_plain=same, first_differences=diffs,
        max_logit_gap=gap, logit_tol=SPEC_LOGIT_TOL, launches=counts)
    del eng, ref
    torch.cuda.empty_cache()

    # 3. an int8 pool, batch 1, beside the plain engine on an int8 pool
    eng = spec_engine(model, draft, kv_dtype="int8", record_logits=True)
    ref = spec_engine(model, None, kv_dtype="int8", record_logits=True)
    for e in (eng, ref):
        spec_warm(e, vocab)
    streams, statuses, seconds, counts, rids = spec_traffic(
        eng, vocab, SPEC_LENS, SPEC_NEW)
    require(statuses == ["OK"] * len(SPEC_LENS), f"spec int8: {statuses}")
    require_launches(counts, spec_launches(counts, eng, layers, dlayers,
                                           kv_dtype="int8"), "spec int8")
    add(counts)
    r_streams, _, _, _, r_rids = spec_traffic(ref, vocab, SPEC_LENS,
                                              SPEC_NEW)
    same, diffs, gap = agreement(streams, r_streams, eng, ref, rids, r_rids,
                                 "spec int8")
    row["int8"] = dict(spec_summary(eng), tokens_per_s=sum(map(len, streams))
                       / seconds, streams_equal_to_plain=same,
                       first_differences=diffs, max_logit_gap=gap,
                       logit_tol=SPEC_LOGIT_TOL, launches=counts)
    del eng, ref
    torch.cuda.empty_cache()

    # 4. sampled: two fault-free runs a seed, then a faulted one
    row["sampled"] = spec_sampled(model, draft, vocab, layers, dlayers,
                                  require_faulted_equal=False)
    add(row["sampled"].pop("counts"))
    row["phase_seconds"] = time.perf_counter() - t_phase
    emit("spec", **row)
    del draft
    torch.cuda.empty_cache()
    return total


def spec_sampled(model, draft, vocab, layers, dlayers,
                 require_faulted_equal: bool) -> dict:
    """SPEC_SEEDS sampled requests (SPEC_SAMPLE's law), one prompt of
    SPEC_LENS each: two fault-free runs a seed on one engine must be
    equal; a run under SPEC_FAULTS is compared with them, and held equal
    when ``require_faulted_equal`` (fp32). A replayed round draws the same
    uniforms, but its replay re-prefills the KV the round reads: in bf16
    that rounds otherwise, the drafts' and targets' laws move by a rounding
    step, and a draw near a boundary may change. Returns the observation,
    with the first fault-free run's launch counts under ``counts``."""
    from paddle_tpu_torch import kernels
    eng = spec_engine(model, draft)
    spec_warm(eng, vocab)
    ps = prompts(vocab, SPEC_LENS)
    runs = []
    counts = None
    for rep in range(2):
        torch.cuda.synchronize()
        kernels.reset_launches()
        eng.round_log.clear()
        eng.prefill_seconds.clear()
        eng.decode_step_seconds.clear()
        eng.chunk_dispatches = eng.spec_sync_chunks = 0
        rids = [eng.submit(p, SPEC_NEW, seed=s, **SPEC_SAMPLE)
                for p, s in zip(ps, SPEC_SEEDS)]
        out = eng.run()
        torch.cuda.synchronize()
        require([eng.status(r) for r in rids] == ["OK"] * len(rids),
                "spec sampled: a request did not end OK")
        runs.append([out[r] for r in rids])
        if rep == 0:
            counts = kernels.launch_counts()
            require_launches(counts, spec_launches(counts, eng, layers,
                                                   dlayers), "spec sampled")
            summary = spec_summary(eng)
    require(runs[0] == runs[1], "spec sampled: two runs of one seed differ")
    for toks in runs[0]:
        require(len(toks) == SPEC_NEW and all(0 <= t < vocab for t in toks),
                "spec sampled: tokens")
    graphs = spec_graph_ms(eng)
    del eng
    faulted = spec_engine(model, draft, spec=SPEC_FAULTS)
    rids = [faulted.submit(p, SPEC_NEW, seed=s, **SPEC_SAMPLE)
            for p, s in zip(ps, SPEC_SEEDS)]
    out = faulted.run()
    require([faulted.status(r) for r in rids] == ["OK"] * len(rids),
            "spec sampled faulted: a request did not end OK")
    got = [out[r] for r in rids]
    fires = sum(s.fires for s in (faulted._f_spec_draft,
                                  faulted._f_spec_verify))
    require(fires > 0, "spec sampled faulted: no fault fired")
    diffs = [dict(seed=s, token=first_difference(a, b))
             for s, a, b in zip(SPEC_SEEDS, got, runs[0]) if a != b]
    if require_faulted_equal:
        require(not diffs, f"spec sampled: faulted streams differ {diffs}")
    del faulted
    torch.cuda.empty_cache()
    return dict(summary, law=SPEC_SAMPLE, seeds=list(SPEC_SEEDS),
                runs_equal=True, faults=SPEC_FAULTS, faults_fired=fires,
                faulted_equal=len(SPEC_SEEDS) - len(diffs),
                faulted_first_differences=diffs, graph_ms=graphs,
                counts=counts)


def run_spec_parity(model):
    """The fp32 parity model with a divergent 1-layer TinyLlama-shaped
    draft: the batch-1 traffic and serve's traffic equal to the plain
    engine's token for token, the sampled runs deterministic and equal
    under SPEC_FAULTS; then the model as its own draft, accepting nearly
    every proposal."""
    t_phase = time.perf_counter()
    vocab = model.config.vocab_size
    layers = model.config.num_hidden_layers
    draft = draft_model(model.device, torch.float32, layers=1)
    got = {}
    for name, batch, slots, lens, new, stagger in (
            ("batch 1", 1, SPEC_SLOTS, SPEC_LENS, SPEC_NEW, 0),
            ("serve", BATCH, None, PROMPT_LENS, NEW_TOKENS, 6)):
        eng = spec_engine(model, draft, max_batch=batch, slots=slots)
        ref = spec_engine(model, None, max_batch=batch)
        streams, statuses, _, _, _ = spec_traffic(eng, vocab, lens, new,
                                                  stagger)
        want, _, _, _, _ = spec_traffic(ref, vocab, lens, new, stagger)
        require(statuses == ["OK"] * len(lens), f"spec parity {name}")
        require(streams == want, f"spec parity {name}: the speculative "
                f"streams differ from the plain engine's")
        require(eng.spec_tokens_rejected > 0 and eng.spec_rounds > 0,
                f"spec parity {name}: no rejection")
        got[name] = dict(requests=len(lens), streams_equal=len(lens),
                         rounds=eng.spec_rounds,
                         accepted=eng.spec_tokens_accepted,
                         rejected=eng.spec_tokens_rejected)
        del eng, ref
    sampled = spec_sampled(model, draft, vocab, layers, 1,
                           require_faulted_equal=True)
    sampled.pop("counts")
    # the target as its own draft: in fp32 the scan's and the verify's
    # argmaxes part only at ties, so nearly every proposal is accepted
    # (a draft KV written at a wrong position would show here)
    eng = spec_engine(model, model)
    streams, statuses, _, _, _ = spec_traffic(eng, vocab, SPEC_LENS,
                                              SPEC_NEW)
    acc = eng.spec_tokens_accepted / (eng.spec_tokens_accepted
                                      + eng.spec_tokens_rejected)
    require(statuses == ["OK"] * len(SPEC_LENS) and acc >= 0.95
            and max(r[0] for r in eng.round_log) == max(SPEC_RUNGS),
            f"spec parity self: acceptance {acc}, statuses {statuses}")
    got["self"] = dict(spec_summary(eng))
    del eng
    emit("spec", part="parity", model="llama2_7b width, 2 layers",
         draft="tinyllama_1.1b shape, 1 layer", dtype="fp32", runs=got,
         sampled=dict(runs_equal=True, faults=SPEC_FAULTS,
                      faults_fired=sampled["faults_fired"],
                      faulted_equal=sampled["faulted_equal"]),
         phase_seconds=time.perf_counter() - t_phase)
    del draft
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- parity
def run_parity(device):
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = 2
    model = LlamaForCausalLM(cfg, device=device, dtype=torch.float32,
                             generator=seed(SEED + 7, device))
    chunks = sum(-(-n // CHUNK) for n in PARITY_LENS if n > CHUNK)
    for fused, group in ((True, 1), (False, 1), (True, 2)):
        eng, res, _, counts, _ = serve(model, fused, PARITY_NEW_TOKENS,
                                       PARITY_LENS, record_logits=True,
                                       group=group)
        require(counts["paged_chunk_attention"] == 2 * chunks,
                f"parity: paged_chunk_attention ran "
                f"{counts['paged_chunk_attention']} times")
        require((counts["fused_multi_block_decode"] > 0) == (group > 1),
                "parity: N-layer route not as asked")
        worst, checked, skipped = 0.0, 0, 0
        for rid, prompt, toks in res:
            rows = torch.from_numpy(np.stack(eng.logits[rid])).to(device)
            ids = torch.from_numpy(np.concatenate(
                [prompt, np.asarray(toks[:-1], np.int32)]).astype(np.int64))
            with torch.inference_mode():
                ref = model(ids[None].to(device))[0, len(prompt) - 1:].float()
            require(ref.shape == rows.shape, "parity: logits shape")
            require(bool(torch.isfinite(rows).all()), "parity: non-finite")
            worst = max(worst, max_err(rows, ref))
            top2 = ref.topk(2, dim=-1).values
            decided = (top2[:, 0] - top2[:, 1]) > PARITY_TOL
            ref_tok = ref.argmax(-1).cpu().numpy()
            for j, tok in enumerate(toks):
                if bool(decided[j]):
                    require(int(ref_tok[j]) == tok,
                            f"parity: token {j} of request {rid}: engine "
                            f"{tok}, reference {int(ref_tok[j])}")
                    checked += 1
                else:
                    skipped += 1
        require(worst <= PARITY_TOL, f"parity: logits err {worst} > "
                f"{PARITY_TOL}")
        emit("parity", model="llama2_7b width, 2 layers", dtype="fp32",
             decode="fused" if fused else "generic",
             fused_block_layers=group, prompt_lens=list(PARITY_LENS),
             prefill_chunk=CHUNK, chunks=eng.chunk_dispatches,
             requests=len(res), max_logit_err=worst, tol=PARITY_TOL,
             tokens_checked=checked, tokens_within_tol_gap=skipped,
             launches=counts)
        del eng
    run_sched_parity(model)
    run_prefix_parity(model)
    run_recovery_parity(model)
    run_spec_parity(model)
    run_generate_parity(model)
    run_handoff_parity(model, SEED + 7)
    run_tp_parity(model)
    run_fleet_parity(model)
    run_quant_parity(model)
    del model
    torch.cuda.empty_cache()
    run_gpt_parity(device)


# ------------------------------------------------------------- generate
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 128, 32
GEN_SAMPLE_SEED = 5
BEAM_PROMPT, BEAM_NEW, BEAMS = 64, 16, 4
# bf16: how far the beam's length-normalised log-probability (nats a token,
# both sequences rescored by one no-cache forward) may fall below greedy's.
# The search scores the cached forward's logits and the rescoring the
# no-cache forward's, which round differently in bf16: a logit near 4
# moves by a bf16 step (2^-6) between the two, and a token's log-softmax
# by a few of them
BEAM_TOL = 2.0 ** -4
GEN_GAMMA, GEN_SPEC_NEW = 4, 64
# the fused entry points at 7B width: fused_multi_transformer's layers, the
# prefill (B x S) and the decode steps after it
FMT_LAYERS, FE_BATCH, FE_PROMPT, FE_STEPS = 4, 4, 128, 16
# fp32 parity model: prompts, new tokens; the beam's tolerance (nats a
# token: the cached and the no-cache forward sum in another order)
GEN_PARITY_BATCH, GEN_PARITY_PROMPT, GEN_PARITY_NEW = 2, 64, 16
BEAM_PARITY_TOL = 1e-4


@contextlib.contextmanager
def recorded(model):
    """For the ``with`` block, keep the last position's f32 logits of every
    cached forward a generation loop makes (the yielded list, on the host),
    by wrapping the model's ``forward_with_cache``."""
    rows = []
    inner = model.forward_with_cache

    def forward_with_cache(ids, caches, offset):
        logits, caches = inner(ids, caches, offset)
        rows.append(logits[:, -1].float().cpu().numpy())
        return logits, caches
    model.forward_with_cache = forward_with_cache
    try:
        yield rows
    finally:
        del model.forward_with_cache


def first_top_tie(rows, row):
    """The first step at which batch row ``row``'s logits tie at the top
    (two or more equal maxima; a top-k filter keeps them all), else
    None."""
    for j, r in enumerate(rows):
        top = np.sort(r[row])[-2:]
        if top[0] == top[1]:
            return j
    return None


def counted(fn, total=None):
    """``fn()`` with the launch counters set to 0 just before and read just
    after; returns (result, counts, seconds). ``total`` sums the counts."""
    from paddle_tpu_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    if total is not None:
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    return out, counts, seconds


def only(counts, **want) -> dict:
    """``counts``' keys, 0 for each but those named."""
    out = dict.fromkeys(counts, 0)
    out.update(want)
    return out


def seq_logprob(model, full, p) -> np.ndarray:
    """Each row's length-normalised log-probability of its tokens after
    position ``p``, from one no-cache forward (f32 log-softmax)."""
    with torch.inference_mode():
        lp = torch.log_softmax(model(full[:, :-1].long()).float(), dim=-1)
    tok = full[:, p:].long()
    got = lp[:, p - 1:].gather(-1, tok[..., None])[..., 0]
    return (got.sum(-1) / tok.shape[1]).cpu().numpy()


def run_generate(model) -> dict:
    """The generate phase on serve's Llama-2-7B: greedy ``generate`` (its
    agreement with the ServingEngine's streams reported), sampled, beam,
    ``generate_paged`` and ``generate_speculative`` with the
    TinyLlama-shaped draft, then Paddle's four fused serving entry points
    at 7B width. Returns the launch counts of every counted run."""
    from paddle_tpu_torch.generation.serving import ServingEngine
    device = model.device
    cfg = model.config
    layers, vocab = cfg.num_hidden_layers, cfg.vocab_size
    t_phase = time.perf_counter()
    total: dict = {}
    ids = torch.from_numpy(np.stack(prompts(vocab, (GEN_PROMPT,)
                                            * GEN_BATCH))).to(device)
    # first calls (library loads, cuBLAS handles), not counted
    model.generate(ids[:1, :9], max_new_tokens=2)

    greedy, c, sec = counted(lambda: model.generate(
        ids, max_new_tokens=GEN_NEW, return_full_sequence=False), total)
    require_launches(c, only(c, flash_prefill=layers), "generate greedy")
    # again with each step's logits copied to the host (ties, margins): the
    # copy waits for the card every step, so the timed run above has none
    with recorded(model) as rows:
        again = model.generate(ids, max_new_tokens=GEN_NEW,
                               return_full_sequence=False)
    require(torch.equal(again, greedy), "generate greedy: two runs differ")
    g_np = greedy.cpu().numpy()
    require(g_np.shape == (GEN_BATCH, GEN_NEW)
            and bool(((g_np >= 0) & (g_np < vocab)).all()),
            "generate: tokens")
    ties = [first_top_tie(rows, r) for r in range(GEN_BATCH)]
    eng = ServingEngine(model, max_batch=GEN_BATCH, page_size=PAGE,
                        max_seq_len=MAX_SEQ, record_logits=True)
    rids = [eng.submit(ids[r].cpu().numpy().astype(np.int32), GEN_NEW)
            for r in range(GEN_BATCH)]
    streams = eng.run()
    vs_engine = []
    for r, rid in enumerate(rids):
        j = first_difference(g_np[r].tolist(), streams[rid])
        vs_engine.append(dict(
            first_difference=j,
            engine_top2_margin=None if j is None else top2_margin(
                eng.logits[rid][j]),
            generate_top2_margin=None if j is None else top2_margin(
                rows[j][r])))
    del eng
    emit("generate", run="greedy", model="llama2_7b", layers=layers,
         dtype="bf16", batch=GEN_BATCH, prompt_len=GEN_PROMPT,
         new_tokens=GEN_NEW, seconds=sec,
         ms_per_step=1e3 * sec / GEN_NEW, launches=c,
         first_top_tie=ties, vs_serving_engine=vs_engine)

    def sampled(**law):
        g = torch.Generator(device=device).manual_seed(GEN_SAMPLE_SEED)
        return model.generate(ids, max_new_tokens=GEN_NEW, do_sample=True,
                              generator=g, return_full_sequence=False,
                              **law)

    s1, c, sec = counted(lambda: sampled(**SPEC_SAMPLE), total)
    s2, _, _ = counted(lambda: sampled(**SPEC_SAMPLE), total)
    require(torch.equal(s1, s2), "generate sampled: one seed, two streams")
    require_launches(c, only(c, flash_prefill=layers), "generate sampled")
    with recorded(model) as k1_rows:
        top1, _, _ = counted(lambda: sampled(temperature=0.8, top_k=1),
                             total)
    t_np = top1.cpu().numpy()
    # top-k = 1 is greedy up to a row's first bf16 tie at the top (there
    # the filter keeps every tied token, as the JAX package's does) ...
    for r in range(GEN_BATCH):
        upto = GEN_NEW if ties[r] is None else ties[r]
        require(np.array_equal(t_np[r, :upto], g_np[r, :upto]),
                f"generate top_k=1: row {r} differs from greedy before its "
                f"first tie ({upto})")
    # ... and every token of the whole stream is one of the maxima of its
    # own step's logits
    require(len(k1_rows) == GEN_NEW, f"generate top_k=1: {len(k1_rows)} "
            f"logits rows for {GEN_NEW} tokens")
    off_top = [(j, r) for j, lg in enumerate(k1_rows)
               for r in range(GEN_BATCH) if lg[r, t_np[r, j]] != lg[r].max()]
    require(not off_top, f"generate top_k=1: (step, row) {off_top[:4]} "
            f"not at their step's maximum")
    emit("generate", run="sampled", law=SPEC_SAMPLE, seed=GEN_SAMPLE_SEED,
         seconds=sec, two_runs_equal=True,
         top_k1_first_difference=[first_difference(
             t_np[r].tolist(), g_np[r].tolist()) for r in range(GEN_BATCH)],
         launches=c)

    bids = ids[:1, :BEAM_PROMPT]
    beam, c, sec = counted(lambda: model.generate(
        bids, max_new_tokens=BEAM_NEW, num_beams=BEAMS), total)
    require_launches(c, only(c, flash_prefill=layers), "generate beam")
    bgreedy = model.generate(bids, max_new_tokens=BEAM_NEW)
    lp_beam = float(seq_logprob(model, beam, BEAM_PROMPT)[0])
    lp_greedy = float(seq_logprob(model, bgreedy, BEAM_PROMPT)[0])
    require(lp_beam >= lp_greedy - BEAM_TOL,
            f"beam: log-probability {lp_beam} below greedy's {lp_greedy}")
    emit("generate", run="beam", batch=1, num_beams=BEAMS,
         prompt_len=BEAM_PROMPT, new_tokens=BEAM_NEW, seconds=sec,
         logprob_per_token=lp_beam, greedy_logprob_per_token=lp_greedy,
         tol=BEAM_TOL, same_as_greedy=bool(torch.equal(beam, bgreedy)),
         launches=c)

    paged, c, sec = counted(lambda: model.generate_paged(
        ids, max_new_tokens=GEN_NEW, page_size=PAGE,
        return_full_sequence=False), total)
    require_launches(c, only(c, flash_prefill=layers,
                             paged_attention=layers * (GEN_NEW - 1)),
                     "generate_paged")
    p_np = paged.cpu().numpy()
    emit("generate", run="generate_paged", batch=GEN_BATCH,
         prompt_len=GEN_PROMPT, new_tokens=GEN_NEW, page_size=PAGE,
         seconds=sec, ms_per_step=1e3 * sec / GEN_NEW,
         vs_generate_first_difference=[first_difference(
             p_np[r].tolist(), g_np[r].tolist()) for r in range(GEN_BATCH)],
         launches=c)

    draft = draft_model(device, torch.bfloat16)
    dlayers = draft.config.num_hidden_layers
    sids = ids[:1]
    model.generate_speculative(sids[:, :9], draft, max_new_tokens=4,
                               num_speculative_tokens=GEN_GAMMA)
    ref, _, ref_s = counted(lambda: model.generate(
        sids, max_new_tokens=GEN_SPEC_NEW, return_full_sequence=False),
        total)
    spec, c, sec = counted(lambda: model.generate_speculative(
        sids, draft, max_new_tokens=GEN_SPEC_NEW,
        num_speculative_tokens=GEN_GAMMA, return_full_sequence=False),
        total)
    st = dict(model.speculative_stats)
    require_launches(c, only(c, flash_prefill=layers * (1 + st["rounds"])
                             + dlayers), "generate_speculative")
    emit("generate", run="generate_speculative", draft="tinyllama_1.1b "
         "shape", draft_layers=dlayers, gamma=GEN_GAMMA, prompt_len=GEN_PROMPT,
         new_tokens=GEN_SPEC_NEW, rounds=st["rounds"],
         acceptance=st["accepted"] / st["proposed"],
         tokens_per_round=GEN_SPEC_NEW / st["rounds"], seconds=sec,
         ms_per_token=1e3 * sec / GEN_SPEC_NEW,
         generate_ms_per_token=1e3 * ref_s / GEN_SPEC_NEW,
         vs_generate_first_difference=first_difference(
             spec[0].tolist(), ref[0].tolist()), launches=c)
    del draft
    torch.cuda.empty_cache()

    run_fused_entry_points(device, total)
    emit("generate", run="phase", seconds=time.perf_counter() - t_phase,
         launches=total)
    return total


@contextlib.contextmanager
def plain_attention():
    """For the ``with`` block, the serving entry points' kernels swapped for
    their plain versions (the names the entry modules call): the same
    entry point, no launch."""
    from paddle_tpu_torch.incubate.nn import functional as FF
    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.kernels import fused_block_decode as fb
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.nn import functional as F
    swaps = ((F, "cached_attention", da.cached_attention_dense),
             (F, "paged_attention", pa.paged_attention_ref),
             (FF, "cached_attention", da.cached_attention_dense),
             (FF, "_fbd", fb.fused_block_decode_ref))
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


@contextlib.contextmanager
def attention_taps(module, check=None):
    """For the ``with`` block, wrap ``module.cached_attention`` (whatever it
    is then: the kernel route, or its plain swap under ``plain_attention``)
    to keep a copy of each call's output, in call order, and with
    ``check`` the max error of that output against ``check`` on the same
    inputs. Yields the two lists."""
    outs, errs = [], []
    inner = module.cached_attention

    def tap(q, k, v, cur_len, *args, **kw):
        out = inner(q, k, v, cur_len, *args, **kw)
        outs.append(out.clone())
        if check is not None:
            errs.append(max_err(out, check(q, k, v, cur_len, *args, **kw)))
        return out
    module.cached_attention = tap
    try:
        yield outs, errs
    finally:
        module.cached_attention = inner


def fmt_weights(gen, dtype, device, layers):
    """fused_multi_transformer's weight lists at 7B width (Paddle's
    ``(3, H, D, E)`` qkv layout), scaled so the residual stream stays near
    1 (one bf16 step of it within TOL)."""
    h, inter = HIDDEN, INTER

    def mat(*shape):
        return _rand(gen, shape, dtype, device, 0.25 / math.sqrt(shape[-1]
                     if len(shape) == 4 else shape[0]))

    def vec(n, base=0.0):
        return (base + 0.05 * torch.randn(n, generator=gen, device=device)
                ).to(dtype)

    return dict(
        ln_scales=[vec(h, 1.0) for _ in range(layers)],
        ln_biases=[vec(h) for _ in range(layers)],
        qkv_weights=[mat(3, HEADS, HEAD_DIM, h) for _ in range(layers)],
        qkv_biases=[_rand(gen, (3, HEADS, HEAD_DIM), dtype, device, 0.05)
                    for _ in range(layers)],
        linear_weights=[mat(h, h) for _ in range(layers)],
        linear_biases=[vec(h) for _ in range(layers)],
        ffn_ln_scales=[vec(h, 1.0) for _ in range(layers)],
        ffn_ln_biases=[vec(h) for _ in range(layers)],
        ffn1_weights=[mat(h, inter) for _ in range(layers)],
        ffn1_biases=[vec(inter) for _ in range(layers)],
        ffn2_weights=[mat(inter, h) for _ in range(layers)],
        ffn2_biases=[vec(h) for _ in range(layers)])


def run_fused_entry_points(device, total):
    """Paddle's four fused serving entry points at Llama-2-7B width, bf16,
    each a prefill (B = 4, S = 128) or its cache written, then FE_STEPS
    decode steps, against the same entry point on the plain versions
    (``plain_attention``) under the kernels' tolerance: exact launches in
    the kernel run, none in the plain one."""
    from paddle_tpu_torch.incubate.nn import functional as FF
    from paddle_tpu_torch.kernels import decode_attention as da
    dtype = torch.bfloat16
    tol = TOL[dtype]
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    b, s, n = FE_BATCH, FE_PROMPT, FE_STEPS
    t = s + n

    # fused_multi_transformer: FMT_LAYERS layers over (2, B, H, T, D)
    w = fmt_weights(gen, dtype, device, FMT_LAYERS)
    x = _rand(gen, (b, t, HIDDEN), dtype, device, 0.2)

    def fmt():
        caches = [torch.zeros((2, b, HEADS, t, HEAD_DIM), dtype=dtype,
                              device=device) for _ in range(FMT_LAYERS)]
        outs = [FF.fused_multi_transformer(x[:, :s], **w, cache_kvs=caches,
                                           time_step=0)[0]]
        for i in range(n):
            outs.append(FF.fused_multi_transformer(
                x[:, s + i:s + i + 1], **w, cache_kvs=caches,
                time_step=s + i)[0])
        return outs, caches

    (got, gc), c, sec = counted(fmt, total)
    require_launches(c, only(c, flash_prefill=FMT_LAYERS),
                     "fused_multi_transformer")
    # the residual stream carries each layer's attention only in part (the
    # out-projection is scaled by 0.25 / sqrt(E)), so every call's
    # attention output is held too: once against the dense composition on
    # the very inputs the entry point gave the kernel, once against the
    # plain run's
    with attention_taps(FF, da.cached_attention_dense) as (k_attn, same):
        counted(fmt)
    with plain_attention():
        with attention_taps(FF) as (p_attn, _):
            (want, wc), pc, _ = counted(fmt)
    require(not any(pc.values()), f"plain fused_multi_transformer "
            f"launched {pc}")
    calls = FMT_LAYERS * (n + 1)
    require(len(k_attn) == len(p_attn) == len(same) == calls,
            f"fused_multi_transformer: {len(k_attn)}/{len(p_attn)} "
            f"attention calls, {calls} expected")
    err = max(max_err(a, r) for a, r in zip(got, want))
    cerr = max(max_err(a, r) for a, r in zip(gc, wc))
    aerr = max(max_err(a, r) for a, r in zip(k_attn, p_attn))
    serr = max(same)
    require(max(err, cerr, aerr, serr) <= tol, f"fused_multi_transformer: "
            f"max err {err}, caches {cerr}, attention {aerr}, attention on "
            f"the same inputs {serr}")
    emit("generate", run="fused_multi_transformer", layers=FMT_LAYERS,
         hidden=HIDDEN, heads=HEADS, batch=b, prompt_len=s, decode_steps=n,
         dtype="bf16", max_err=err, cache_max_err=cerr,
         attention_max_err=aerr, attention_same_input_max_err=serr,
         prefill_attention_max_abs=max(
             float(a.float().abs().max()) for a in k_attn[:FMT_LAYERS]),
         tol=tol, seconds=sec, launches=c)
    del w, x, got, gc, want, wc, k_attn, p_attn

    # masked_multihead_attention: one token a step over (2, B, T, H, D)
    cache0 = _rand(gen, (2, b, t, HEADS, HEAD_DIM), dtype, device)
    cache0[:, :, s:] = RING_JUNK
    xs = _rand(gen, (n, b, 3 * HEADS * HEAD_DIM), dtype, device)

    def mmha():
        cache = cache0.clone()
        return [FF.masked_multihead_attention(xs[i], cache,
                                              sequence_lengths=s + i)[0]
                for i in range(n)], cache

    (got, gc), c, sec = counted(mmha, total)
    require_launches(c, only(c), "masked_multihead_attention")
    cache = cache0.clone()
    err = 0.0
    for i in range(n):
        qkv = xs[i].reshape(b, 1, 3, HEADS, HEAD_DIM)
        cache[0][:, s + i] = qkv[:, 0, 1]
        cache[1][:, s + i] = qkv[:, 0, 2]
        ref = da.cached_attention_dense(qkv[:, :, 0], cache[0], cache[1],
                                        s + i + 1)
        err = max(err, max_err(got[i], ref.reshape(b, -1)))
    require(err <= tol and torch.equal(gc, cache),
            f"masked_multihead_attention: max err {err}")
    emit("generate", run="masked_multihead_attention", batch=b,
         cache_len=t, start=s, decode_steps=n, dtype="bf16", max_err=err,
         tol=tol, seconds=sec, launches=c)
    del cache0, cache, gc, got

    # block_multihead_attention: prefill, then n decode steps through
    # block tables over a pool with no null page
    bt, num_pages = _rect_tables(b, t, device)
    qkv_pre = _rand(gen, (b, s, 3, HEADS, HEAD_DIM), dtype, device)
    qkv_dec = _rand(gen, (n, b, 1, 3, HEADS, HEAD_DIM), dtype, device)
    zeros = np.zeros(b, np.int32)

    def bmha():
        shape = (KV_HEADS, num_pages, PAGE, HEAD_DIM)
        kp = torch.zeros(shape, dtype=dtype, device=device)
        vp = torch.zeros_like(kp)
        outs = [FF.block_multihead_attention(
            qkv_pre, kp, vp, np.full(b, s, np.int32), zeros,
            np.full(b, s, np.int32), bt)[0]]
        for i in range(n):
            outs.append(FF.block_multihead_attention(
                qkv_dec[i], kp, vp, zeros, np.full(b, s + i, np.int32),
                np.ones(b, np.int32), bt)[0])
        return outs, kp, vp

    (got, gk, gv), c, sec = counted(bmha, total)
    require_launches(c, only(c, flash_prefill=1, paged_attention=n),
                     "block_multihead_attention")
    with plain_attention():
        (want, wk, wv), pc, _ = counted(bmha)
    require(not any(pc.values()), f"plain block_multihead_attention "
            f"launched {pc}")
    err = max(max_err(a, r) for a, r in zip(got, want))
    require(err <= tol and torch.equal(gk, wk) and torch.equal(gv, wv),
            f"block_multihead_attention: max err {err}")
    emit("generate", run="block_multihead_attention", batch=b, prompt_len=s,
         decode_steps=n, page_size=PAGE, null_page=False, dtype="bf16",
         max_err=err, tol=tol, seconds=sec, launches=c)
    del gk, gv, wk, wv, got, want

    # fused_block_decode: n steps of one 7B layer at serve's ragged lengths,
    # each its own input (a chain would compound the bf16 rounding of every
    # step's output into the next's input)
    seq_lens = list(FUSED_SHAPES[0][1])
    fbt, fpages = _block_tables(seq_lens, n, device, MAX_SEQ + n)
    sl0 = torch.tensor(seq_lens, dtype=torch.int32, device=device)
    lw = block_weights(gen, dtype, device)
    xs = _rand(gen, (n, BATCH, HIDDEN), dtype, device, 0.3)
    pools0 = [_rand(gen, (KV_HEADS, fpages, PAGE, HEAD_DIM), dtype, device)
              for _ in range(2)]
    kw = dict(num_heads=HEADS, num_kv_heads=KV_HEADS, rope_theta=10000.0,
              epsilon=1e-5)

    def fbd():
        kp, vp = (p.clone() for p in pools0)
        outs = []
        for i in range(n):
            out, kp, vp = FF.fused_block_decode(xs[i], *lw, kp, vp, fbt,
                                                sl0 + i, **kw)
            outs.append(out)
        return outs, kp, vp

    (got, gk, gv), c, sec = counted(fbd, total)
    require_launches(c, only(c, fused_block_decode=n), "fused_block_decode")
    with plain_attention():
        (want, wk, wv), pc, _ = counted(fbd)
    require(not any(pc.values()), f"plain fused_block_decode launched {pc}")
    err = max(max_err(a, r) for a, r in zip(got, want))
    perr = max(max_err(gk, wk), max_err(gv, wv))
    require(max(err, perr) <= tol, f"fused_block_decode: max err {err}, "
            f"pools {perr}")
    emit("generate", run="fused_block_decode", batch=BATCH,
         seq_lens=seq_lens, decode_steps=n, dtype="bf16", max_err=err,
         pool_max_err=perr, tol=tol, seconds=sec, launches=c)
    del gk, gv, wk, wv, pools0, lw
    torch.cuda.empty_cache()


# --------------------------------------------------------------- handoff
HANDOFF_LEN, HANDOFF_NEW = 200, 32


def pool_addresses(eng):
    from paddle_tpu_torch.generation.serving import _pool_ptrs
    return _pool_ptrs(zip(eng.pool.k_pages, eng.pool.v_pages))


def harvest_after_first_token(eng, prompt, new_tokens):
    """Submit ``prompt`` to ``eng``, step until it has its first token, and
    harvest it; returns (bundle, harvest seconds)."""
    rid = eng.submit(prompt, new_tokens)
    while not eng.poll(rid)["tokens"]:
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle = eng.harvest_request(rid)
    return bundle, time.perf_counter() - t0


def run_handoff(model) -> dict:
    """The handoff phase on serve's configuration, native and int8 pools: a
    request harvested after its first token from engine A and adopted by
    engine B, which served the same request alone first: B's stream equal
    to its solo stream bit for bit, no new capture, the pools at their
    addresses, exact launches; the bundle through a spawned process (no
    CUDA tensor rides). Returns the launch counts of the adopted runs."""
    from paddle_tpu_torch.generation.program_cache import \
        decode_program_cache
    from paddle_tpu_torch.generation.serving import ServingEngine
    from paddle_tpu_torch.testing import transport
    layers = model.config.num_hidden_layers
    prompt = prompts(model.config.vocab_size, (HANDOFF_LEN,))[0]
    total: dict = {}
    t_phase = time.perf_counter()
    cache = decode_program_cache()
    for kv_dtype in ("native", "int8"):
        def engine():
            return ServingEngine(model, max_batch=BATCH, page_size=PAGE,
                                 max_seq_len=MAX_SEQ, kv_dtype=kv_dtype)
        b = engine()
        rid = b.submit(prompt, HANDOFF_NEW)
        solo = b.run()[rid]
        # B's graphs, one a rung, captured by its solo run
        graphs = {r: getattr(fn, "graph", None)
                  for r, fn in b._decode_fns.items()}
        ptrs = pool_addresses(b)
        a = engine()
        bundle, harvest_s = harvest_after_first_token(a, prompt,
                                                      HANDOFF_NEW)
        require(a.pool.ledger()["pages_in_use"] == 0,
                "handoff: A kept pages")
        t0 = time.perf_counter()
        report = transport.assert_bundle_transportable(bundle)
        spawn_s = time.perf_counter() - t0
        steps0 = len(b.decode_step_seconds)
        # the program cache counts captures per key, over every engine
        caps = {k: cache.trace_count(k) for k in b._decode_keys.values()}

        def adopt():
            t0 = time.perf_counter()
            new = b.adopt_request(bundle)
            torch.cuda.synchronize()
            adopt_s = time.perf_counter() - t0
            return new, b.run()[new], adopt_s

        (new, out, adopt_s), c, sec = counted(adopt, total)
        steps = len(b.decode_step_seconds) - steps0
        require(out == solo, f"handoff {kv_dtype}: adopted stream differs "
                f"from solo at {first_difference(out, solo)}")
        require({k: cache.trace_count(k)
                 for k in b._decode_keys.values()} == caps,
                f"handoff {kv_dtype}: a new capture")
        require(all(g is not None for g in graphs.values())
                and {r: getattr(fn, "graph", None)
                     for r, fn in b._decode_fns.items()} == graphs,
                f"handoff {kv_dtype}: B's graphs were not kept")
        require(pool_addresses(b) == ptrs, f"handoff {kv_dtype}: the pools "
                "moved")
        suffix = "_int8" if kv_dtype == "int8" else ""
        require_launches(c, only(c, **{"fused_block_decode" + suffix:
                                       layers * steps}),
                         f"handoff {kv_dtype}")
        emit("handoff", model="llama2_7b", layers=layers, dtype="bf16",
             kv_dtype=kv_dtype, prompt_len=HANDOFF_LEN,
             new_tokens=HANDOFF_NEW, pages=len(bundle["pages"]),
             bundle_bytes=report.total_bytes, harvest_ms=1e3 * harvest_s,
             adopt_ms=1e3 * adopt_s, spawn_roundtrip_s=spawn_s,
             decode_steps=steps, seconds=sec, bit_identical=True,
             graphs=len(graphs), launches=c)
        del a, b, bundle
        torch.cuda.empty_cache()
    emit("handoff", run="phase", seconds=time.perf_counter() - t_phase,
         launches=total)
    return total


# -------------------------------------------------------------------- tp
TP = 2
# (FLAGS_fused_block_layers, kv_dtype) of the tensor-parallel serve runs
TP_RUNS = ((1, "native"), (GROUP_LAYERS, "native"), (1, "int8"))
TP_FLEET_SPEC = "router_dispatch:every=20:times=1"


def stream_differences(res_a, res_b, eng_a, eng_b):
    """For each request whose streams differ: its first differing token and
    the top-2 logit margin of both engines' rows there."""
    out = []
    for (ra, _, ta), (rb, _, tb) in zip(res_a, res_b):
        j = first_difference(ta, tb)
        if j is not None:
            out.append(dict(request=ra, first_difference=j,
                            margin_a=top2_margin(eng_a.logits[ra][j]),
                            margin_b=top2_margin(eng_b.logits[rb][j])))
    return out


def tp_fleet(model, spec):
    """FleetRouter(replicas=2, tp_degree=TP) on serve's configuration, one
    warm-up request a replica, then serve's traffic under FLAGS_fault_inject
    ``spec`` (the router's site armed for the traffic only). Returns
    (fleet, streams, seconds, peak device bytes)."""
    from paddle_tpu_torch.generation.fleet import FleetRouter
    from paddle_tpu_torch.testing import faults
    vocab = model.config.vocab_size
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fleet = FleetRouter(model, replicas=2, tp_degree=TP, max_batch=BATCH,
                        page_size=PAGE, max_seq_len=MAX_SEQ)
    for i, p in enumerate(prompts(vocab, (9, 17))):
        fleet.submit(p, 2, replica=i)
    fleet.run()
    t0 = time.perf_counter()
    with faults.armed(spec):
        fleet._f_router = faults.site("router_dispatch")
        rids = [fleet.submit(p, NEW_TOKENS)
                for p in prompts(vocab, PROMPT_LENS)]
        out = fleet.run()
    torch.cuda.synchronize()
    require(all(fleet.status(r) == "OK" for r in rids),
            f"tp fleet {spec!r}: statuses {fleet.statuses()}")
    return (fleet, [out[r] for r in rids], time.perf_counter() - t0,
            torch.cuda.max_memory_allocated())


def run_tp(model) -> dict:
    """The tp phase on serve's Llama-2-7B (full width and depth, bf16):
    ServingEngine(tp_degree=TP) on serve's traffic, fused N = 1, N =
    GROUP_LAYERS and an int8 pool, each beside the tp = 1 engine (streams
    compared; a difference reported with its first token and both top-2
    margins; step ms, TTFT, peak); exact launches (#2 layers x TP a step,
    #1 a layer a prefill, no #3/#5); the graphed TP step against its
    eager step bit for bit; a harvest / adopt between two TP engines on
    an int8 pool, bit for bit; FleetRouter(replicas=2, tp_degree=TP)
    through one replica loss (its agreement with the loss-free fleet
    reported). Returns the launch counts of the TP runs."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.generation.serving import ServingEngine
    cfg = model.config
    layers = cfg.num_hidden_layers
    total: dict = {}
    t_phase = time.perf_counter()
    for group, kv_dtype in TP_RUNS:
        runs = {}
        for tp in (1, TP):
            eng, res, seconds, counts, peak = serve(
                model, True, NEW_TOKENS, PROMPT_LENS, record_logits=True,
                group=group, kv_dtype=kv_dtype, tp_degree=tp)
            check_tokens(res, cfg.vocab_size, NEW_TOKENS)
            steps = len(eng.decode_step_seconds)
            require_launches(counts, expected_launches(
                counts, layers, steps, len(PROMPT_LENS), 0, True, group,
                kv_dtype, "native", tp), f"tp={tp} N={group} {kv_dtype}")
            runs[tp] = (eng, res, seconds, counts, peak)
            if tp > 1:
                total = {k: total.get(k, 0) + v for k, v in counts.items()}
                require(("tp", TP) in eng.decode_key.extra,
                        "tp: the decode key carries no degree")
        (e1, r1, s1, _, p1), (e2, r2, s2, c2, p2) = runs[1], runs[TP]
        diffs = stream_differences(r1, r2, e1, e2)
        gen = sum(len(t) for _, _, t in r2)
        emit("tp", model="llama2_7b", layers=layers, dtype="bf16",
             tp_degree=TP, fused_block_layers=group, kv_dtype=kv_dtype,
             requests=len(r2), prompt_lens=list(PROMPT_LENS),
             new_tokens=NEW_TOKENS, streams_equal=not diffs,
             differences=diffs, decode_steps=len(e2.decode_step_seconds),
             tokens_per_s=gen / s2, tokens_per_s_tp1=gen / s1,
             decode_step_ms_median=1e3 * float(np.median(
                 e2.decode_step_seconds)),
             decode_step_ms_median_tp1=1e3 * float(np.median(
                 e1.decode_step_seconds)),
             ttft_ms_median=1e3 * float(np.median(
                 list(e2.ttft_seconds.values()))),
             ttft_ms_median_tp1=1e3 * float(np.median(
                 list(e1.ttft_seconds.values()))),
             peak_mem_gb=p2 / 1e9, peak_mem_gb_tp1=p1 / 1e9, launches=c2)
        del runs, e1, e2
        torch.cuda.empty_cache()
    step = graph_vs_eager(model, f"tp={TP} fused N=1", True, 1, "native",
                          "native", tp_degree=TP, phase="tp")
    require_launches(step, only(step, paged_attention=layers * TP),
                     "tp graph step")
    # harvest / adopt between two TP engines on an int8 pool
    prompt = prompts(cfg.vocab_size, (HANDOFF_LEN,))[0]

    def engine():
        return ServingEngine(model, max_batch=BATCH, page_size=PAGE,
                             max_seq_len=MAX_SEQ, kv_dtype="int8",
                             tp_degree=TP)
    b = engine()
    rid = b.submit(prompt, HANDOFF_NEW)
    solo = b.run()[rid]
    a = engine()
    bundle, harvest_s = harvest_after_first_token(a, prompt, HANDOFF_NEW)
    steps0 = len(b.decode_step_seconds)
    (new, out), c, sec = counted(
        lambda: (lambda n: (n, b.run()[n]))(b.adopt_request(bundle)), total)
    steps = len(b.decode_step_seconds) - steps0
    require(out == solo, f"tp handoff: adopted stream differs from solo at "
            f"{first_difference(out, solo)}")
    require_launches(c, only(c, paged_attention_int8=layers * TP * steps),
                     "tp handoff")
    emit("tp", part="handoff", kv_dtype="int8", tp_degree=TP,
         prompt_len=HANDOFF_LEN, pages=len(bundle["pages"]),
         harvest_ms=1e3 * harvest_s, decode_steps=steps, seconds=sec,
         bit_identical=True, launches=c)
    del a, b, bundle
    torch.cuda.empty_cache()
    # the fleet: two TP replicas, one loss
    kernels.reset_launches()
    clean, clean_out, clean_s, clean_peak = tp_fleet(model, "")
    total = {k: total.get(k, 0) + v
             for k, v in kernels.launch_counts().items()}
    del clean
    kernels.reset_launches()
    lossy, lossy_out, lossy_s, lossy_peak = tp_fleet(model, TP_FLEET_SPEC)
    total = {k: total.get(k, 0) + v
             for k, v in kernels.launch_counts().items()}
    require(lossy.losses == 1, f"tp fleet: {lossy.losses} losses, want 1")
    require(all(len(t) == NEW_TOKENS for t in lossy_out),
            "tp fleet: a stream is short")
    require(all(e.tp_degree == TP for e in lossy.engines),
            "tp fleet: a replica is not tensor-parallel")
    # bf16: a re-routed request re-prefills prompt + tokens, whose rounding
    # is not the decode steps' (tp_parity holds the fp32 fleet to equality)
    emit("tp", part="fleet", replicas=2, tp_degree=TP, spec=TP_FLEET_SPEC,
         losses=lossy.losses, rerouted=lossy.rerouted,
         streams_equal_loss_free=lossy_out == clean_out,
         first_differences=[first_difference(a, b) for a, b in
                            zip(lossy_out, clean_out)], seconds=lossy_s,
         seconds_loss_free=clean_s, peak_mem_gb=lossy_peak / 1e9,
         peak_mem_gb_loss_free=clean_peak / 1e9)
    del lossy
    torch.cuda.empty_cache()
    emit("tp", run="phase", seconds=time.perf_counter() - t_phase,
         launches=total)
    return total


def run_tp_parity(model):
    """tp_parity: the parity phase's 2-layer fp32 model through
    ServingEngine(tp_degree=TP) on the card and on a CPU copy (the plain
    versions), and at tp = 1 on the card: three streams equal token for
    token; a TP fleet through one replica loss equal to them."""
    from paddle_tpu_torch.generation.serving import ServingEngine
    lens = PARITY_LENS[:3]
    ps = prompts(model.config.vocab_size, lens)
    cpu = copy.deepcopy(model).to("cpu")

    def streams(m, tp):
        eng = ServingEngine(m, max_batch=BATCH, page_size=PAGE,
                            max_seq_len=MAX_SEQ, tp_degree=tp,
                            record_logits=True)
        rids = [eng.submit(p, PARITY_NEW_TOKENS) for p in ps]
        out = eng.run()
        return eng, [(r, p, out[r]) for r, p in zip(rids, ps)]

    card, rc = streams(model, TP)
    host, rh = streams(cpu, TP)
    one, r1 = streams(model, 1)
    for what, (eng, res) in (("cpu", (host, rh)), ("tp=1", (one, r1))):
        diffs = stream_differences(rc, res, card, eng)
        require(not diffs, f"tp_parity: the card at tp={TP} vs {what}: "
                f"{diffs}")
    # a TP fleet through one replica loss: the engine's streams
    from paddle_tpu_torch.generation.fleet import FleetRouter
    from paddle_tpu_torch.testing import faults
    fleet = FleetRouter(model, replicas=2, tp_degree=TP, max_batch=BATCH,
                        page_size=PAGE, max_seq_len=MAX_SEQ)
    with faults.armed("router_dispatch:every=6:times=1"):
        fleet._f_router = faults.site("router_dispatch")
        rids = [fleet.submit(p, PARITY_NEW_TOKENS) for p in ps]
        out = fleet.run()
    require(fleet.losses == 1, f"tp_parity: {fleet.losses} fleet losses")
    require([out[r] for r in rids] == [t for _, _, t in rc],
            "tp_parity: the TP fleet through a loss differs from the "
            "engine")
    emit("tp_parity", model="llama2_7b width, 2 layers", dtype="fp32",
         tp_degree=TP, prompt_lens=list(lens),
         new_tokens=PARITY_NEW_TOKENS, streams_equal_cpu=True,
         streams_equal_tp1=True, fleet_losses=fleet.losses,
         fleet_streams_equal=True)
    del cpu, card, host, one, fleet


def run_generate_parity(model):
    """generate, generate_paged, generate_speculative (a 1-layer
    TinyLlama-shaped draft) and sampled top-k = 1 on the fp32 parity model,
    token for token equal to a no-cache argmax loop; the beam's rescored
    log-probability no lower than greedy's (BEAM_PARITY_TOL)."""
    device = model.device
    vocab = model.config.vocab_size
    n = GEN_PARITY_NEW
    ids = torch.from_numpy(np.stack(prompts(
        vocab, (GEN_PARITY_PROMPT,) * GEN_PARITY_BATCH))).to(device)
    loop = ids.long()
    with torch.inference_mode():
        for _ in range(n):
            loop = torch.cat([loop, model(loop)[:, -1].argmax(-1)[:, None]],
                             dim=1)
    loop = loop.to(ids.dtype)
    greedy = model.generate(ids, max_new_tokens=n)
    paged = model.generate_paged(ids, max_new_tokens=n, page_size=PAGE)
    g = torch.Generator(device=device).manual_seed(GEN_SAMPLE_SEED)
    top1 = model.generate(ids, max_new_tokens=n, do_sample=True, top_k=1,
                          temperature=0.8, generator=g)
    draft = draft_model(device, torch.float32, layers=1)
    spec = model.generate_speculative(ids[:1], draft, max_new_tokens=n,
                                      num_speculative_tokens=GEN_GAMMA)
    st = dict(model.speculative_stats)
    del draft
    for name, got in (("generate", greedy), ("generate_paged", paged),
                      ("sampled top_k=1", top1),
                      ("generate_speculative", spec)):
        require(torch.equal(got, loop[:got.shape[0]]),
                f"generate parity: {name} differs from the argmax loop at "
                f"{first_difference(got[0].tolist(), loop[0].tolist())}")
    beam = model.generate(ids[:1], max_new_tokens=n, num_beams=BEAMS)
    lp_beam = float(seq_logprob(model, beam, GEN_PARITY_PROMPT)[0])
    lp_greedy = float(seq_logprob(model, greedy[:1], GEN_PARITY_PROMPT)[0])
    require(lp_beam >= lp_greedy - BEAM_PARITY_TOL,
            f"generate parity: beam {lp_beam} below greedy {lp_greedy}")
    emit("parity", run="generate", model="llama2_7b width, 2 layers",
         dtype="fp32", batch=GEN_PARITY_BATCH, prompt_len=GEN_PARITY_PROMPT,
         new_tokens=n, equal_to_argmax_loop=["generate", "generate_paged",
                                             "sampled top_k=1",
                                             "generate_speculative"],
         spec_rounds=st["rounds"],
         spec_acceptance=st["accepted"] / st["proposed"],
         beam_logprob_per_token=lp_beam,
         greedy_logprob_per_token=lp_greedy, beam_tol=BEAM_PARITY_TOL)


def run_handoff_parity(model, seed_value):
    """A request of the fp32 parity model harvested after its first token
    and decoded to the end in a spawned process on the card, which rebuilds
    the model from its seed: the stream equal to the solo one."""
    import dataclasses
    from paddle_tpu_torch.generation.serving import ServingEngine
    from paddle_tpu_torch.testing import transport
    kw = dict(max_batch=BATCH, page_size=PAGE, max_seq_len=MAX_SEQ)
    prompt = prompts(model.config.vocab_size, (HANDOFF_LEN,))[0]
    eng = ServingEngine(model, **kw)
    rid = eng.submit(prompt, HANDOFF_NEW)
    solo = eng.run()[rid]
    bundle, _ = harvest_after_first_token(ServingEngine(model, **kw),
                                          prompt, HANDOFF_NEW)
    t0 = time.perf_counter()
    got = transport.adopt_and_decode_in_child(
        bundle, model_seed=seed_value, engine_kw=kw, device="cuda",
        config=dataclasses.asdict(model.config), dtype="float32")
    child_s = time.perf_counter() - t0
    require(got == solo, f"handoff parity: the child's stream differs at "
            f"{first_difference(got, solo)}")
    emit("parity", run="handoff", model="llama2_7b width, 2 layers",
         dtype="fp32", prompt_len=HANDOFF_LEN, new_tokens=HANDOFF_NEW,
         child_equal_to_solo=True, child_seconds=child_s)


# ------------------------------------------------------------------- gpt
# GPT-3 345M (GPTConfig.gpt3_345m: vocab 50304, hidden 1024, 24 layers, 16
# MHA heads of 64, inter 4096, 1024 positions, the head tied to wte)
GPT_HEADS, GPT_HEAD_DIM = 16, 64
# the kernels phase's rows at its heads: #2 over serve's ragged lengths
# (one idle row) of a 1024-token table, #4 a 256-token chunk from 512
GPT_PAGED_LENS = (MAX_SEQ - 1, MAX_SEQ // 2 + 5, MAX_SEQ // 13, 0)
GPT_CHUNK_START, GPT_CHUNK_S = 512, 256
# the gpt phase: 8 prompts (three chunked), half submitted mid-run
GPT_LENS = (17, 900, 64, 300, 200, 33, 700, 128)
GPT_GEN_BATCH, GPT_GEN_PROMPT, GPT_GEN_NEW = 4, 128, 32
GPT_GAMMA = 2
GPT_PARITY_LENS = (17, 77, 300, 700)


def check_gpt_kernels(dtype, device, results):
    """#1, #2 and #4 at GPT-3 345M's heads (16 MHA heads of dim 64, a
    head layout no serving phase on Llama runs), each held to its plain
    version and timed against SDPA (with the mask it masks) and the bound:
    #1 as a 256-token prefill (prefill_row), #2 at B = 4 over lens
    1023/517/78/0 of a 1024-token table (device_ms replayed from a CUDA
    graph), #4 as a 256-token chunk from 512 (chunk_rows: spread and
    peaked, native and on the pool quantized)."""
    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.kernels import paged_attention as pa
    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    h, d = GPT_HEADS, GPT_HEAD_DIM
    results.append(prefill_row(da, gen, dtype, device, "gpt prefill", 1,
                               256, 256, 256, h, h, d, mark="gpt"))
    seq_lens = list(GPT_PAGED_LENS)
    bt, num_pages = _block_tables(seq_lens, 0, device)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=device)
    kp, vp = (_rand(gen, (h, num_pages, PAGE, d), dtype, device)
              for _ in range(2))
    q = _rand(gen, (BATCH, h, d), dtype, device)
    got = pa.paged_attention(q, kp, vp, bt, sl)
    want = pa.paged_attention_ref(q, kp, vp, bt, sl)
    torch.cuda.synchronize()
    err = max_err(got, want)
    require(err <= TOL[dtype], f"paged_attention gpt {dtype}: {err}")
    require(not got[sl == 0].any(), "paged_attention gpt: idle row must "
            "read zeros")
    t = bt.shape[1] * PAGE
    kg, vg = (x[:, bt.long()].movedim(1, 0).reshape(BATCH, h, t, d)
              for x in (kp, vp))
    mask = (torch.arange(t, device=device)[None, :]
            < sl[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    live = sum(seq_lens)
    nbytes = (q.element_size() * (2 * q.numel() + 2 * live * h * d)
              + 4 * (bt.numel() + sl.numel()))
    bms, by = bound_ms(nbytes, 4.0 * live * h * d, dtype)

    def call():
        pa.paged_attention(q, kp, vp, bt, sl)

    def lib():
        sdpa(qs, kg, vg, attn_mask=mask)

    kms = time_ms(call)
    results.append(dict(
        kernel="paged_attention", dtype=DTYPE_NAME[dtype], gpt="decode",
        seq_lens=seq_lens, heads=h, kv_heads=h, head_dim=d, max_err=err,
        tol=TOL[dtype], kernel_ms=kms,
        plain_ms=time_ms(lambda: pa.paged_attention_ref(q, kp, vp, bt, sl)),
        library_ms=time_ms(lib), bound_ms=bms, bound_by=by,
        bound_frac=bms / kms,
        device_ms=dict(kernel=graph_ms(call), library=graph_ms(lib))))
    del kp, vp, kg, vg
    results.extend(chunk_rows(pa, gen, dtype, device, "gpt chunk",
                              GPT_CHUNK_S, GPT_CHUNK_START, h, h, d,
                              mark="gpt"))
    torch.cuda.empty_cache()


def graphs_of(eng):
    """The engine's decode graphs (one a rung used) and chunk graph."""
    out = list(eng._decode_fns.values())
    return out + ([eng._chunk_fn] if eng._chunk_fn is not None else [])


def gpt_model(device, dtype, layers=None, seed_offset=16):
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig.gpt3_345m()
    if layers is not None:
        cfg.num_hidden_layers = layers
    return GPTForCausalLM(cfg, device=device, dtype=dtype,
                          generator=seed(SEED + seed_offset, device))


def run_gpt(device):
    """GPT-3 345M, bf16, seeded, through ServingEngine (the generic route:
    #1 whole prefills, #4 chunks, #2 decode, no fused kernel), through
    generate, and as its own draft. Returns the launch counts."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.generation.program_cache import \
        decode_program_cache
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = gpt_model(device, torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = model.config
    layers = cfg.num_hidden_layers
    chunks = sum(-(-n // CHUNK) for n in GPT_LENS if n > CHUNK)
    whole = sum(1 for n in GPT_LENS if n <= CHUNK)
    cache = decode_program_cache()
    eng, res, seconds, counts, peak = serve(
        model, True, NEW_TOKENS, GPT_LENS, want_fused=False)
    check_tokens(res, cfg.vocab_size, NEW_TOKENS)
    steps = len(eng.decode_step_seconds)
    require_launches(counts, expected_launches(
        counts, layers, steps, whole, chunks, False, 1, "native", "native"),
        "gpt serve")
    require(eng.chunk_dispatches == chunks,
            f"gpt: {eng.chunk_dispatches} chunks, want {chunks}")
    require(all(eng.status(r) == "OK" for r, _, _ in res),
            "gpt: a request did not end OK")
    graphs = graphs_of(eng)
    require(eng._decode_fns and eng._chunk_fn is not None
            and all(g.graph is not None for g in graphs),
            "gpt: a rung or the chunk program was not captured")
    caps = captures(cache, eng)
    require(all(n == 1 for n in caps.values()),
            f"gpt: captures by key {sorted(caps.values())}")
    gen_tokens = sum(len(t) for _, _, t in res)
    total = dict(counts)
    emit("gpt", model="gpt3_345m", layers=layers, dtype="bf16",
         run="serve", route="generic", requests=len(res),
         prompt_lens=list(GPT_LENS), new_tokens=NEW_TOKENS,
         prefill_chunk=CHUNK, generated=gen_tokens, seconds=seconds,
         tokens_per_s=gen_tokens / seconds, chunks=eng.chunk_dispatches,
         chunk_ms_median=1e3 * float(np.median(eng.chunk_seconds)),
         prefill_ms_median=1e3 * float(np.median(eng.prefill_seconds)),
         ttft_ms_median=1e3 * float(np.median(
             list(eng.ttft_seconds.values()))),
         decode_steps=steps, decode_step_ms_median=1e3 * float(
             np.median(eng.decode_step_seconds)),
         graphs=len(graphs), captures_by_key=sorted(caps.values()),
         launches=counts, model_build_s=build_s, peak_mem_gb=peak / 1e9)
    del eng
    # the generic route at tp = TP: prefill, chunks and decode as at
    # tp = 1 on the same pools, so the same streams bit for bit
    eng, res_tp, seconds_tp, counts, peak_tp = serve(
        model, True, NEW_TOKENS, GPT_LENS, want_fused=False, tp_degree=TP)
    require([t for _, _, t in res_tp] == [t for _, _, t in res],
            "gpt tp: the streams differ from tp = 1")
    require(("tp", TP) in eng.decode_key.extra,
            "gpt tp: the decode key carries no degree")
    require_launches(counts, expected_launches(
        counts, layers, len(eng.decode_step_seconds), whole, chunks, False,
        1, "native", "native"), "gpt tp serve")
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    emit("tp", model="gpt3_345m", layers=layers, dtype="bf16",
         route="generic", tp_degree=TP, requests=len(res_tp),
         streams_equal=True, seconds=seconds_tp,
         tokens_per_s=gen_tokens / seconds_tp,
         decode_step_ms_median=1e3 * float(
             np.median(eng.decode_step_seconds)),
         ttft_ms_median=1e3 * float(np.median(
             list(eng.ttft_seconds.values()))),
         peak_mem_gb=peak_tp / 1e9, launches=counts)
    del eng
    # generate (#1 a layer at the prefill; the one-token steps are the
    # dense composition)
    ids = torch.from_numpy(np.stack(prompts(
        cfg.vocab_size, (GPT_GEN_PROMPT,) * GPT_GEN_BATCH))).to(device)
    model.generate(ids, max_new_tokens=2)                    # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=GPT_GEN_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    require(out.shape == (GPT_GEN_BATCH, GPT_GEN_PROMPT + GPT_GEN_NEW),
            f"gpt generate: shape {tuple(out.shape)}")
    require(int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
            "gpt generate: token out of the vocabulary")
    require_launches(counts, dict(dict.fromkeys(counts, 0),
                                  flash_prefill=layers), "gpt generate")
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    emit("gpt", run="generate", batch=GPT_GEN_BATCH,
         prompt_len=GPT_GEN_PROMPT, new_tokens=GPT_GEN_NEW, seconds=gen_s,
         ms_per_step=1e3 * gen_s / GPT_GEN_NEW,
         tokens_per_s=GPT_GEN_BATCH * GPT_GEN_NEW / gen_s, launches=counts)
    # the model as its own draft, γ = 2, batch 1 (generic draft scan, #2)
    eng = spec_engine(model, model, fused=True, extra_flags=dict(
        serving_spec_rungs=str(GPT_GAMMA), serving_spec_gamma=GPT_GAMMA,
        serving_spec_adaptive=False))
    require(eng._draft_fspec is None and eng._spec is None,
            "gpt spec: a fused route was taken")
    spec_warm(eng, cfg.vocab_size)
    streams, statuses, seconds, counts, _ = spec_traffic(
        eng, cfg.vocab_size, SPEC_LENS, SPEC_NEW)
    require(all(s == "OK" for s in statuses), f"gpt spec: {statuses}")
    require(all(len(t) == SPEC_NEW for t in streams), "gpt spec: lengths")
    require_launches(counts, spec_launches(counts, eng, layers, layers,
                                           fused=False), "gpt spec")
    rounds = eng.round_log
    require(rounds and all(r[0] == GPT_GAMMA for r in rounds),
            f"gpt spec: gammas {sorted({r[0] for r in rounds})}")
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    emit("gpt", run="spec, self-draft", gamma=GPT_GAMMA, batch=1,
         prompt_lens=list(SPEC_LENS), new_tokens=SPEC_NEW,
         rounds=len(rounds),
         acceptance=eng.spec_tokens_accepted / max(1, sum(
             r[0] for r in rounds)),
         tokens_per_round=float(np.mean([r[2] for r in rounds])),
         round_ms_median=1e3 * float(np.median([r[3] for r in rounds])),
         seconds=seconds, tokens_per_s=sum(map(len, streams)) / seconds,
         launches=counts, peak_mem_gb=torch.cuda.max_memory_allocated()
         / 1e9)
    del eng, model
    torch.cuda.empty_cache()
    return total


def argmax_loop(model, prompt, n):
    """``n`` greedy tokens after ``prompt`` by the no-cache forward."""
    ids = torch.from_numpy(prompt.astype(np.int64))[None].to(model.device)
    with torch.inference_mode():
        for _ in range(n):
            nxt = model(ids)[:, -1].float().argmax(-1)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
    return ids[0, len(prompt):].tolist()


def run_gpt_parity(device):
    """fp32, 2 layers at GPT-3 345M's width: the engine's streams (two
    prompts chunked) equal to a no-cache argmax loop; a speculative engine
    with a 1-layer GPT draft equal to the plain engine, token for token."""
    model = gpt_model(device, torch.float32, layers=2, seed_offset=17)
    vocab = model.config.vocab_size
    eng, res, _, counts, _ = serve(model, True, PARITY_NEW_TOKENS,
                                   GPT_PARITY_LENS, want_fused=False)
    for rid, prompt, toks in res:
        ref = argmax_loop(model, prompt, PARITY_NEW_TOKENS)
        require(toks == ref, f"gpt parity: request {rid} differs from the "
                f"argmax loop at {first_difference(toks, ref)}")
    chunks = eng.chunk_dispatches
    del eng
    draft = gpt_model(device, torch.float32, layers=1, seed_offset=18)
    plain = spec_engine(model, None)
    p_streams = spec_traffic(plain, vocab, SPEC_LENS, PARITY_NEW_TOKENS)[0]
    eng = spec_engine(model, draft)
    streams, statuses, _, _, _ = spec_traffic(eng, vocab, SPEC_LENS,
                                              PARITY_NEW_TOKENS)
    require(all(s == "OK" for s in statuses), f"gpt parity spec: "
            f"{statuses}")
    require(streams == p_streams, "gpt parity: the GPT-drafted streams "
            "differ from the plain engine's")
    emit("parity", run="gpt", model="gpt3_345m width, 2 layers",
         dtype="fp32", prompt_lens=list(GPT_PARITY_LENS),
         new_tokens=PARITY_NEW_TOKENS, chunks=chunks,
         engine_equal_to_argmax_loop=True, spec_draft="gpt, 1 layer",
         spec_rounds=eng.spec_rounds,
         spec_acceptance=eng.spec_tokens_accepted / max(
             1, eng.spec_tokens_accepted + eng.spec_tokens_rejected),
         spec_equal_to_plain=True, launches=counts)
    del eng, plain, draft, model
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- quant
# serve's traffic with one prompt over a chunk, so that chunks run too
QUANT_LENS = PROMPT_LENS[:-1] + (300,)
QUANT_ALGOS = ("weight_only_int8", "weight_only_int4")
QUANT_GEN_PROMPTS = 2     # the engine's streams against generate (B = 1)
QUANT_ROUND_RTOL = 1e-5   # on half a scale step: f32 roundings of w / s


def quantized_copy(model, algo):
    """A copy of ``model`` with every Linear weight-only quantized."""
    from paddle_tpu_torch.nn.quant import quantize_linears
    qmodel = quantize_linears(copy.deepcopy(model), algo)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return qmodel


def quant_roundtrip(model, algo) -> float:
    """weight_quantize then weight_dequantize of layer 0's matrices and the
    LM head: the largest distance to the bf16 weight in scale steps (at
    most one half)."""
    from paddle_tpu_torch.incubate.nn.functional import weight_quantize
    from paddle_tpu_torch.nn.quant import weight_dequantize
    worst = 0.0
    for name, w in model.named_parameters():
        if w.dim() != 2 or not (name.startswith("llama.layers.0.")
                                or name == "lm_head.weight"):
            continue
        w = w.detach()
        qw, sc = weight_quantize(w, algo)
        deq = weight_dequantize(qw, sc, algo)
        worst = max(worst, float(((deq - w.float()).abs()
                                  / sc[None, :]).max()))
        del qw, sc, deq
    require(worst <= 0.5 * (1 + QUANT_ROUND_RTOL),
            f"quant {algo}: dequantized weight {worst} scale steps off")
    return worst


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def run_quant(model, bf16_generic_step_ms):
    """Serve's Llama-2-7B through quantize_linears (int8, then int4)
    served by ServingEngine with the fused flag on: the generic route is
    taken (no #3/#5 launch; #1, #4 and #2 exact), every request OK; the
    weight round trip, the weight bytes, the graphed decode step against
    the bf16 generic step, and the streams against the same quantized
    model's generate (first difference, the engine's top-2 margin there).
    Returns the launch counts."""
    cfg = model.config
    layers = cfg.num_hidden_layers
    chunks = sum(-(-n // CHUNK) for n in QUANT_LENS if n > CHUNK)
    whole = sum(1 for n in QUANT_LENS if n <= CHUNK)
    bf16_bytes = tensor_bytes(model.parameters())
    total = {}
    for algo in QUANT_ALGOS:
        steps_off = quant_roundtrip(model, algo)
        t0 = time.perf_counter()
        qmodel = quantized_copy(model, algo)
        quant_s = time.perf_counter() - t0
        qbytes = tensor_bytes(list(qmodel.parameters())
                              + list(qmodel.buffers()))
        eng, res, seconds, counts, peak = serve(
            qmodel, True, NEW_TOKENS, QUANT_LENS, record_logits=True,
            want_fused=False)
        check_tokens(res, cfg.vocab_size, NEW_TOKENS)
        steps = len(eng.decode_step_seconds)
        require_launches(counts, expected_launches(
            counts, layers, steps, whole, chunks, False, 1, "native",
            "native"), f"quant {algo}")
        require(eng.chunk_dispatches == chunks,
                f"quant {algo}: {eng.chunk_dispatches} chunks")
        require(all(g.graph is not None for g in graphs_of(eng)),
                f"quant {algo}: a program was not captured")
        agree, gen_s = [], 0.0
        for rid, prompt, toks in res[:QUANT_GEN_PROMPTS]:
            ids = torch.from_numpy(prompt.astype(np.int64))[None].to(
                model.device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = qmodel.generate(ids, max_new_tokens=NEW_TOKENS,
                                  return_full_sequence=False)[0].tolist()
            torch.cuda.synchronize()
            gen_s += time.perf_counter() - t0
            j = first_difference(toks, got)
            agree.append(dict(
                prompt_len=len(prompt), first_difference=j,
                top2_margin=(None if j is None else
                             top2_margin(eng.logits[rid][j]))))
        gen = sum(len(t) for _, _, t in res)
        emit("quant", model="llama2_7b", algo=algo, layers=layers,
             dtype="bf16", route="generic", requests=len(res),
             prompt_lens=list(QUANT_LENS), new_tokens=NEW_TOKENS,
             roundtrip_scale_steps=steps_off, quantize_s=quant_s,
             weight_bytes=qbytes, bf16_weight_bytes=bf16_bytes,
             weight_ratio=qbytes / bf16_bytes, generated=gen,
             seconds=seconds, tokens_per_s=gen / seconds,
             chunks=eng.chunk_dispatches,
             chunk_ms_median=1e3 * float(np.median(eng.chunk_seconds)),
             prefill_ms_median=1e3 * float(np.median(eng.prefill_seconds)),
             decode_steps=steps, decode_step_ms_median=1e3 * float(
                 np.median(eng.decode_step_seconds)),
             bf16_generic_step_ms_median=bf16_generic_step_ms,
             generate_ms_per_token=1e3 * gen_s / (
                 QUANT_GEN_PROMPTS * NEW_TOKENS),
             engine_vs_generate=agree, launches=counts,
             peak_mem_gb=peak / 1e9)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        del eng, qmodel
        torch.cuda.empty_cache()
    return total


# (fused decode, kv_dtype) of the memwatch phase's engines
MEMWATCH_RUNS = ((True, "native"), (True, "int8"), (False, "native"),
                 (False, "int8"))


def memwatch_planner(dims) -> list:
    """plan_fused_layers' scratch price against the kernel's own size query
    (ptt_fused_multi_block_decode_scratch) at serve's and serve_long's
    shapes, native and int4, for a group of GROUP_LAYERS layers; the plans
    must fit the card's shared memory a block and its memory."""
    import ctypes
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels.fused_block_decode import _SCRATCH_ARGTYPES
    from paddle_tpu_torch.kernels.paged_attention import decode_split_plan
    from paddle_tpu_torch.observability import memory as mem
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    size = _build.bind("fused_multi_block_decode",
                       "ptt_fused_multi_block_decode_scratch",
                       _SCRATCH_ARGTYPES, ctypes.c_longlong)
    rows = []
    for max_seq in (MAX_SEQ, LONG_MAX_SEQ):
        for int4 in (False, True):
            plan = mem.plan_fused_layers(
                dims, fused_layers=GROUP_LAYERS, batch=BATCH, page_size=PAGE,
                io_dtype_bytes=2, max_seq_len=max_seq, int4_weights=int4,
                sm_count=sms, vmem_limit=props.shared_memory_per_block,
                hbm_bytes=props.total_memory)
            _, nsplit = decode_split_plan(BATCH, dims.heads, dims.kv_heads,
                                          -(-max_seq // PAGE), PAGE, sms)
            floats = size(_build.dtype_code(torch.bfloat16), int(int4),
                          BATCH, dims.hidden, dims.heads, dims.kv_heads,
                          dims.head_dim, dims.intermediate, nsplit)
            require(plan["breakdown"]["scratch"] == 4 * floats,
                    f"memwatch: plan_fused_layers prices "
                    f"{plan['breakdown']['scratch']} scratch bytes, the "
                    f"kernel asks {4 * floats} (max_seq {max_seq}, int4 "
                    f"{int4})")
            require(plan["fits"], f"memwatch: the N-layer decode does not "
                    f"fit the card: {plan}")
            rows.append(dict(max_seq_len=max_seq, int4=int4,
                             nsplit=plan["nsplit"],
                             scratch_bytes=plan["breakdown"]["scratch"],
                             kernel_scratch_floats=int(floats),
                             shared_per_block=plan["shared_per_block"],
                             shared_limit=plan["vmem_limit"]))
    return rows


def run_memwatch(model) -> dict:
    """memwatch on serve's Llama-2-7B engine: serve's traffic through the
    fused (N = 1) and generic routes, each on a native and an int8 pool,
    with telemetry and memwatch on. The program table has a row for each
    captured decode rung and chunk program, each graphed row's temp (the
    graph's private pool) > 0; estimate_engine_memory's weight and KV-pool
    terms equal the engine's weight and pool tensors' bytes exactly; its
    total beside the run's allocator peak, and each row's estimated temp
    beside the captured one (reported, not gated); the planner's scratch
    against the kernel's; then the fused native run again with memwatch
    off: streams token for token and launches equal, no new row, the
    graphed step ms of both. Returns the summed launch counts."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.generation.program_cache import (
        clear_decode_program_cache, model_signature)
    from paddle_tpu_torch.observability import memory as mem
    cfg = model.config
    dims = mem.ModelDims.of_config(cfg)
    sig = model_signature(model)[:8]
    require(mem.enabled(), "memwatch: FLAGS_telemetry and FLAGS_memwatch "
            "must be on")
    mem.clear_program_table()
    clear_decode_program_cache()          # binds memwatch under the flags
    weights = mem.tensor_bytes(model)
    runs, total, geoms = [], {}, {}
    for fused, kv in MEMWATCH_RUNS:
        eng, res, seconds, counts, peak = serve(model, fused, NEW_TOKENS,
                                                PROMPT_LENS, kv_dtype=kv)
        check_tokens(res, cfg.vocab_size, NEW_TOKENS)
        est = mem.estimate_engine_memory(
            dims, page_size=PAGE, max_batch=BATCH, max_seq_len=MAX_SEQ,
            chunk=CHUNK, weight_dtype="bfloat16",
            kv_dtype="int8" if kv == "int8" else "bfloat16")
        pool = mem.tensor_bytes(eng.pool.k_pages, eng.pool.v_pages)
        require(est["breakdown"]["weights"] == weights,
                f"memwatch: estimated weights {est['breakdown']['weights']}"
                f" != the model's {weights} bytes")
        require(est["breakdown"]["kv_pool"] == pool,
                f"memwatch {kv}: estimated pool {est['breakdown']['kv_pool']}"
                f" != the engine's {pool} bytes")
        geoms[kv] = mem.PoolGeometry.of_pool(eng.pool)
        runs.append(dict(
            decode="fused" if fused else "generic", kv_dtype=kv,
            estimate_total_gb=est["total"] / 1e9, peak_gb=peak / 1e9,
            estimate_minus_peak_gb=(est["total"] - peak) / 1e9,
            weights_bytes=weights, kv_pool_bytes=pool,
            decode_step_ms_median=1e3 * float(np.median(
                eng.decode_step_seconds))))
        if (fused, kv) == (True, "native"):
            on_streams = [t for _, _, t in res]
            on_counts = counts
            on_step_ms = runs[-1]["decode_step_ms_median"]
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        del eng
        torch.cuda.empty_cache()
    table = [r for r in mem.program_table() if r["model"] == sig]
    want = {("decode_fused", BATCH), ("decode_generic", BATCH),
            ("prefill_chunk", 1)}
    require({(r["kind"], r["bucket"]) for r in table} == want
            and len(table) == 6, f"memwatch: rows {table}")
    rows = []
    for r in table:
        require(r["temp"] > 0, f"memwatch: graphed row without temp: {r}")
        geom = geoms["int8" if "'int8'" in r["extra"] else "native"]
        if r["kind"] == "prefill_chunk":
            est = mem.estimate_prefill_program(dims, geom, CHUNK, weights,
                                               chunked=True)
        else:
            est = mem.estimate_decode_program(dims, geom, r["bucket"],
                                              weights)
        rows.append(dict(r, estimated_temp=est["temp"],
                         estimated_over_captured_temp=est["temp"]
                         / r["temp"]))
    print(mem.format_program_table(table), flush=True)
    planner = memwatch_planner(dims)

    # the fused native run with memwatch off
    flags.set_flags({"memwatch": False})
    clear_decode_program_cache()
    eng, res, seconds, counts, peak = serve(model, True, NEW_TOKENS,
                                            PROMPT_LENS)
    off_step_ms = 1e3 * float(np.median(eng.decode_step_seconds))
    del eng
    torch.cuda.empty_cache()
    clear_decode_program_cache()          # later phases: memwatch on again
    require(mem.enabled(), "memwatch: the flag stayed off")
    require([t for _, _, t in res] == on_streams,
            "memwatch: streams differ with memwatch off")
    require(counts == on_counts, f"memwatch: launches differ with memwatch "
            f"off: {counts} vs {on_counts}")
    require([r for r in mem.program_table() if r["model"] == sig] == table,
            "memwatch: a run with memwatch off recorded a row")
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    suite = memwatch_suite()
    emit("memwatch", model="llama2_7b", dtype="bf16", rows=rows, runs=runs,
         planner=planner, memwatch_on_step_ms=on_step_ms,
         memwatch_off_step_ms=off_step_ms, streams_equal=True,
         launches_equal=True, launches=total, suite=suite)
    return total


def memwatch_suite() -> dict:
    """tools/torch_memwatch.py's capture suite on the card, banked and then
    checked against itself (the CLI's bank / check): a row for each of its
    8 programs, every one with temp > 0 (a graph's private pool, a train
    step's rise of the peak), and no program growing past the gate's 10 %
    on the second capture."""
    from paddle_tpu_torch.observability import memory as mem
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import torch_memwatch
    t0 = time.perf_counter()
    banked = torch_memwatch.capture_suite()
    again = torch_memwatch.capture_suite()
    seconds = time.perf_counter() - t0
    kinds = sorted((r["kind"], r["bucket"]) for r in banked["rows"])
    require(kinds == sorted([("decode_fused", 2)] * 2
                            + [("decode_fused_nlayer", 2)] * 2
                            + [("prefill_chunk", 1), ("decode_generic", 2)]
                            + [("train_step", 2)] * 2),
            f"memwatch suite: rows {kinds}")
    require(all(r["temp"] > 0 for r in banked["rows"]),
            f"memwatch suite: a row without temp: {banked['rows']}")
    gate = torch_memwatch.check_rows(banked["rows"], again["rows"], 0.10,
                                     "the first capture")
    require(gate == 0, "memwatch suite: the check against its own bank "
            "failed")
    print(mem.format_program_table(banked["rows"]), flush=True)
    return dict(rows=len(banked["rows"]), seconds_two_captures=seconds,
                temp_bytes={f"{r['kind']}/{r['model']}/{r['extra']}":
                            r["temp"] for r in banked["rows"]},
                estimates=[dict(kind=e["kind"], extra=e["extra"],
                                rel_err=e["rel_err"])
                           for e in banked["estimates"]])


def run_quant_parity(model):
    """The fp32 parity Llama quantized (int8): the engine's streams equal
    to its generate's, token for token (four prompts, one batch)."""
    qmodel = quantized_copy(model, "weight_only_int8")
    vocab = model.config.vocab_size
    ps = prompts(vocab, (GEN_PARITY_PROMPT,) * GEN_PARITY_BATCH)
    eng, res, _, counts, _ = serve(qmodel, True, PARITY_NEW_TOKENS,
                                   (GEN_PARITY_PROMPT,) * GEN_PARITY_BATCH,
                                   want_fused=False)
    ids = torch.from_numpy(np.stack(ps).astype(np.int64)).to(model.device)
    want = qmodel.generate(ids, max_new_tokens=PARITY_NEW_TOKENS,
                           return_full_sequence=False).tolist()
    got = [toks for _, _, toks in res]
    require(got == want, "quant parity: the engine's streams differ from "
            "generate's")
    emit("parity", run="quant", model="llama2_7b width, 2 layers",
         algo="weight_only_int8", dtype="fp32", batch=GEN_PARITY_BATCH,
         prompt_len=GEN_PARITY_PROMPT, new_tokens=PARITY_NEW_TOKENS,
         engine_equal_to_generate=True, launches=counts)
    del eng, qmodel
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- fleet
# two replicas of serve's engine (fused, N = 1) with a 16-page host tier
# each; two 512-token shared prefixes under 5 requests each (suffixes 17 to
# 256; the first in wave 1, the rest in wave 2, once wave 1 is done) and
# two cold prompts in wave 1
FLEET_REPLICAS, FLEET_HOST_PAGES = 2, 16
FLEET_PREFIX, FLEET_SUFFIXES, FLEET_COLD = 512, (17, 256, 100, 40, 200), \
    (77, 300)
FLEET_SPEC = "router_dispatch:every=25:times=3"
FLEET_MIN_LOSSES = 2


def fleet_router(model, policy="prefix_affinity", rows=None):
    """A FleetRouter whose engines record their shared admissions' pages,
    the requests they export, their build and first-step seconds (a
    rebuilt replica's first step captures its graphs) and, into ``rows``
    by prompt, each token's logits row; ``made`` keeps every engine it
    built, lost ones included."""
    from paddle_tpu_torch.generation.fleet import FleetRouter
    from paddle_tpu_torch.generation.serving import ServingEngine

    class Engine(ServingEngine):
        def _admit_shared(self, req, slot, pages, n_cached):
            self.adopted_pages += len(pages)
            super()._admit_shared(req, slot, pages, n_cached)

        def export_requests(self):
            t0 = time.perf_counter()
            out = super().export_requests()
            self.exported += len(out)
            self.export_s = time.perf_counter() - t0
            return out

        def _take_token(self, req, tok, row, now):
            if rows is not None:
                rows.setdefault(req.prompt.tobytes(), []).append(
                    row.float().cpu().numpy())
            super()._take_token(req, tok, row, now)

        def close(self):
            self.closed_graphs = self.graphs_made()
            super().close()

        def graphs_made(self):
            if self.closed_graphs is not None:
                return self.closed_graphs
            return sum(1 for g in graphs_of(self) if g.graph is not None)

        def step(self):
            if self.first_step_s is not None:
                return super().step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().step()
            torch.cuda.synchronize()
            self.first_step_s = time.perf_counter() - t0

    class Router(FleetRouter):
        def __init__(self, *a, **kw):
            self.made, self.loss_s, self.loss_mem = [], [], []
            self.engines = []
            super().__init__(*a, **kw)

        def _make_engine(self, idx):
            mem = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            eng = Engine(self.model, replica=f"fleet{idx}",
                         **self._engine_kw)
            if self.engines:
                # a rebuild: the device bytes before it (the lost
                # replica closed) and after it
                self.loss_mem[-1] += [mem, torch.cuda.memory_allocated()]
            eng.build_s = time.perf_counter() - t0
            eng.adopted_pages = eng.exported = 0
            eng.first_step_s = eng.export_s = eng.closed_graphs = None
            self.made.append(eng)
            return eng

        def _lose_replica(self, ri, exc):
            self.loss_mem.append([torch.cuda.memory_allocated()])
            t0 = time.perf_counter()
            super()._lose_replica(ri, exc)
            self.loss_s.append(time.perf_counter() - t0)

    return Router(model, replicas=FLEET_REPLICAS, policy=policy,
                  max_batch=BATCH, page_size=PAGE, max_seq_len=MAX_SEQ,
                  prefill_chunk=CHUNK, host_tier_pages=FLEET_HOST_PAGES)


def replica_ready(eng) -> bool:
    """On the fused N = 1 route, one graph for its rung and one for its
    chunk program, both captured."""
    graphs = graphs_of(eng)
    return (eng._spec is not None and eng._stacked is None
            and len(eng._decode_fns) == 1 and eng._chunk_fn is not None
            and all(g.graph is not None for g in graphs))


def fleet_prompts(vocab):
    rng = np.random.default_rng(SEED + 17)
    groups = []
    for _ in range(2):
        prefix = rng.integers(0, vocab, (FLEET_PREFIX,)).astype(np.int32)
        groups.append([np.concatenate([prefix, rng.integers(
            0, vocab, (n,)).astype(np.int32)]) for n in FLEET_SUFFIXES])
    cold = [rng.integers(0, vocab, (n,)).astype(np.int32)
            for n in FLEET_COLD]
    return groups, cold


def fleet_warm(fleet, vocab):
    """One whole and one chunked request pinned on each replica (first
    calls and captures), then every probe cleared."""
    for ri in range(FLEET_REPLICAS):
        for p in prompts(vocab, (9, CHUNK + 9)):
            fleet.submit(p, 2, replica=ri)
    fleet.run()
    for eng in fleet.engines:
        for probe in (eng.decode_step_seconds, eng.prefill_seconds,
                      eng.ttft_seconds):
            probe.clear()
        eng.chunk_dispatches = eng.adopted_pages = 0
    fleet.placements.clear()


def fleet_traffic(fleet, vocab):
    """Wave 1 (each prefix's first request, the cold prompts), run to the
    end, then wave 2 (the other requests of each prefix). Returns (rids
    by prefix group, cold rids, streams, statuses, seconds, launch
    counts)."""
    from paddle_tpu_torch import kernels
    groups, cold = fleet_prompts(vocab)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    first = [fleet.submit(g[0], NEW_TOKENS) for g in groups]
    cold_rids = [fleet.submit(p, NEW_TOKENS) for p in cold]
    out = fleet.run()
    statuses = {r: fleet.status(r) for r in out}
    rest = [[fleet.submit(p, NEW_TOKENS) for p in g[1:]] for g in groups]
    more = fleet.run()
    statuses.update({r: fleet.status(r) for r in more})
    out.update(more)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rids = [[f] + r for f, r in zip(first, rest)]
    return rids, cold_rids, out, statuses, seconds, kernels.launch_counts()


def fleet_launches(counts, fleet, layers):
    """#3 a layer per decode step, #1 a layer per whole prefill, #4 a
    layer per chunk, summed over every engine the fleet built."""
    want = dict.fromkeys(counts, 0)
    engs = fleet.made
    want["fused_block_decode"] = layers * sum(
        len(e.decode_step_seconds) for e in engs)
    want["flash_prefill"] = layers * sum(len(e.prefill_seconds)
                                         for e in engs)
    want["paged_chunk_attention"] = layers * sum(e.chunk_dispatches
                                                 for e in engs)
    return want


def routed_counts():
    """fleet_requests_routed by (replica, reason), as the registry holds
    it now."""
    from paddle_tpu_torch import observability as obs
    fam = obs.snapshot()["metrics"].get("fleet_requests_routed")
    return {(s["labels"]["replica"], s["labels"]["reason"]): s["value"]
            for s in (fam or {}).get("series", [])}


def fleet_run(model, policy="prefix_affinity", spec="", rows=None):
    """One fleet, warmed, through fleet_traffic under FLAGS_fault_inject
    ``spec``; every request OK and exact launches. Returns (fleet, rids,
    cold rids, streams, seconds, launch counts, peak bytes, faults fired,
    program-cache captures during the traffic, the routing counters'
    increase by (replica, reason))."""
    from paddle_tpu_torch.generation.program_cache import \
        decode_program_cache
    from paddle_tpu_torch.testing import faults
    cache = decode_program_cache()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fleet = fleet_router(model, policy, rows)
    fleet_warm(fleet, model.config.vocab_size)
    keys = set()
    for eng in fleet.engines:
        keys.update(captures(cache, eng))
    before_caps = {k: cache.trace_count(k) for k in keys}
    before = injected()
    routed0 = routed_counts()
    with faults.armed(spec):
        # the router's site, armed for the traffic only (the warm-up ran
        # unarmed): a router binds its site when it is built
        fleet._f_router = faults.site("router_dispatch")
        rids, cold, out, statuses, seconds, counts = fleet_traffic(
            fleet, model.config.vocab_size)
    fired = injected().get("router_dispatch", 0.0) - before.get(
        "router_dispatch", 0.0)
    routed = routed_counts()
    routed = {k: v - routed0.get(k, 0.0) for k, v in routed.items()
              if v != routed0.get(k, 0.0)}
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    everyone = [r for g in rids for r in g] + cold
    require(all(statuses.get(r) == "OK" for r in everyone),
            f"fleet {policy} {spec!r}: statuses {statuses}")
    groups, cold_ps = fleet_prompts(model.config.vocab_size)
    check_tokens(list(zip(everyone, [p for g in groups for p in g]
                          + cold_ps, [out[r] for r in everyone])),
                 model.config.vocab_size, NEW_TOKENS)
    require_launches(counts, fleet_launches(
        counts, fleet, model.config.num_hidden_layers),
        f"fleet {policy} {spec!r}")
    caps = {k: cache.trace_count(k) - n for k, n in before_caps.items()}
    return (fleet, rids, cold, out, seconds, counts, peak, fired, caps,
            routed)


def run_fleet(model):
    """FleetRouter(replicas=2) on serve's Llama-2-7B (module docstring).
    Returns the launch counts of its runs."""
    from paddle_tpu_torch.testing import faults
    vocab = model.config.vocab_size
    layers = model.config.num_hidden_layers
    total = {}
    # prefix affinity, fault-free
    rows_free: dict = {}
    fleet, rids, cold, out, seconds, counts, peak_free, _, caps, delta = \
        fleet_run(model, rows=rows_free)
    placed = {rid: (ri, why) for rid, ri, why in fleet.placements}
    for g in rids:
        home = placed[g[0]][0]
        for rid in g[1:]:
            require(placed[rid] == (home, "affinity"),
                    f"fleet: wave-2 request {rid} placed {placed[rid]}, "
                    f"its prefix is on replica {home}")
    want = {}
    for _, ri, why in fleet.placements:
        want[str(ri), why] = want.get((str(ri), why), 0) + 1
    require(delta == want,
            f"fleet: routing counters {delta} != placements {want}")
    require(all(replica_ready(e) for e in fleet.engines),
            "fleet: a replica off the fused route or without its graphs")
    require(all(n == 0 for n in caps.values()),
            f"fleet: captures during the traffic {caps}")
    pool_bytes = (fleet.engines[0].pool.num_pages
                  * fleet.engines[0].pool.bytes_per_page)
    affinity_pages = sum(e.adopted_pages for e in fleet.made)
    gen = sum(len(t) for t in out.values())
    emit("fleet", model="llama2_7b", layers=layers, dtype="bf16",
         replicas=FLEET_REPLICAS, policy="prefix_affinity",
         fused_block_layers=1, host_tier_pages=FLEET_HOST_PAGES,
         prefix_len=FLEET_PREFIX, suffixes=list(FLEET_SUFFIXES),
         cold=list(FLEET_COLD), new_tokens=NEW_TOKENS,
         requests=len(out), generated=gen, seconds=seconds,
         tokens_per_s=gen / seconds, placements=fleet.placements,
         pages_adopted=affinity_pages,
         graphs_per_replica=[len(graphs_of(e)) for e in fleet.engines],
         launches=counts, peak_mem_gb=peak_free / 1e9,
         pool_gb_per_replica=pool_bytes / 1e9)
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    free_streams = {r: out[r] for g in rids for r in g}
    free_streams.update({r: out[r] for r in cold})
    order = [r for g in rids for r in g] + cold
    del fleet
    torch.cuda.empty_cache()
    # round robin: the baseline arm's pages adopted
    fleet, _, _, _, seconds, counts, _, _, _, _ = fleet_run(
        model, policy="round_robin")
    rr_pages = sum(e.adopted_pages for e in fleet.made)
    require(affinity_pages >= rr_pages, f"fleet: affinity adopted "
            f"{affinity_pages} pages, round robin {rr_pages}")
    emit("fleet", policy="round_robin", pages_adopted=rr_pages,
         affinity_pages_adopted=affinity_pages, seconds=seconds,
         placements=fleet.placements, launches=counts)
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    del fleet
    torch.cuda.empty_cache()
    # the loss drill
    rows_drill: dict = {}
    fleet, rids, cold, out, seconds, counts, peak, fired, caps, _ = \
        fleet_run(model, spec=FLEET_SPEC, rows=rows_drill)
    require(fleet.losses >= FLEET_MIN_LOSSES,
            f"fleet drill: {fleet.losses} losses")
    require(fleet.losses == fired, f"fleet drill: {fleet.losses} losses, "
            f"{fired} faults fired")
    exported = sum(e.exported for e in fleet.made)
    require(fleet.rerouted == exported, f"fleet drill: rerouted "
            f"{fleet.rerouted}, exported {exported}")
    rebuilt = fleet.made[FLEET_REPLICAS:]
    captured = sum(e.graphs_made() for e in rebuilt)
    require(sum(caps.values()) == captured,
            f"fleet drill: {sum(caps.values())} captures, the rebuilt "
            f"replicas hold {captured} graphs")
    require(peak <= peak_free + pool_bytes,
            f"fleet drill: peak {peak} over the fault-free {peak_free} + "
            f"one pool {pool_bytes} (device bytes before a loss, after "
            f"the lost replica closed, after its rebuild: "
            f"{fleet.loss_mem})")
    drill_streams = {r: out[r] for r in [r for g in rids for r in g] + cold}
    drill_order = [r for g in rids for r in g] + cold
    groups, cold_ps = fleet_prompts(vocab)
    all_prompts = [p for g in groups for p in g] + cold_ps
    agree = []
    for p, a, b in zip(all_prompts, order, drill_order):
        j = first_difference(free_streams[a], drill_streams[b])
        row = rows_free.get(p.tobytes(), [])
        agree.append(dict(prompt_len=len(p), first_difference=j,
                          top2_margin=(None if j is None or j >= len(row)
                                       else top2_margin(row[j]))))
    emit("fleet", run="loss drill", spec=FLEET_SPEC, losses=fleet.losses,
         faults_fired=fired, rerouted=fleet.rerouted,
         rebuilt_captures=captured, peak_mem_gb=peak / 1e9,
         fault_free_peak_mem_gb=peak_free / 1e9,
         pool_gb_per_replica=pool_bytes / 1e9,
         loss_ms=[1e3 * s for s in fleet.loss_s],
         mem_gb_at_losses=[[b / 1e9 for b in m] for m in fleet.loss_mem],
         harvest_ms=[1e3 * e.export_s for e in fleet.made
                     if e.export_s is not None],
         rebuild_ms=[1e3 * e.build_s for e in rebuilt],
         first_step_ms=[1e3 * e.first_step_s for e in rebuilt
                        if e.first_step_s is not None],
         streams_equal=sum(1 for a in agree
                           if a["first_difference"] is None),
         requests=len(agree), agreement=agree, seconds=seconds,
         launches=counts)
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    del fleet, rebuilt
    torch.cuda.empty_cache()
    # a crash loop: every dispatch fails; run raises after max_losses
    with faults.armed("router_dispatch:every=1"):
        fleet = fleet_router(model)
        for p in cold_ps:
            fleet.submit(p, 2)
        raised = False
        try:
            fleet.run()
        except faults.InjectedFault:
            raised = True
    require(raised and fleet.losses == fleet.max_losses,
            f"fleet crash loop: raised {raised}, {fleet.losses} losses of "
            f"{fleet.max_losses}")
    emit("fleet", run="crash loop", spec="router_dispatch:every=1",
         losses=fleet.losses, max_losses=fleet.max_losses, raised=raised)
    del fleet
    torch.cuda.empty_cache()
    return total


def run_fleet_parity(model):
    """The fp32 parity Llama behind a 2-replica fleet through replica
    losses: every stream equal to one engine's, token for token."""
    from paddle_tpu_torch.generation.serving import ServingEngine
    from paddle_tpu_torch.testing import faults
    vocab = model.config.vocab_size
    groups, cold = fleet_prompts(vocab)
    ps = [p for g in groups for p in g] + cold
    eng = ServingEngine(model, max_batch=BATCH, page_size=PAGE,
                        max_seq_len=MAX_SEQ)
    rids = [eng.submit(p, PARITY_NEW_TOKENS) for p in ps]
    out = eng.run()
    want = [out[r] for r in rids]
    del eng
    with faults.armed("router_dispatch:every=6:times=2"):
        fleet = fleet_router(model)
        frids = [fleet.submit(p, PARITY_NEW_TOKENS) for p in ps]
        fout = fleet.run()
    require(fleet.losses == 2, f"fleet parity: {fleet.losses} losses")
    require(all(fleet.status(r) == "OK" for r in frids),
            "fleet parity: a request did not end OK")
    require([fout[r] for r in frids] == want,
            "fleet parity: the fleet's streams differ from one engine's")
    emit("parity", run="fleet", model="llama2_7b width, 2 layers",
         dtype="fp32", replicas=FLEET_REPLICAS, requests=len(ps),
         new_tokens=PARITY_NEW_TOKENS, losses=fleet.losses,
         rerouted=fleet.rerouted, equal_to_one_engine=True)
    del fleet
    torch.cuda.empty_cache()


# --------------------------------------------------------- train_kernels
def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# the flash kernels whose rows give bound_frac (bound / kernel time): the
# forward and the backward, redesigned for the tensor cores
BOUND_FRAC_KEYS = ("fwd", "dq", "dkv")


def frac(bounds, times, key) -> dict:
    """``{"bound_frac": bound / kernel ms}`` for a BOUND_FRAC_KEYS row."""
    if key not in BOUND_FRAC_KEYS:
        return {}
    return dict(bound_frac=bounds[key][0] / times[key])


def check_flash_attention(dtype, device, rows):
    """Forward, dq and dk/dv against autograd of the dense reference on
    the card; then each kernel's time beside its plain version's, SDPA's
    (forward; forward + backward; backward alone), and the card's bound.
    Appends one row per kernel and FLASH_ATTN_SHAPES entry."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    for case, b, s, h, hkv, d, causal, skv in FLASH_ATTN_SHAPES:
        q = _rand(gen, (b * h, s, d), dtype, device)
        k = _rand(gen, (b * hkv, skv, d), dtype, device)
        v = _rand(gen, (b * hkv, skv, d), dtype, device)
        do = _rand(gen, (b * h, s, d), dtype, device)
        kw = dict(causal=causal, n_heads=h, n_kv_heads=hkv)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = fa.flash_attention_ref(*leaves, **kw)
        ref_grads = torch.autograd.grad(ref, leaves, do)
        _, lse_ref = fa.flash_attention_fwd_ref(q, k, v, **kw)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        delta = (out.float() * do.float()).sum(-1)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        atol, rtol = OUT_TOL[dtype]
        out_err, lse_err = max_err(out, ref), max_err(lse, lse_ref)
        out_excess = excess(out, ref, rtol)
        dq_rel = rel_err(dq, ref_grads[0])
        dkv_rel = max(rel_err(dk, ref_grads[1]), rel_err(dv, ref_grads[2]))
        dq_abs = max_err(dq, ref_grads[0])
        dkv_abs = max(max_err(dk, ref_grads[1]), max_err(dv, ref_grads[2]))
        tag = (f"{case} B={b} S={s} Skv={skv} H={h} Hkv={hkv} "
               f"{DTYPE_NAME[dtype]}")
        require(out_excess <= atol, f"flash fwd out {tag}: {out_excess} "
                f"over {rtol} |ref|")
        require(lse_err <= LSE_TOL[dtype], f"flash fwd lse {tag}: {lse_err}")
        require(dq_rel <= GRAD_TOL[dtype], f"flash dq {tag}: {dq_rel}")
        require(dkv_rel <= GRAD_TOL[dtype], f"flash dk/dv {tag}: {dkv_rel}")
        del leaves, ref, ref_grads, dq, dk, dv
        torch.cuda.empty_cache()

        bwd = (q, k, v, do, lse, delta)
        t = dict(
            fwd=time_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw),
                        iters=10, warmup=2),
            dq=time_ms(lambda: fa.flash_attention_bwd_dq(*bwd, **kw),
                       iters=10, warmup=2),
            dkv=time_ms(lambda: fa.flash_attention_bwd_dkv(*bwd, **kw),
                        iters=10, warmup=2),
            fwd_plain=time_ms(lambda: fa.flash_attention_fwd_ref(
                q, k, v, **kw), iters=5, warmup=1),
            dq_plain=time_ms(lambda: fa.flash_attention_bwd_dq_ref(
                *bwd, **kw), iters=5, warmup=1),
            dkv_plain=time_ms(lambda: fa.flash_attention_bwd_dkv_ref(
                *bwd, **kw), iters=5, warmup=1))
        qs, ks, vs, dos = (x.reshape(b, -1, x.shape[1], d)
                           for x in (q, k, v, do))
        t["sdpa_fwd"] = time_ms(lambda: sdpa(qs, ks, vs, is_causal=causal),
                                iters=10, warmup=2)
        lq, lk, lv = (x.clone().requires_grad_(True) for x in (qs, ks, vs))

        def sdpa_fwd_bwd():
            o = sdpa(lq, lk, lv, is_causal=causal)
            torch.autograd.grad(o, (lq, lk, lv), dos)

        t["sdpa_fwd_bwd"] = time_ms(sdpa_fwd_bwd, iters=10, warmup=2)
        # SDPA's backward alone: one saved forward, then its backward op
        # (of the backend SDPA picked on this card) again and again
        o = sdpa(lq, lk, lv, is_causal=causal)
        t["sdpa_bwd"] = time_ms(lambda: torch.autograd.grad(
            o, (lq, lk, lv), dos, retain_graph=True), iters=10, warmup=2)
        del o

        elem = q.element_size()
        # the (query, key) pairs the mask keeps
        pairs = b * h * (s * (s + 1) // 2 if causal else s * skv)
        fwd_ops = 4.0 * pairs * d                 # QK^T and PV
        stats = 4 * 2 * q.shape[0] * s            # lse and delta, f32
        bounds = dict(
            fwd=bound_ms(elem * (2 * q.numel() + k.numel() + v.numel())
                         + 4 * q.shape[0] * s, fwd_ops, dtype),
            # dq recomputes S and dP and forms dS K: 3 products
            dq=bound_ms(elem * (3 * q.numel() + k.numel() + v.numel())
                        + stats, 1.5 * fwd_ops, dtype),
            # dk/dv recompute S and dP and form P^T dO and dS^T Q: 4
            dkv=bound_ms(elem * (2 * q.numel() + 2 * k.numel()
                                 + 2 * v.numel()) + stats,
                         2.0 * fwd_ops, dtype),
            # the fused backward (dq and dk/dv from one recompute): 2.5x
            bwd=bound_ms(elem * (3 * q.numel() + 2 * k.numel()
                                 + 2 * v.numel()) + stats,
                         2.5 * fwd_ops, dtype))
        emit("train_kernels", case=case, dtype=DTYPE_NAME[dtype], B=b, S=s,
             Skv=skv, H=h, Hkv=hkv, D=d, causal=causal,
             out_max_err=out_err,
             out_excess=out_excess, out_atol=atol, out_rtol=rtol,
             lse_max_err=lse_err, lse_tol=LSE_TOL[dtype],
             dq_rel_err=dq_rel, dkv_rel_err=dkv_rel,
             grad_tol=GRAD_TOL[dtype],
             kernel_ms=dict(fwd=t["fwd"], bwd=t["dq"] + t["dkv"],
                            dq=t["dq"], dkv=t["dkv"]),
             plain_ms=dict(fwd=t["fwd_plain"],
                           bwd=t["dq_plain"] + t["dkv_plain"],
                           dq=t["dq_plain"], dkv=t["dkv_plain"]),
             library_ms=dict(sdpa_fwd=t["sdpa_fwd"],
                             sdpa_fwd_bwd=t["sdpa_fwd_bwd"],
                             sdpa_bwd=t["sdpa_bwd"]),
             bound_ms={key: val[0] for key, val in bounds.items()},
             bound_by={key: val[1] for key, val in bounds.items()},
             bound_frac={key: bounds[key][0] / t[key]
                         for key in BOUND_FRAC_KEYS})
        # library: SDPA's forward; for dq and dk/dv, SDPA's one backward
        # op, which computes both
        for name, key, err, lib in (
                ("flash_attention_fwd", "fwd", max(out_err, lse_err),
                 t["sdpa_fwd"]),
                ("flash_attention_bwd_dq", "dq", dq_abs, t["sdpa_bwd"]),
                ("flash_attention_bwd_dkv", "dkv", dkv_abs, t["sdpa_bwd"])):
            rows.append(dict(
                kernel=name, dtype=DTYPE_NAME[dtype], S=s, Skv=skv,
                case=case, D=d, causal=causal, max_err=err,
                kernel_ms=t[key],
                plain_ms=t[key + "_plain"],
                library_ms=lib, bound_ms=bounds[key][0],
                bound_by=bounds[key][1], **frac(bounds, t, key)))
        del q, k, v, do, lse, delta, out, lq, lk, lv
        torch.cuda.empty_cache()


def check_flash_with_lse(dtype, device):
    """flash_attention_with_lse on the kernels: out, lse and the gradients
    under a seeded (dO, dlse) against autograd of the plain forward
    (flash_attention_fwd_ref, which returns the differentiable lse) on the
    card, each kernel launched once; the log-space merge of two non-causal
    calls over the halves of the keys against the whole call; and the
    with_lse forward and forward + backward timed beside flash_attention's
    on the same shape (the fold of dlse into delta should not show), the
    plain version's and SDPA's. Returns the phase's launch counts."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    total: dict = {}
    for case, b, s, h, hkv in WITH_LSE_SHAPES:
        q = _rand(gen, (b * h, s, HEAD_DIM), dtype, device)
        k = _rand(gen, (b * hkv, s, HEAD_DIM), dtype, device)
        v = _rand(gen, (b * hkv, s, HEAD_DIM), dtype, device)
        do = _rand(gen, (b * h, s, HEAD_DIM), dtype, device)
        dlse = _rand(gen, (b * h, s), torch.float32, device)
        kw = dict(causal=True, n_heads=h, n_kv_heads=hkv)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref, ref_lse = fa.flash_attention_fwd_ref(*leaves, **kw)
        ref_grads = torch.autograd.grad((ref, ref_lse), leaves, (do, dlse))
        ref, ref_lse = ref.detach(), ref_lse.detach()
        lq = [t.clone().requires_grad_(True) for t in (q, k, v)]
        kernels.reset_launches()
        out, lse = fa.flash_attention_with_lse(*lq, **kw)
        grads = torch.autograd.grad((out, lse), lq, (do, dlse))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for name in TRAIN_KERNELS:
            require(counts[name] == 1, f"with_lse: {name} ran "
                    f"{counts[name]} times, want 1")
        total = {n: total.get(n, 0) + c for n, c in counts.items()}
        atol, rtol = OUT_TOL[dtype]
        tag = f"{case} B={b} S={s} H={h} Hkv={hkv} {DTYPE_NAME[dtype]}"
        out_excess = excess(out, ref, rtol)
        lse_err = max_err(lse, ref_lse)
        grad_rel = [rel_err(g, r) for g, r in zip(grads, ref_grads)]
        require(out_excess <= atol, f"with_lse out {tag}: {out_excess}")
        require(lse_err <= LSE_TOL[dtype], f"with_lse lse {tag}: {lse_err}")
        require(max(grad_rel) <= GRAD_TOL[dtype],
                f"with_lse grads {tag}: {grad_rel}")
        del leaves, ref_grads, grads
        torch.cuda.empty_cache()

        # the merge ring attention relies on: halves of the keys
        half = s // 2
        nk = dict(causal=False, n_heads=h, n_kv_heads=hkv)
        with torch.no_grad():
            whole, whole_lse = fa.flash_attention_with_lse(q, k, v, **nk)
            parts = [fa.flash_attention_with_lse(
                q, k[:, sl].contiguous(), v[:, sl].contiguous(), **nk)
                for sl in (slice(0, half), slice(half, s))]
        lse_m = torch.logaddexp(parts[0][1], parts[1][1])
        out_m = sum(torch.exp(part_lse - lse_m)[..., None] * part.float()
                    for part, part_lse in parts)
        merge_out_err = max_err(out_m, whole)
        merge_lse_err = max_err(lse_m, whole_lse)
        require(merge_out_err <= MERGE_TOL[dtype]
                and merge_lse_err <= LSE_TOL[dtype],
                f"with_lse merge {tag}: out {merge_out_err}, lse "
                f"{merge_lse_err}")
        del whole, parts, out_m
        torch.cuda.empty_cache()

        def lse_fwd_bwd():
            o, l = fa.flash_attention_with_lse(*lq, **kw)
            torch.autograd.grad((o, l), lq, (do, dlse))

        def flash_fwd_bwd():
            torch.autograd.grad(fa.flash_attention(*lq, **kw), lq, do)

        def plain_fwd_bwd():
            o, l = fa.flash_attention_fwd_ref(*lq, **kw)
            torch.autograd.grad((o, l), lq, (do, dlse))

        with torch.no_grad():
            t = dict(
                fwd=time_ms(lambda: fa.flash_attention_with_lse(
                    q, k, v, **kw), iters=10, warmup=2),
                flash_fwd=time_ms(lambda: fa.flash_attention(
                    q, k, v, **kw), iters=10, warmup=2),
                plain_fwd=time_ms(lambda: fa.flash_attention_fwd_ref(
                    q, k, v, **kw), iters=5, warmup=1))
        t.update(fwd_bwd=time_ms(lse_fwd_bwd, iters=10, warmup=2),
                 flash_fwd_bwd=time_ms(flash_fwd_bwd, iters=10, warmup=2),
                 plain_fwd_bwd=time_ms(plain_fwd_bwd, iters=3, warmup=1))
        qs, ks, vs = (x.reshape(b, -1, s, HEAD_DIM) for x in (q, k, v))
        t["sdpa_fwd"] = time_ms(lambda: sdpa(qs, ks, vs, is_causal=True),
                                iters=10, warmup=2)
        elem = q.element_size()
        pairs = b * h * s * (s + 1) // 2
        fwd_ops = 4.0 * pairs * HEAD_DIM
        stats = 4 * q.shape[0] * s
        fwd_bound = bound_ms(elem * (2 * q.numel() + k.numel() + v.numel())
                             + stats, fwd_ops, dtype)
        # forward, then dq and dk/dv (with dlse read once more)
        bwd_bound = bound_ms(elem * (3 * q.numel() + 2 * k.numel()
                                     + 2 * v.numel()) + 3 * stats,
                             2.5 * fwd_ops, dtype)
        emit("train_kernels", case=f"flash_attention_with_lse, {case}",
             dtype=DTYPE_NAME[dtype], B=b, S=s, H=h, Hkv=hkv, D=HEAD_DIM,
             out_excess=out_excess, out_atol=atol, out_rtol=rtol,
             lse_max_err=lse_err, lse_tol=LSE_TOL[dtype],
             grad_rel_err=dict(zip(("dq", "dk", "dv"), grad_rel)),
             grad_tol=GRAD_TOL[dtype], merge_out_max_err=merge_out_err,
             merge_lse_max_err=merge_lse_err, merge_out_tol=MERGE_TOL[dtype],
             launches=counts,
             kernel_ms=dict(fwd=t["fwd"], fwd_bwd=t["fwd_bwd"]),
             flash_attention_ms=dict(fwd=t["flash_fwd"],
                                     fwd_bwd=t["flash_fwd_bwd"]),
             plain_ms=dict(fwd=t["plain_fwd"], fwd_bwd=t["plain_fwd_bwd"]),
             library_ms=dict(sdpa_fwd=t["sdpa_fwd"]),
             bound_ms=dict(fwd=fwd_bound[0], fwd_bwd=fwd_bound[0]
                           + bwd_bound[0]),
             bound_by=dict(fwd=fwd_bound[1], bwd=bwd_bound[1]))
        del q, k, v, do, dlse, lq, out, lse
        torch.cuda.empty_cache()
    return total


# ----------------------------------------------------------------- train
def make_trainer(model, lr, steps=None, grad_accum_steps=1, remat=False,
                 mesh=None, fleet=None, level=None, pipeline=None,
                 **step_kw):
    """AdamW(multi_precision) + global-norm clip, through TrainStep; with
    ``steps`` a 2-step linear warmup into a cosine decay. With ``fleet``
    the model and the optimizer go through its ``distributed_model`` /
    ``distributed_optimizer``, with ``level`` through
    ``group_sharded_parallel``; ``mesh`` and ``step_kw`` are
    TrainStep's. With ``pipeline`` (a pipeline_ranks row) the model is a
    PipelineLayer and the step PipelineTrainStep."""
    from paddle_tpu_torch.hapi import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)
    sched = lr if steps is None else LinearWarmup(
        CosineAnnealingDecay(lr, T_max=steps), warmup_steps=2,
        start_lr=lr / 10, end_lr=lr)
    opt = AdamW(sched, parameters=model.named_parameters(),
                weight_decay=0.01, multi_precision=True,
                grad_clip=ClipGradByGlobalNorm(1.0))
    if pipeline is not None:
        from paddle_tpu_torch.distributed.fleet.meta_parallel import \
            PipelineTrainStep
        return PipelineTrainStep(
            model, opt, mesh, pipeline["accum"], remat=pipeline["remat"],
            virtual_pp_degree=pipeline["V"], schedule=pipeline["schedule"],
            sharding_level=pipeline["zero"],
            sharding_axis="dp" if pipeline["zero"] else None)
    if fleet is not None:
        model, opt = fleet.distributed_model(model), \
            fleet.distributed_optimizer(opt)
    if level is not None:
        from paddle_tpu_torch.distributed import group_sharded_parallel
        model, opt, _ = group_sharded_parallel(model, opt, level)
    return TrainStep(model, opt, grad_accum_steps=grad_accum_steps,
                     remat=remat, mesh=mesh, **step_kw)


def token_batch(vocab, batch, seq, seed_offset):
    """Seeded (inputs, shifted labels), int64, on the host."""
    rng = np.random.default_rng(SEED + seed_offset)
    ids = torch.from_numpy(rng.integers(0, vocab, (batch, seq + 1)))
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


def timed_steps(trainer, batch, warmup, steps):
    """``warmup`` steps, then ``steps`` more with the launch counters and
    the peak memory reset before them: (losses of all, seconds of each
    measured step, counts, peak bytes)."""
    from paddle_tpu_torch import kernels
    losses = []
    for _ in range(warmup):
        losses.append(trainer(*batch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    step_s = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(trainer(*batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    return [float(v) for v in losses], step_s, counts, peak


def run_train(device):
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.generation.program_cache import model_signature
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import memory
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = TRAIN_LAYERS
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device, dtype=torch.bfloat16,
                             generator=seed(SEED, device))
    trainer = make_trainer(model, 3e-4, steps=TRAIN_STEPS,
                           grad_accum_steps=TRAIN_ACCUM)
    x, y = (t.to(device) for t in token_batch(cfg.vocab_size, TRAIN_BATCH,
                                              TRAIN_SEQ, 5))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    losses, step_s, counts, peak = timed_steps(trainer, (x, y), 0,
                                               TRAIN_STEPS)
    require(all(math.isfinite(v) for v in losses), f"train losses {losses}")
    require(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    want = TRAIN_LAYERS * TRAIN_ACCUM * TRAIN_STEPS
    for name in TRAIN_KERNELS:
        require(counts[name] == want,
                f"{name} ran {counts[name]} times, want {want}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_matmul = cfg.num_params() - cfg.vocab_size * cfg.hidden_size
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    attn = (3.5 * 4.0 * pairs * cfg.hidden_size * TRAIN_LAYERS
            * TRAIN_BATCH)                       # forward 1x + backward 2.5x
    flops = 6.0 * n_matmul * tokens + attn
    step_ms = 1e3 * float(np.median(step_s))
    # memwatch: the step's row (its first step measured)
    sig = model_signature(model)[:8]
    rows = [r for r in memory.program_table()
            if r["kind"] == "train_step" and r["model"] == sig]
    require(len(rows) == 1 and rows[0]["captures"] == 1
            and rows[0]["temp"] > 0 and rows[0]["bucket"] == TRAIN_BATCH,
            f"train: memwatch rows {rows}")
    print(memory.format_program_table(rows), flush=True)
    emit("train", model="llama2_7b width", layers=TRAIN_LAYERS,
         params=cfg.num_params(), dtype="bf16, f32 masters",
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, grad_accum_steps=TRAIN_ACCUM,
         steps=TRAIN_STEPS, losses=losses,
         step_ms=[1e3 * v for v in step_s], step_ms_median=step_ms,
         tokens_per_s=tokens / (step_ms / 1e3),
         peak_mem_gb=peak / 1e9,
         model_flops_per_step=flops, attention_flops_per_step=attn,
         mfu_vs_989_tflops=flops / (step_ms / 1e3) / PEAK_FLOPS[
             torch.bfloat16],
         launches=counts, model_build_s=build_s,
         memwatch_train_step=rows[0])
    del model, trainer, x, y
    torch.cuda.empty_cache()
    return counts, dict(peak=peak, step_ms=step_ms, losses=losses,
                        flops=flops)


def train_flops(cfg, batch) -> float:
    """The model FLOPs of one step of ``batch`` rows of TRAIN_SEQ tokens
    through ``cfg``'s layers: 6 x the matmul parameters x tokens, plus
    causal attention (forward 1x, backward 2.5x)."""
    n_matmul = cfg.num_params() - cfg.vocab_size * cfg.hidden_size
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    attn = (3.5 * 4.0 * pairs * cfg.hidden_size * cfg.num_hidden_layers
            * batch)
    return 6.0 * n_matmul * batch * TRAIN_SEQ + attn


def train_model(device, generator_seed, dtype=torch.bfloat16,
                layers=TRAIN_LAYERS):
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = layers
    return cfg, LlamaForCausalLM(cfg, device=device, dtype=dtype,
                                 generator=seed(generator_seed, device))


def run_train_remat(device, train):
    """TrainStep(remat=True) on the train phase's model (same seed) and
    batch: the first step's gradients against the same step without remat
    (bit for bit: the same deterministic kernels recompute the same
    activations), then TRAIN_STEPS steps timed as in train, with a peak
    below train's and the flash forward launched twice a layer and
    micro-batch (the recompute runs it again)."""
    from paddle_tpu_torch import kernels
    cfg, model = train_model(device, SEED)
    x, y = (t.to(device) for t in token_batch(cfg.vocab_size, TRAIN_BATCH,
                                              TRAIN_SEQ, 5))
    plain = make_trainer(model, 3e-4, steps=TRAIN_STEPS,
                         grad_accum_steps=TRAIN_ACCUM)
    trainer = make_trainer(model, 3e-4, steps=TRAIN_STEPS,
                           grad_accum_steps=TRAIN_ACCUM, remat=True)

    def grads_of(step):
        """The step's loss and gradients, the launches, and the memory its
        forward and backward add at their peak (activations and
        gradients; the optimizer state is not made yet)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        loss, grads = step.compute_loss_grads(x, y)
        torch.cuda.synchronize()
        return (loss, grads, kernels.launch_counts(),
                torch.cuda.max_memory_allocated() - base)

    loss_plain, ref, _, plain_added = grads_of(plain)
    loss_remat, grads, first_counts, remat_added = grads_of(trainer)
    unequal = [k for k, g in grads.items() if not torch.equal(g, ref[k])]
    worst = max(rel_err(g, ref[k]) for k, g in grads.items())
    require(sorted(grads) == sorted(ref), "train_remat: gradient names")
    require(not unequal and float(loss_remat) == float(loss_plain),
            f"train_remat: first-step gradients differ from train's "
            f"without remat ({len(unequal)} tensors, worst rel {worst})")
    micro = TRAIN_LAYERS * TRAIN_ACCUM
    require(first_counts["flash_attention_fwd"] == 2 * micro
            and first_counts["flash_attention_bwd_dq"] == micro,
            f"train_remat: first-step launches {first_counts}")
    require(remat_added < plain_added, f"train_remat: forward + backward "
            f"add {remat_added / 1e9} GB, without remat {plain_added / 1e9}")
    del plain, ref, grads
    trainer.optimizer.clear_grad()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    losses, step_s, counts, peak = timed_steps(trainer, (x, y), 0,
                                               TRAIN_STEPS)
    require(all(math.isfinite(v) for v in losses), f"remat losses {losses}")
    want = dict(flash_attention_fwd=2 * micro * TRAIN_STEPS,
                flash_attention_bwd_dq=micro * TRAIN_STEPS,
                flash_attention_bwd_dkv=micro * TRAIN_STEPS)
    for name, n in want.items():
        require(counts[name] == n, f"train_remat: {name} ran {counts[name]}"
                f" times, want {n}")
    require(peak < train["peak"], f"train_remat: peak {peak / 1e9} GB not "
            f"below train's {train['peak'] / 1e9} GB")
    step_ms = 1e3 * float(np.median(step_s))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit("train_remat", model="llama2_7b width", layers=TRAIN_LAYERS,
         dtype="bf16, f32 masters", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         grad_accum_steps=TRAIN_ACCUM, steps=TRAIN_STEPS, losses=losses,
         losses_equal_train=losses == train["losses"],
         first_step_grads_bitwise_equal=True,
         first_step_grad_rel_err_max=worst, first_step_launches=first_counts,
         step_ms=[1e3 * v for v in step_s], step_ms_median=step_ms,
         train_step_ms_median=train["step_ms"],
         tokens_per_s=tokens / (step_ms / 1e3),
         mfu_vs_989_tflops=train["flops"] / (step_ms / 1e3) / PEAK_FLOPS[
             torch.bfloat16],
         peak_mem_gb=peak / 1e9, train_peak_mem_gb=train["peak"] / 1e9,
         fwd_bwd_added_gb=remat_added / 1e9,
         fwd_bwd_added_gb_without_remat=plain_added / 1e9,
         launches=counts)
    del model, trainer, x, y
    torch.cuda.empty_cache()
    return counts


# hybrid_ranks, zero_ranks and pipeline_ranks: rows across gloo ranks on the
# one card. fp32 rows run 7B width at HYBRID_RANK_LAYERS (the pipeline's
# PIPE_RANK_LAYERS: a stage of pp = 2 holds one) on HYBRID_RANK_BATCH x
# HYBRID_RANK_SEQ tokens and are held to one process; bf16 rows run train's
# depth, batch and recipe and are held to train's losses. The fp32 rows'
# gloo collectives cross the host at under 1 GB/s, so their depth is what
# keeps the script under its time limit (2 layers until the pipeline's rows
# joined)
HYBRID_RANK_LAYERS, HYBRID_RANK_BATCH, HYBRID_RANK_SEQ = 1, 2, 1024
PIPE_RANK_LAYERS = 2
# 2 steps: an fp32 row's step all-reduces its whole-vocabulary gradients
# through the host, and ring_ranks' and ep_ranks' rows share the worlds
HYBRID_RANK_STEPS = 2
HYBRID_RANK_LR = 3e-4
HYBRID_LOSS_RTOL = 1e-5     # fp32: mp splits the row-parallel sums
HYBRID_PARAM_TOL = 1e-5     # fp32, elementwise, against the one-rank run
HYBRID_PARAM_OFF_FRAC = 1e-3  # elements allowed beyond it (near AdamW's
                              # eps), each within 3 lr
BF16_RANK_LOSS_RTOL = 1e-2  # bf16 sums in another order than train's
HYBRID_TIMEOUT_S = 600      # join; each gloo group fails after 300 s


def one_nccl_rank():
    """init_parallel_env over a one-rank NCCL world on a free localhost
    port (the machine has no other interface than lo)."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed.parallel import free_port
    os.environ.update(PADDLE_TRAINER_ID="0", PADDLE_TRAINERS_NUM="1",
                      PADDLE_LOCAL_RANK="0",
                      PADDLE_MASTER=f"127.0.0.1:{free_port()}")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    pdist.init_parallel_env()


def run_hybrid(device, train):
    """One NCCL rank at train's width, depth, batch and recipe, through the
    reference's hybrid recipe: init_parallel_env (a one-rank NCCL world on
    a free localhost port), fleet.init (dp = mp = 1), annotate_llama_tp,
    fleet.distributed_model / distributed_optimizer, TrainStep(mesh=
    hcg.get_mesh()). At mp = 1 the Megatron layers are their serial selves
    and a one-rank NCCL all-reduce is exact, so the 5 losses equal train's
    bit for bit."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.llama import annotate_llama_tp
    one_nccl_rank()
    try:
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1}
        fleet.init(is_collective=True, strategy=strategy)
        hcg = fleet.get_hybrid_communicate_group()
        cfg, model = train_model(device, SEED)
        annotate_llama_tp(model)
        trainer = make_trainer(model, 3e-4, steps=TRAIN_STEPS,
                               grad_accum_steps=TRAIN_ACCUM,
                               mesh=hcg.get_mesh(), fleet=fleet)
        x, y = (t.to(device) for t in token_batch(
            cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, 5))
        pdist.reset_collective_counts()
        losses, step_s, counts, peak = timed_steps(trainer, (x, y), 0,
                                                   TRAIN_STEPS)
        coll = pdist.collective_counts()
        backend = pdist.get_backend()
    finally:
        pdist.destroy_process_group()
    require(losses == train["losses"], f"hybrid: losses {losses} differ "
            f"from train's {train['losses']}")
    want = TRAIN_LAYERS * TRAIN_ACCUM * TRAIN_STEPS
    for name in TRAIN_KERNELS:
        require(counts[name] == want,
                f"hybrid: {name} ran {counts[name]} times, want {want}")
    step_ms = 1e3 * float(np.median(step_s))
    emit("hybrid", model="llama2_7b width", layers=TRAIN_LAYERS,
         dtype="bf16, f32 masters", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         grad_accum_steps=TRAIN_ACCUM, steps=TRAIN_STEPS, ranks=1,
         backend=backend, degrees=dict(dp=1, mp=1), losses=losses,
         losses_bitwise_equal_train=True,
         step_ms=[1e3 * v for v in step_s], step_ms_median=step_ms,
         train_step_ms_median=train["step_ms"],
         collectives_per_step={k: v / TRAIN_STEPS for k, v in coll.items()},
         peak_mem_gb=peak / 1e9, train_peak_mem_gb=train["peak"] / 1e9,
         launches=counts)
    del model, trainer, x, y
    torch.cuda.empty_cache()
    return counts, {k: v / TRAIN_STEPS for k, v in coll.items()}


def rank_row(level=None, dp=1, sharding=1, mp=1, dtype=torch.float32,
             batch=HYBRID_RANK_BATCH, seq=HYBRID_RANK_SEQ, localsgd_k=None,
             steps=HYBRID_RANK_STEPS, pp=1, schedule="1F1B", micro=1, V=1,
             remat=True, zero=None, layers=None):
    """One row of hybrid_ranks, zero_ranks or pipeline_ranks: the degrees,
    the ZeRO level (None: no group_sharded_parallel) and LocalSGD's k. An
    fp32 row runs HYBRID_RANK_LAYERS (or ``layers``) on ``batch`` x ``seq``
    tokens (seed 7) in one micro-batch; a bf16 row train's depth, global
    batch (seed 5), schedule and micro-batch of one row, so a rank with
    more rows accumulates. A row of one step only reads its resting
    memory (the optimizer state is made in the first step). At ``pp`` > 1
    the row trains train's model carried into LlamaForCausalLMPipe
    (convert.pipe_name_map) through PipelineTrainStep: ``micro``
    microbatches under ``schedule`` at ``V`` virtual stages a rank, with
    ``remat`` and ZeRO level ``zero`` over dp."""
    fp32 = dtype == torch.float32
    if not fp32:
        batch, seq = TRAIN_BATCH, TRAIN_SEQ
    return dict(level=level, dp=dp, sharding=sharding, mp=mp, dtype=dtype,
                layers=layers or (HYBRID_RANK_LAYERS if fp32
                                  else TRAIN_LAYERS),
                batch=batch, seq=seq, seed=7 if fp32 else 5,
                lr=HYBRID_RANK_LR if fp32 else 3e-4,
                sched_steps=HYBRID_RANK_STEPS if fp32 else TRAIN_STEPS,
                accum=(micro if pp > 1 else 1 if fp32
                       else batch // (dp * sharding)),
                localsgd_k=localsgd_k, steps=steps, pp=pp,
                schedule=schedule, V=V, remat=remat, zero=zero)


def _one_rank(device, layers, batch, seq, micro=None):
    """The fp32 steps in one process, no runtime: (losses, parameters).
    With ``micro`` the model is first carried into its pipe, built whole
    (``LlamaForCausalLMPipe`` of one stage: the pipeline rows' model and
    loss), and each step accumulates ``micro`` microbatches; the
    parameters come back under the whole model's names."""
    from paddle_tpu_torch.convert import pipe_name_map
    cfg, model = train_model(device, SEED, dtype=torch.float32,
                             layers=layers)
    names = None
    if micro:
        names = {v: k for k, v in pipe_name_map(model).items()}
        model = pipe_from(cfg, model, None, dict(
            mp=1, V=1, dtype=torch.float32), device)
    trainer = make_trainer(model, HYBRID_RANK_LR, steps=HYBRID_RANK_STEPS,
                           grad_accum_steps=micro or 1,
                           loss_fn=model._loss_fn if micro else None)
    x, y = (t.to(device) for t in token_batch(cfg.vocab_size, batch, seq,
                                              7))
    losses = [float(trainer(x, y)) for _ in range(HYBRID_RANK_STEPS)]
    params = {(names[k] if names else k): p.detach()
              for k, p in model.named_parameters()}
    del trainer
    return losses, params


def _localsgd_reference(device, row):
    """LocalSGD's emulation in one process: two replicas, each stepping on
    its row of the batch, their parameters averaged every k-th step:
    (the replicas' mean loss a step, replica 0's parameters)."""
    models, trainers = [], []
    for _ in range(2):
        cfg, m = train_model(device, SEED, dtype=torch.float32,
                             layers=row["layers"])
        models.append(m)
        trainers.append(make_trainer(m, HYBRID_RANK_LR,
                                     steps=row["sched_steps"]))
    x, y = (t.to(device) for t in token_batch(cfg.vocab_size, row["batch"],
                                              row["seq"], row["seed"]))
    losses = []
    for step in range(1, row["steps"] + 1):
        losses.append(sum(float(t(x[i:i + 1], y[i:i + 1]))
                          for i, t in enumerate(trainers)) / 2)
        if step % row["localsgd_k"] == 0:
            with torch.no_grad():
                for a, b in zip(models[0].parameters(),
                                models[1].parameters()):
                    mean = (a + b) / 2
                    a.copy_(mean)
                    b.copy_(mean)
    params = {k: p.detach() for k, p in models[0].named_parameters()}
    del trainers, models
    return losses, params


def _fingerprint(t: torch.Tensor) -> torch.Tensor:
    """A position-weighted sum of an fp32 tensor's bits in int64 (which
    wraps), on the card: replicas equal bit for bit give equal sums."""
    bits = t.detach().reshape(-1).view(torch.int32).long()
    weight = torch.arange(bits.numel(), device=bits.device,
                          dtype=torch.int64) * -7046029254386353131 + 1
    return (bits * weight).sum()


def _whole_on_card(model, hcg, check_replicas=True):
    """Each parameter whole on this rank, on the card (ZeRO slices gathered
    over sharding, tensor-parallel shards over mp), and how many differ
    from the first rank's copy over dp and over sharding (each tensor's
    _fingerprint broadcast, not the tensor: gloo crosses the host)."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed.sharding.group_sharded import \
        whole_parameters
    whole = whole_parameters(model)
    unequal = 0
    groups = [g for g in (hcg.get_data_parallel_group(),
                          hcg.get_sharding_parallel_group())
              if check_replicas and g.nranks > 1]
    if groups:
        with torch.no_grad():
            mine = torch.stack([_fingerprint(t) for t in whole.values()])
            for g in groups:
                first = mine.clone()
                pdist.broadcast(first, g.ranks[0], group=g)
                unequal += int((first != mine).sum())
    return whole, unequal


def pipe_from(cfg, model, hcg, row, device):
    """``model`` (train_model's) carried into LlamaForCausalLMPipe on this
    rank's stage of ``hcg`` (every entry without one) by
    convert.pipe_name_map, its entries copied on the card (``model`` is
    dropped by the caller)."""
    from paddle_tpu_torch.convert import pipe_name_map
    from paddle_tpu_torch.models import LlamaForCausalLMPipe
    pipe = LlamaForCausalLMPipe(
        cfg, num_stages=hcg.get_pipe_parallel_world_size() if hcg else 1,
        topology=hcg, tensor_parallel=row["mp"] > 1,
        num_virtual_pipeline_stages=row["V"], device=device,
        dtype=row["dtype"])
    names = pipe_name_map(model)
    mine = dict(pipe.named_parameters())
    with torch.no_grad():
        for k, p in model.named_parameters():
            if names[k] in mine:
                mine[names[k]].copy_(p)
    return pipe


def _stages_to_first(params, hcg, device):
    """Each stage's whole parameters sent to the first stage of this rank's
    pipeline group (the one of global rank 0 only) through the pipeline's
    transport (gloo takes CUDA tensors through pinned host memory)."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed.fleet.meta_parallel.pp_utils \
        .p2p_communication import Wire
    pp = hcg.get_pipe_parallel_group()
    metas = []
    pdist.all_gather_object(metas, sorted((k, tuple(v.shape), v.dtype)
                                          for k, v in params.items()),
                            group=pp)
    if 0 not in pp.ranks:
        return params
    wire = Wire(pp, device)
    for s in range(1, pp.nranks):
        for k, shape, dtype in metas[s]:
            if pp.rank == 0:
                buf = torch.empty(shape, dtype=dtype, device=device)
                wire.exchange(recvs=[(buf, pp.ranks[s])])
                params[k] = buf
            elif pp.rank == s:
                wire.exchange([(params[k], pp.ranks[0])])
    return params


def rank_body(rank, rows):
    """One rank of hybrid_ranks, zero_ranks or pipeline_ranks: gloo on
    cuda:0 (NCCL refuses two ranks on one device); each rank_row builds
    the seeded model (annotate_llama_tp but under LocalSGD), make_trainer
    through group_sharded_parallel at the row's level (if any) on
    TrainStep(mesh=..., data_axes=("dp", "sharding")), or at pp > 1 the
    model's stage of LlamaForCausalLMPipe through PipelineTrainStep; the
    row's steps with this rank's #7-#9 launches (and how many its layers
    make), collectives, peak and resting memory. The fp32 rows' parameters
    are gathered whole (a pipeline's stages onto rank 0, under the whole
    model's names); rank 0 holds them, once the world is done, to the same
    steps in one process (a pipeline row: its pipe built whole, on the
    same microbatches)."""
    import datetime
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.convert import pipe_name_map
    from paddle_tpu_torch.distributed.fleet import base_topology as topo
    from paddle_tpu_torch.models.llama import annotate_llama_tp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    pdist.init_parallel_env(backend="gloo", device=device,
                            timeout=datetime.timedelta(seconds=300))
    out, kept, ctx_kept = [], [], {}
    try:
        for i, row in enumerate(rows):
            t_row = time.perf_counter()
            if "kind" in row:
                # this slice's rows: ring / Ulysses attention, expert
                # parallelism, the sequence-parallel linears
                got, params = CTX_ROWS[row["kind"]](rank, row, device)
                got["row_s"] = time.perf_counter() - t_row
                out.append(got)
                if rank == 0 and params is not None:
                    ctx_kept[i] = {k: v.cpu() for k, v in params.items()}
                del params
                torch.cuda.empty_cache()
                continue
            hcg = topo.create_hybrid_communicate_group(
                dp_degree=row["dp"], pp_degree=row["pp"],
                sharding_degree=row["sharding"], mp_degree=row["mp"])
            hcg_s = time.perf_counter() - t_row
            cfg, model = train_model(device, SEED, dtype=row["dtype"],
                                     layers=row["layers"])
            names = None
            if row["pp"] > 1:
                names = {v: k for k, v in pipe_name_map(model).items()}
                model = pipe_from(cfg, model, hcg, row, device)
                torch.cuda.empty_cache()
            elif not row["localsgd_k"]:
                annotate_llama_tp(model)
            trainer = make_trainer(model, row["lr"],
                                   steps=row["sched_steps"],
                                   grad_accum_steps=row["accum"],
                                   mesh=hcg.get_mesh(), level=row["level"],
                                   data_axes=("dp", "sharding"),
                                   localsgd_k=row["localsgd_k"],
                                   **({"pipeline": row} if names else {}))
            x, y = (t.to(device) for t in token_batch(
                cfg.vocab_size, row["batch"], row["seq"], row["seed"]))
            pdist.reset_collective_counts()
            losses, step_s, counts, peak = timed_steps(trainer, (x, y), 0,
                                                       row["steps"])
            layers = sum(type(m).__name__ == "LlamaDecoderLayer"
                         for m in model.modules())
            micro = layers * row["accum"] * row["steps"]
            got = dict(losses=losses, step_ms=[1e3 * v for v in step_s],
                       launches={k: counts[k] for k in TRAIN_KERNELS},
                       want_launches=dict(
                           flash_attention_fwd=micro * (
                               2 if names and row["remat"] else 1),
                           flash_attention_bwd_dq=micro,
                           flash_attention_bwd_dkv=micro),
                       collectives=pdist.collective_counts(),
                       resolved_level=trainer.sharding_level,
                       heads=next(m for m in model.modules()
                                  if hasattr(m, "num_kv_heads")).num_heads,
                       stage=hcg.get_stage_id(), layers_on_rank=layers,
                       peak_mem_gb=peak / 1e9,
                       resting_mem_gb=torch.cuda.memory_allocated() / 1e9)
            if names:
                got["ticks"] = len(trainer._ticks)
            del trainer, x, y
            if row["dtype"] == torch.float32:
                params, got["replicas_unequal"] = _whole_on_card(
                    model, hcg, not row["localsgd_k"])
                if names:
                    params = {names[k]: v for k, v in _stages_to_first(
                        params, hcg, device).items()}
                if rank == 0:
                    kept.append({k: v.cpu() for k, v in params.items()})
                del params
            got.update(row_s=time.perf_counter() - t_row, hcg_s=hcg_s)
            out.append(got)
            topo._reset_hcg()
            del model
            torch.cuda.empty_cache()
    finally:
        pdist.destroy_process_group()
    if rank == 0:
        # the world is done: the fp32 rows in one process
        refs = {}
        for i, (row, got) in enumerate(zip(rows, out)):
            if row.get("kind") in CTX_REFERENCES:
                t_ref = time.perf_counter()
                CTX_REFERENCES[row["kind"]](row, got, ctx_kept.pop(i, None),
                                            device)
                got["ref_s"] = time.perf_counter() - t_ref
                continue
            if "kind" in row or row["dtype"] != torch.float32:
                continue
            t_ref = time.perf_counter()
            if row["localsgd_k"]:
                ref_losses, ref_params = _localsgd_reference(device, row)
            else:
                key = (row["layers"], row["batch"], row["seq"],
                       row["accum"] if row["pp"] > 1 else None)
                if key not in refs:
                    refs[key] = _one_rank(device, *key)
                ref_losses, ref_params = refs[key]
            got["one_rank_losses"] = ref_losses
            got["loss_rel_err"] = max(abs(a - b) / abs(b) for a, b in
                                      zip(got["losses"], ref_losses))
            params = kept.pop(0)
            off = total = 0
            worst = 0.0
            for name, want in ref_params.items():
                diff = (params[name].to(device).double()
                        - want.double()).abs()
                worst = max(worst, float(diff.max()))
                off += int((diff > HYBRID_PARAM_TOL).sum())
                total += diff.numel()
                del diff
            got.update(param_max_abs_err=worst, params_off=off,
                       params_total=total,
                       param_names_equal=sorted(params) == sorted(
                           ref_params),
                       ref_s=time.perf_counter() - t_ref)
            del params, ref_params, ref_losses
            torch.cuda.empty_cache()
        del refs
    return out


def spawn_worlds(worlds):
    """Each world (ranks, rows) of rank_body started on the one card
    through the port's spawn and joined before the next starts (two
    side by side ran out of card memory): [(ranks, rows, context,
    seconds)] with each rank's results."""
    from paddle_tpu_torch.distributed import spawn
    done = []
    for n, rows in worlds:
        t0 = time.perf_counter()
        ctx = spawn(rank_body, args=(rows,), nprocs=n, join=False)
        try:
            ctx.join(HYBRID_TIMEOUT_S)
        finally:
            ctx.terminate()
        done.append((n, rows, ctx, time.perf_counter() - t0))
    return done


def check_rank_worlds(phase, worlds, train):
    """The rows of ``worlds`` ([(ranks, rows, each rank's results of the
    rows)]) held to their checks: each
    rank's #7-#9 launched layers x micro-batches x steps times, every
    rank's losses equal, 32 / mp heads a rank, finite losses that fall;
    an fp32 row's losses within HYBRID_LOSS_RTOL of one process, its
    gathered parameters equal across replicas and within HYBRID_PARAM_TOL
    of one process but at most HYBRID_PARAM_OFF_FRAC of the elements (each
    within 3 lr); a bf16 row's losses within BF16_RANK_LOSS_RTOL of
    train's. (rows, the launches summed)."""
    rows, counts = [], {k: 0 for k in TRAIN_KERNELS}
    for n, world_rows, results in worlds:
        for i, spec in enumerate(world_rows):
            per_rank = [r[i] for r in results]
            row = dict(per_rank[0])
            row.update(ranks=n, dtype=DTYPE_NAME[spec["dtype"]],
                       **{k: spec[k] for k in ("level", "dp", "sharding",
                                               "mp", "layers", "batch",
                                               "seq", "accum",
                                               "localsgd_k")})
            if spec["pp"] > 1:
                row.update({k: spec[k] for k in ("pp", "schedule", "V",
                                                 "remat", "zero")})
            what = (f"{phase} {row['dtype']} {spec['level']} "
                    f"dp={spec['dp']} sharding={spec['sharding']} "
                    f"mp={spec['mp']} localsgd={spec['localsgd_k']}"
                    + (f" pp={spec['pp']} {spec['schedule']} V={spec['V']}"
                       if spec["pp"] > 1 else ""))
            for r, got in enumerate(per_rank):
                for name in TRAIN_KERNELS:
                    want = got["want_launches"][name]
                    require(got["launches"][name] == want,
                            f"{what} rank {r}: {name} ran "
                            f"{got['launches'][name]} times, want {want}")
                    counts[name] += got["launches"][name]
                require(got["losses"] == row["losses"],
                        f"{what}: rank {r}'s losses differ")
                require(got["heads"] == 32 // spec["mp"],
                        f"{what}: rank {r} runs {got['heads']} heads")
            require(all(math.isfinite(v) for v in row["losses"])
                    and (spec["steps"] == 1
                         or row["losses"][-1] < row["losses"][0]),
                    f"{what}: losses {row['losses']}")
            if spec["dtype"] == torch.float32:
                require(row["param_names_equal"]
                        and all(g["replicas_unequal"] == 0
                                for g in per_rank),
                        f"{what}: gathered parameters")
                require(row["loss_rel_err"] <= HYBRID_LOSS_RTOL,
                        f"{what}: loss rel err {row['loss_rel_err']}")
                require(row["param_max_abs_err"] <= 3 * HYBRID_RANK_LR
                        and row["params_off"]
                        <= HYBRID_PARAM_OFF_FRAC * row["params_total"],
                        f"{what}: {row['params_off']} elements beyond "
                        f"{HYBRID_PARAM_TOL}, worst "
                        f"{row['param_max_abs_err']}")
            else:
                want_losses = train["losses"][:spec["steps"]]
                row["train_losses"] = want_losses
                row["loss_rel_err_vs_train"] = max(
                    abs(a - b) / abs(b)
                    for a, b in zip(row["losses"], want_losses))
                require(row["loss_rel_err_vs_train"] <= BF16_RANK_LOSS_RTOL,
                        f"{what}: losses {row['losses']} vs train's "
                        f"{want_losses}")
            for key in ("step_ms", "resting_mem_gb", "peak_mem_gb",
                        "launches", "stage", "layers_on_rank", "row_s",
                        "hcg_s"):
                row[f"per_rank_{key}"] = [g[key] for g in per_rank]
            rows.append(row)
    return rows, counts


def run_ranks(phases, train):
    """The rank phases ``phases`` ([(phase, worlds, fields)], each world
    (ranks, rows)) on the one card over gloo with CUDA tensors: every
    phase's rows of one world size run in one spawned world (one world
    after another), then each phase's rows are checked and its line
    emitted: its summed #7-#9 launches, the seconds of its rows on rank 0
    (its rows' own time, one-process references included; the spawns are
    shared). A gloo collective crosses the host, so the step times say
    nothing of the card's speed. Returns {phase: (counts, rows)}."""
    # this process's garbage (a DataParallel's gradient hooks hold its
    # model in a cycle) and cache off the card before the ranks start
    gc.collect()
    torch.cuda.empty_cache()
    sizes = sorted({n for _, worlds, _ in phases for n, _ in worlds})
    merged = [(n, [row for _, worlds, _ in phases for m, rows in worlds
                   if m == n for row in rows]) for n in sizes]
    done = spawn_worlds(merged)
    index = {id(row): (ctx, i) for _, rows, ctx, _ in done
             for i, row in enumerate(rows)}
    out = {}
    for phase, worlds, fields in phases:
        fields = dict(fields)
        check = fields.pop("check", None)
        per_world = []
        for n, rows in worlds:
            ctx = index[id(rows[0])][0]
            idx = [index[id(row)][1] for row in rows]
            per_world.append((n, rows, [[res[i] for i in idx]
                                        for res in ctx.results]))
        rows, counts = (check(phase, per_world) if check is not None
                        else check_rank_worlds(phase, per_world, train))
        emit(phase, ranks_on_one_card=[n for n, _ in worlds],
             world_seconds={n: t for n, _, _, t in done},
             backend="gloo (CUDA tensors, through the host)",
             note="gloo collectives cross the host: step times are not a "
                  "performance figure; one world of each size runs every "
                  "rank phase's rows",
             rows=rows,
             seconds=sum(r["per_rank_row_s"][0] + r.get("ref_s", 0.0)
                         for r in rows), **fields)
        out[phase] = (counts, rows)
    return out


def hybrid_rank_rows():
    """hybrid_ranks: fp32 at dp = 2 and mp = 2 (a world of 2, beside bf16
    at mp = 2) and dp = 2 x mp = 2 (a world of 4)."""
    return ("hybrid_ranks", (
        (2, [rank_row(dp=2), rank_row(mp=2),
             rank_row(mp=2, dtype=torch.bfloat16)]),
        (4, [rank_row(dp=2, mp=2)])), {})


# zero: train's cell through each ZeRO level on one NCCL rank, then DGC
ZERO_LEVELS = ("os", "os_g", "p_g_os")
ZERO_STEPS = 3
ZERO_DGC_SPARSITY = 0.999


def run_zero(device, train, hybrid_coll):
    """train's model, batch and recipe on one NCCL rank through fleet.init
    (sharding_degree = 1), annotate_llama_tp, group_sharded_parallel at
    each level and TrainStep(mesh=hcg.get_mesh(), data_axes=("dp",
    "sharding")). At one sharding rank the ZeRO plan is empty (no hook, no
    collective, no copy), so each level's losses equal train's first
    ZERO_STEPS bit for bit and a step issues hybrid's collectives. Then
    fleet.distributed_optimizer under strategy.dgc (a Momentum turned into
    DGCMomentum) beside the plain Momentum, timed."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.hapi import TrainStep
    from paddle_tpu_torch.models.llama import annotate_llama_tp
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import Momentum
    # the phases before leave reference cycles (a DataParallel and its
    # gradient hooks) that hold a model until the collector runs
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = TRAIN_LAYERS * TRAIN_ACCUM * ZERO_STEPS
    counts = {k: 0 for k in TRAIN_KERNELS}
    rows, dgc_rows = [], {}

    def measured(trainer, x, y, what):
        pdist.reset_collective_counts()
        losses, step_s, got, peak = timed_steps(trainer, (x, y), 0,
                                                ZERO_STEPS)
        require(all(math.isfinite(v) for v in losses),
                f"zero {what}: losses {losses}")
        for name in TRAIN_KERNELS:
            require(got[name] == want, f"zero {what}: {name} ran "
                    f"{got[name]} times, want {want}")
            counts[name] += got[name]
        return dict(losses=losses, step_ms=[1e3 * v for v in step_s],
                    step_ms_median=1e3 * float(np.median(step_s)),
                    peak_mem_gb=peak / 1e9,
                    collectives_per_step={
                        k: v / ZERO_STEPS
                        for k, v in pdist.collective_counts().items()},
                    launches={k: got[k] for k in TRAIN_KERNELS})

    one_nccl_rank()
    try:
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                                   "sharding_degree": 1}
        fleet.init(is_collective=True, strategy=strategy)
        mesh = fleet.get_hybrid_communicate_group().get_mesh()
        x = y = None
        for level in ZERO_LEVELS:
            cfg, model = train_model(device, SEED)
            annotate_llama_tp(model)
            trainer = make_trainer(model, 3e-4, steps=TRAIN_STEPS,
                                   grad_accum_steps=TRAIN_ACCUM, mesh=mesh,
                                   level=level, data_axes=("dp", "sharding"))
            if x is None:
                x, y = (t.to(device) for t in token_batch(
                    cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, 5))
            row = measured(trainer, x, y, level)
            require(row["losses"] == train["losses"][:ZERO_STEPS],
                    f"zero {level}: losses {row['losses']} differ from "
                    f"train's {train['losses'][:ZERO_STEPS]}")
            require(row["collectives_per_step"] == hybrid_coll,
                    f"zero {level}: collectives a step "
                    f"{row['collectives_per_step']}, hybrid's "
                    f"{hybrid_coll}")
            rows.append(dict(level=level,
                             resolved_level=trainer.sharding_level,
                             losses_bitwise_equal_train=True, **row))
            del model, trainer
            torch.cuda.empty_cache()
        for name, dgc in (("momentum", False), ("dgc", True)):
            cfg, model = train_model(device, SEED)
            opt = Momentum(3e-4, momentum=0.9,
                           parameters=model.named_parameters(),
                           multi_precision=True,
                           grad_clip=ClipGradByGlobalNorm(1.0))
            st = fleet.DistributedStrategy()
            st.dgc = dgc
            st.dgc_configs = {"rampup_begin_step": 0,
                              "sparsity": [ZERO_DGC_SPARSITY]}
            trainer = TrainStep(model, fleet.distributed_optimizer(
                opt, strategy=st), grad_accum_steps=TRAIN_ACCUM, mesh=mesh,
                data_axes=("dp", "sharding"))
            kind = type(trainer.optimizer).__name__
            require(kind == ("DGCMomentum" if dgc else "Momentum"),
                    f"zero {name}: the optimizer is a {kind}")
            dgc_rows[name] = dict(optimizer=kind,
                                  **measured(trainer, x, y, name))
            del model, trainer, opt
            torch.cuda.empty_cache()
        backend = pdist.get_backend()
    finally:
        pdist.destroy_process_group()
    emit("zero", model="llama2_7b width", layers=TRAIN_LAYERS,
         dtype="bf16, f32 masters", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         grad_accum_steps=TRAIN_ACCUM, steps=ZERO_STEPS, ranks=1,
         backend=backend, degrees=dict(dp=1, sharding=1, mp=1),
         train_losses=train["losses"][:ZERO_STEPS],
         train_step_ms_median=train["step_ms"],
         hybrid_collectives_per_step=hybrid_coll, levels=rows,
         dgc=dict(rampup_begin_step=0, sparsity=ZERO_DGC_SPARSITY,
                  **dgc_rows),
         dgc_over_momentum_step_ms=dgc_rows["dgc"]["step_ms_median"]
         / dgc_rows["momentum"]["step_ms_median"],
         seconds=time.perf_counter() - t0)
    return counts


# zero_ranks: LocalSGD's k
ZERO_LOCALSGD_K = 2


def zero_rank_rows():
    """zero_ranks, ZeRO across ranks: fp32 at sharding = 2 and stages 1-3,
    LocalSGD at dp = 2, then bf16 at stage 1 (one step, for its resting
    memory) and stage 3 (a world of 2); fp32 dp = 2 x sharding = 2 at
    stage 2 (4 x 512 tokens: 2 rows do not split over 4 data ranks) and
    sharding = 2 x mp = 2 at stage 3 (a world of 4). gloo takes a CUDA
    reduce_scatter and all_gather as they are."""
    bf16 = torch.bfloat16
    return ("zero_ranks", (
        (2, [rank_row("os", sharding=2), rank_row("os_g", sharding=2),
             rank_row("p_g_os", sharding=2),
             rank_row(dp=2, localsgd_k=ZERO_LOCALSGD_K),
             rank_row("os", sharding=2, dtype=bf16, steps=1),
             rank_row("p_g_os", sharding=2, dtype=bf16)]),
        (4, [rank_row("os_g", dp=2, sharding=2, batch=4, seq=512),
             rank_row("p_g_os", sharding=2, mp=2)])),
        dict(gloo_cuda_collectives="reduce_scatter and all_gather taken as "
                                   "they are (no all-reduce stand-in)"))


def check_zero_memory(rows):
    """Stage 3's resting memory a rank is below stage 1's."""
    stage = {r["level"]: r for r in rows if r["dtype"] == "bf16"}
    for r in range(2):
        require(stage["p_g_os"]["per_rank_resting_mem_gb"][r]
                < stage["os"]["per_rank_resting_mem_gb"][r],
                f"zero_ranks: rank {r}'s resting memory at stage 3 "
                f"{stage['p_g_os']['per_rank_resting_mem_gb'][r]} GB not "
                f"below stage 1's {stage['os']['per_rank_resting_mem_gb'][r]}")


def pipeline_rank_rows():
    """pipeline_ranks, pipeline parallelism across ranks on the one card:
    fp32 at 7B width, held to the pipe built whole in one process, at pp
    = 2 (2 layers, 2 x 1024 tokens, M = 2) under 1F1B, FThenB and zbh1
    (without remat: W takes the weight gradients from what B kept, so #8
    and #9 run once a layer and microbatch), at V = 2 (4 layers, 4 x 512)
    and bf16 at train's depth, batch and recipe (pp = 2, 1F1B, M = 2, 4
    layers a rank) held to train's losses (a world of 2); pp = 2 x mp = 2
    (tensor_parallel=True) and pp = 2 x dp = 2 with ZeRO-1 over dp at 4 x
    512 (a world of 4)."""
    pipe = dict(pp=2, micro=2)
    fp32 = dict(layers=PIPE_RANK_LAYERS, **pipe)
    return ("pipeline_ranks", (
        (2, [rank_row(**fp32), rank_row(schedule="FThenB", **fp32),
             rank_row(schedule="zbh1", remat=False, **fp32),
             rank_row(V=2, layers=4, batch=4, seq=512, **pipe),
             rank_row(dtype=torch.bfloat16, **pipe)]),
        (4, [rank_row(mp=2, **fp32),
             rank_row(dp=2, zero=1, batch=4, seq=512, **fp32)])),
        dict(p2p="gloo with CUDA tensors staged through pinned host memory "
                 "(p2p_host_staged in each row's collectives)"))


# ring_ranks, ep_ranks and the sp_recompute pair: this slice's rows in the
# same gloo worlds (rank_body dispatches a row with a "kind" to
# CTX_ROWS[kind]). The ring rows run Llama-2-7B's attention (and one row
# at Llama-2-70B's GQA heads) over RING_S tokens, each rank on its
# contiguous chunk, and each rank holds its chunk of out and of the
# gradients to the whole sequence's flash_attention_bshd in its own
# process on the card; the ep rows train MoEGPTConfig() at 2 layers and
# are held to one process on the same rows.
RING_B, RING_S = 1, 16384
# max|ring - whole| / max|whole| for out, dq, dk, dv: the ring merges
# partial softmaxes in f32 (in bf16 each unit's output is rounded before
# the merge, and q's gradient sums P units' bf16 gradients)
RING_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
EP_LAYERS, EP_BATCH, EP_SEQ, EP_STEPS = 2, 4, 1024, 3
EP_MAIN_LAYERS = 4
SP_SEQ = 4096
SP_TOL = 1e-4             # fp32, max|a-b| / max|b|: mp splits the sums


def ring_units(p, r, causal, zigzag):
    """The chunk attentions (one #7, #8 and #9 launch each) rank r of p
    runs in a ring, from its schedule: r + 1 contiguous and causal, p not
    causal, 2p + 1 half-chunk units in zigzag order on every rank."""
    n = 0
    for i in range(p):
        src = (r - i) % p
        if zigzag:
            n += int(src <= r) + 1 + int(src >= r)
        else:
            n += int(not causal or src <= r)
    return n


def ring_row(sep, method, causal, dtype, heads=32, kv_heads=32,
             layout="zigzag"):
    """A ring_ranks row; ``layout`` of a causal ring: "zigzag" (through
    sep_scaled_dot_product_attention) or "contiguous"."""
    if method == "ulysses":
        layout = "ulysses"
    elif not causal:
        layout = "full"
    return dict(kind="ring", sep=sep, causal=causal, dtype=dtype,
                heads=heads, kv_heads=kv_heads, layout=layout)


def ring_rank_rows():
    """ring_ranks: Llama-2-7B's attention (32 heads of 128) over 16384
    tokens, B = 1: the ring contiguous causal at sep = 2 (the entry's
    zigzag order bypassed: ring_flash_attention on the contiguous chunks),
    not causal at sep = 2, zigzag causal at sep = 4 (through
    sep_scaled_dot_product_attention), Ulysses at sep = 4 with the flash
    kernel as attn_fn, and the zigzag ring at 70B's heads (64 over 8) at
    sep = 4; each fp32 and bf16, forward and backward."""
    two, four = [], []
    for dtype in (torch.float32, torch.bfloat16):
        two += [ring_row(2, "ring", True, dtype, layout="contiguous"),
                ring_row(2, "ring", False, dtype)]
        four += [ring_row(4, "ring", True, dtype),
                 ring_row(4, "ulysses", True, dtype),
                 ring_row(4, "ring", True, dtype, 64, 8)]
    return ("ring_ranks", ((2, two), (4, four)),
            dict(check=check_ring_worlds,
                 transfers="ring rotations and the zigzag exchange through "
                           "pp_utils' Wire (gloo: pinned host staging); "
                           "Ulysses through all_to_all_single"))


def ring_body(rank, row, device):
    """This rank's ring (or Ulysses) attention on its contiguous chunk of
    the seeded global q / k / v and the backward of sum(out * do), timed,
    its #7-#9 launches and transfers counted; then the whole sequence's
    flash_attention_bshd and its gradients in this process, and the error
    of this rank's chunks against them."""
    import functools
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.distributed.fleet import base_topology as topo
    from paddle_tpu_torch.distributed.fleet.utils import (
        ring_flash_attention as ring)
    from paddle_tpu_torch.kernels.flash_attention import flash_attention_bshd
    hcg = topo.create_hybrid_communicate_group(sep_degree=row["sep"])
    p, r = row["sep"], hcg.get_sep_parallel_rank()
    dtype, causal = row["dtype"], row["causal"]
    h, hkv = row["heads"], row["kv_heads"]
    gen = torch.Generator(device=device).manual_seed(SEED + 51)
    q = _rand(gen, (RING_B, RING_S, h, HEAD_DIM), dtype, device)
    k = _rand(gen, (RING_B, RING_S, hkv, HEAD_DIM), dtype, device)
    v = _rand(gen, (RING_B, RING_S, hkv, HEAD_DIM), dtype, device)
    do = _rand(gen, (RING_B, RING_S, h, HEAD_DIM), dtype, device)
    c = RING_S // p
    mine = [t[:, r * c:(r + 1) * c].clone().requires_grad_(True)
            for t in (q, k, v)]
    torch.cuda.synchronize()
    pdist.barrier(hcg.get_sep_parallel_group())
    kernels.reset_launches()
    pdist.reset_collective_counts()
    t0 = time.perf_counter()
    if row["layout"] == "ulysses":
        out = ring.ulysses_attention(
            *mine, hcg, causal, attn_fn=functools.partial(
                flash_attention_bshd, causal=causal), attn_fn_gqa=True)
    elif row["layout"] == "contiguous":
        out = ring.ring_flash_attention(*mine, hcg, causal)
    else:
        out = ring.sep_scaled_dot_product_attention(*mine, hcg, "ring",
                                                    causal)
    torch.autograd.backward(out, do[:, r * c:(r + 1) * c])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {n: kernels.launch_counts()[n] for n in TRAIN_KERNELS}
    coll = pdist.collective_counts()
    whole = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = flash_attention_bshd(*whole, causal=causal)
    torch.autograd.backward(ref, do)
    errs = {}
    for name, got, want in (("out", out, ref), ("dq", mine[0].grad,
                                                 whole[0].grad),
                            ("dk", mine[1].grad, whole[1].grad),
                            ("dv", mine[2].grad, whole[2].grad)):
        want = want.detach()[:, r * c:(r + 1) * c].float()
        errs[name] = max_err(got, want) / float(want.abs().max())
    units = (1 if row["layout"] == "ulysses" else
             ring_units(p, r, causal, row["layout"] == "zigzag"))
    topo._reset_hcg()
    del q, k, v, do, mine, whole, out, ref
    torch.cuda.empty_cache()
    return dict(errs=errs, max_rel_err=max(errs.values()),
                launches=counts, want_launches={n: units
                                                for n in TRAIN_KERNELS},
                collectives=coll, seconds=seconds), None


def check_ring_worlds(phase, worlds):
    """Every ring row on every rank within RING_TOL of the whole sequence
    and #7-#9 launched once a unit: (rows, the launches summed)."""
    rows, counts = [], {k: 0 for k in TRAIN_KERNELS}
    for n, world_rows, results in worlds:
        for i, spec in enumerate(world_rows):
            per_rank = [res[i] for res in results]
            what = (f"{phase} {DTYPE_NAME[spec['dtype']]} {spec['layout']} "
                    f"sep={spec['sep']} causal={spec['causal']} "
                    f"H={spec['heads']}/{spec['kv_heads']}")
            for r, got in enumerate(per_rank):
                require(got["max_rel_err"] <= RING_TOL[spec["dtype"]],
                        f"{what} rank {r}: {got['errs']} over "
                        f"{RING_TOL[spec['dtype']]}")
                require(got["launches"] == got["want_launches"],
                        f"{what} rank {r}: launches {got['launches']}, "
                        f"want {got['want_launches']}")
                for name in TRAIN_KERNELS:
                    counts[name] += got["launches"][name]
            rows.append(dict(
                ranks=n, dtype=DTYPE_NAME[spec["dtype"]],
                **{k: spec[k] for k in ("sep", "layout", "causal", "heads",
                                        "kv_heads")},
                B=RING_B, S=RING_S, D=HEAD_DIM, tol=RING_TOL[spec["dtype"]],
                max_rel_err=max(g["max_rel_err"] for g in per_rank),
                per_rank_errs=[g["errs"] for g in per_rank],
                per_rank_launches=[g["launches"]["flash_attention_fwd"]
                                   for g in per_rank],
                per_rank_seconds=[g["seconds"] for g in per_rank],
                per_rank_row_s=[g["row_s"] for g in per_rank],
                collectives=per_rank[0]["collectives"]))
    return rows, counts


def ep_row(dp, dtype=torch.float32, expert_axis="dp"):
    return dict(kind="ep", dp=dp, dtype=dtype, expert_axis=expert_axis)


def ep_rank_rows():
    """ep_ranks: MoEGPTConfig() widths at EP_LAYERS layers (a dense block
    and an MoE block), EP_BATCH x EP_SEQ tokens a step, EP_STEPS steps of
    make_trainer's recipe through TrainStep(mesh=...): fp32 at dp = 2
    without expert parallelism (the global routing), with expert_axis="dp"
    at dp = 2 (4 experts a rank) and dp = 4 (2), and bf16 EP at dp = 2."""
    return ("ep_ranks", (
        (2, [ep_row(2, expert_axis=None), ep_row(2),
             ep_row(2, torch.bfloat16)]),
        (4, [ep_row(4)])), dict(check=check_ep_worlds))


def _expert_whole(model, hcg, specs):
    """Every parameter whole on this rank (the expert slices all-gathered
    over dp), and how many replicated ones differ from dp rank 0's."""
    from paddle_tpu_torch import distributed as pdist
    dp = hcg.get_data_parallel_group()
    whole, unequal = {}, 0
    fingerprints = []
    with torch.no_grad():
        for k, p in model.named_parameters():
            if dp.nranks > 1 and "dp" in tuple(specs.get(k) or ()):
                parts = []
                pdist.all_gather(parts, p.detach().contiguous(), group=dp)
                whole[k] = torch.cat(parts, dim=0)
            else:
                whole[k] = p.detach()
                fingerprints.append(_fingerprint(p.float()))
        if dp.nranks > 1 and fingerprints:
            mine = torch.stack(fingerprints)
            first = mine.clone()
            pdist.broadcast(first, dp.ranks[0], group=dp)
            unequal = int((first != mine).sum())
    return whole, unequal


def ep_body(rank, row, device):
    """One ep_ranks row on this rank: the seeded MoE-GPT (the whole expert
    stack drawn, then cut by the step), its steps, launches, collectives
    and memory; the parameters gathered whole."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed.fleet import base_topology as topo
    hcg = topo.create_hybrid_communicate_group(dp_degree=row["dp"])
    cfg, model = moe_model(device, dtype=row["dtype"], layers=EP_LAYERS,
                           seed_offset=61, expert_axis=row["expert_axis"])
    trainer = make_trainer(model, HYBRID_RANK_LR, steps=EP_STEPS,
                           mesh=hcg.get_mesh())
    x, y = (t.to(device) for t in token_batch(cfg.vocab_size, EP_BATCH,
                                              EP_SEQ, 61))
    pdist.reset_collective_counts()
    losses, step_s, counts, peak = timed_steps(trainer, (x, y), 0, EP_STEPS)
    specs = dict(trainer._plan.param_specs)
    got = dict(losses=losses, step_ms=[1e3 * v for v in step_s],
               launches={k: counts[k] for k in TRAIN_KERNELS},
               want_launches={k: EP_LAYERS * EP_STEPS
                              for k in TRAIN_KERNELS},
               collectives=pdist.collective_counts(),
               experts_here=[b.moe.experts.w1.shape[0] for b in model.h
                             if hasattr(b, "moe")],
               peak_mem_gb=peak / 1e9)
    del trainer, x, y
    params = None
    if row["dtype"] == torch.float32:
        params, got["replicas_unequal"] = _expert_whole(model, hcg, specs)
    topo._reset_hcg()
    del model
    torch.cuda.empty_cache()
    return got, params


def ep_reference(row, got, params, device):
    """The ep row's steps in one process (no mesh, every expert here) on
    the same seed and rows: the losses' relative error, and an fp32 row's
    gathered parameters against its parameters."""
    cfg, model = moe_model(device, dtype=row["dtype"], layers=EP_LAYERS,
                           seed_offset=61)
    trainer = make_trainer(model, HYBRID_RANK_LR, steps=EP_STEPS)
    x, y = (t.to(device) for t in token_batch(cfg.vocab_size, EP_BATCH,
                                              EP_SEQ, 61))
    ref = [float(trainer(x, y)) for _ in range(EP_STEPS)]
    got["one_rank_losses"] = ref
    got["loss_rel_err"] = max(abs(a - b) / abs(b)
                              for a, b in zip(got["losses"], ref))
    if params is not None:
        off = total = 0
        worst = 0.0
        for name, p in model.named_parameters():
            diff = (params[name].to(device).double()
                    - p.detach().double()).abs()
            worst = max(worst, float(diff.max()))
            off += int((diff > HYBRID_PARAM_TOL).sum())
            total += diff.numel()
        got.update(param_max_abs_err=worst, params_off=off,
                   params_total=total,
                   param_names_equal=sorted(params) == sorted(
                       dict(model.named_parameters())))
    del trainer, model, x, y
    torch.cuda.empty_cache()


def check_ep_worlds(phase, worlds):
    """Every rank's losses equal, #7-#9 launched a layer a step, E / P
    experts a rank under EP; fp32 rows within HYBRID_LOSS_RTOL of one
    process and their parameters as the hybrid rows' (replicas equal bit
    for bit); the bf16 row within BF16_RANK_LOSS_RTOL of one process."""
    rows, counts = [], {k: 0 for k in TRAIN_KERNELS}
    for n, world_rows, results in worlds:
        for i, spec in enumerate(world_rows):
            per_rank = [res[i] for res in results]
            row = dict(per_rank[0])
            what = (f"{phase} {DTYPE_NAME[spec['dtype']]} dp={spec['dp']} "
                    f"expert_axis={spec['expert_axis']}")
            want_here = 8 // spec["dp"] if spec["expert_axis"] else 8
            for r, got in enumerate(per_rank):
                require(got["losses"] == row["losses"],
                        f"{what}: rank {r}'s losses differ")
                require(got["launches"] == got["want_launches"],
                        f"{what} rank {r}: launches {got['launches']}")
                require(got["experts_here"] == [want_here],
                        f"{what} rank {r}: experts {got['experts_here']}")
                for name in TRAIN_KERNELS:
                    counts[name] += got["launches"][name]
            require(all(math.isfinite(v) for v in row["losses"])
                    and row["losses"][-1] < row["losses"][0],
                    f"{what}: losses {row['losses']}")
            if spec["dtype"] == torch.float32:
                require(row["loss_rel_err"] <= HYBRID_LOSS_RTOL,
                        f"{what}: loss rel err {row['loss_rel_err']}")
                require(row["param_names_equal"]
                        and all(g["replicas_unequal"] == 0
                                for g in per_rank),
                        f"{what}: gathered parameters")
                require(row["param_max_abs_err"] <= 3 * HYBRID_RANK_LR
                        and row["params_off"]
                        <= HYBRID_PARAM_OFF_FRAC * row["params_total"],
                        f"{what}: {row['params_off']} elements beyond "
                        f"{HYBRID_PARAM_TOL}, worst "
                        f"{row['param_max_abs_err']}")
            else:
                require(row["loss_rel_err"] <= BF16_RANK_LOSS_RTOL,
                        f"{what}: losses {row['losses']} vs one process's "
                        f"{row['one_rank_losses']}")
            row.update(ranks=n, dtype=DTYPE_NAME[spec["dtype"]],
                       dp=spec["dp"], expert_axis=spec["expert_axis"],
                       layers=EP_LAYERS, batch=EP_BATCH, seq=EP_SEQ,
                       per_rank_step_ms=[g["step_ms"] for g in per_rank],
                       per_rank_row_s=[g["row_s"] for g in per_rank],
                       per_rank_peak_mem_gb=[g["peak_mem_gb"]
                                             for g in per_rank])
            rows.append(row)
    return rows, counts


def sp_rank_rows():
    """sp_recompute's rank row: a Column -> RowSequenceParallelLinear pair
    at Llama-2-7B's MLP widths (4096 -> 11008 -> 4096) over SP_SEQ tokens
    at mp = 2, fp32."""
    return ("sp_recompute", ((2, [dict(kind="sp", dtype=torch.float32)]),),
            dict(check=check_sp_worlds, part="sequence-parallel linears"))


def sp_body(rank, row, device):
    """The pair on this rank's sequence slice (the seeded whole weights
    cut to its shards, the row bias all-reduced by the hooks), the
    backward of sum(out * g); held to the same layers on the whole
    sequence in this process."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed.fleet import base_topology as topo
    from paddle_tpu_torch.distributed.fleet.utils import \
        sequence_parallel_utils as sp
    hcg = topo.create_hybrid_communicate_group(mp_degree=2)
    n, r = 2, hcg.get_model_parallel_rank()
    gen = torch.Generator(device=device).manual_seed(SEED + 71)
    w1 = _rand(gen, (HIDDEN, INTER), torch.float32, device, 0.02)
    b1 = _rand(gen, (INTER,), torch.float32, device, 0.02)
    w2 = _rand(gen, (INTER, HIDDEN), torch.float32, device, 0.02)
    b2 = _rand(gen, (HIDDEN,), torch.float32, device, 0.02)
    x = _rand(gen, (SP_SEQ, 1, HIDDEN), torch.float32, device)
    g = _rand(gen, (SP_SEQ, 1, HIDDEN), torch.float32, device)
    col = sp.ColumnSequenceParallelLinear(HIDDEN, INTER, device=device)
    rowl = sp.RowSequenceParallelLinear(INTER, HIDDEN, device=device)
    with torch.no_grad():
        col.weight.copy_(w1.chunk(n, 1)[r])
        col.bias.copy_(b1.chunk(n)[r])
        rowl.weight.copy_(w2.chunk(n, 0)[r])
        rowl.bias.copy_(b2)
    hooks = sp.register_sequence_parallel_allreduce_hooks(
        torch.nn.ModuleList([col, rowl]))
    s = SP_SEQ // n
    xl = x[r * s:(r + 1) * s].clone().requires_grad_(True)
    torch.cuda.synchronize()
    pdist.reset_collective_counts()
    t0 = time.perf_counter()
    out = rowl(col(xl))
    torch.autograd.backward(out, g[r * s:(r + 1) * s])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    coll = pdist.collective_counts()
    whole = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    ref = (whole[0] @ whole[1] + whole[2]) @ whole[3] + whole[4]
    torch.autograd.backward(ref, g)
    errs = {}
    for name, got, want in (
            ("out", out, ref[r * s:(r + 1) * s]),
            ("dx", xl.grad, whole[0].grad[r * s:(r + 1) * s]),
            ("col.weight", col.weight.grad, whole[1].grad.chunk(n, 1)[r]),
            ("col.bias", col.bias.grad, whole[2].grad.chunk(n)[r]),
            ("row.weight", rowl.weight.grad, whole[3].grad.chunk(n, 0)[r]),
            ("row.bias", rowl.bias.grad, whole[4].grad)):
        want = want.detach()
        errs[name] = max_err(got, want) / float(want.abs().max())
    for hk in hooks:
        hk.remove()
    topo._reset_hcg()
    del x, g, w1, w2, whole, ref, out, col, rowl, xl
    torch.cuda.empty_cache()
    return dict(errs=errs, max_rel_err=max(errs.values()), hooks=len(hooks),
                collectives=coll, seconds=seconds), None


def check_sp_worlds(phase, worlds):
    rows = []
    for n, world_rows, results in worlds:
        for i, _ in enumerate(world_rows):
            per_rank = [res[i] for res in results]
            for r, got in enumerate(per_rank):
                require(got["max_rel_err"] <= SP_TOL and got["hooks"] == 1,
                        f"{phase} rank {r}: {got['errs']} over {SP_TOL}")
            rows.append(dict(ranks=n, mp=n, dtype="fp32", seq=SP_SEQ,
                             widths=[HIDDEN, INTER, HIDDEN], tol=SP_TOL,
                             max_rel_err=max(g["max_rel_err"]
                                             for g in per_rank),
                             per_rank_errs=[g["errs"] for g in per_rank],
                             per_rank_seconds=[g["seconds"]
                                               for g in per_rank],
                             per_rank_row_s=[g["row_s"] for g in per_rank],
                             collectives=per_rank[0]["collectives"]))
    return rows, {}


CTX_ROWS = {"ring": ring_body, "ep": ep_body, "sp": sp_body}
CTX_REFERENCES = {"ep": ep_reference}


def run_ep(device):
    """ep: MoEGPTConfig() widths at EP_MAIN_LAYERS layers, bf16, with
    expert_axis="dp", through fleet.init (dp = 1) and TrainStep(mesh=
    hcg.get_mesh()) on one NCCL rank, EP_STEPS steps of MOE_BATCH x MOE_SEQ
    tokens: the losses equal the same model's plain TrainStep bit for bit
    (at one rank the routing is local and no all-to-all runs), #7-#9
    launched a layer a step."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed import fleet
    one_nccl_rank()
    try:
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": 1}
        fleet.init(is_collective=True, strategy=strategy)
        hcg = fleet.get_hybrid_communicate_group()
        cfg, model = moe_model(device, layers=EP_MAIN_LAYERS,
                               expert_axis="dp")
        trainer = make_trainer(model, 3e-4, steps=EP_STEPS,
                               mesh=hcg.get_mesh())
        x, y = (t.to(device) for t in token_batch(
            cfg.vocab_size, MOE_BATCH, MOE_SEQ, 21))
        pdist.reset_collective_counts()
        losses, step_s, counts, peak = timed_steps(trainer, (x, y), 0,
                                                   EP_STEPS)
        coll = pdist.collective_counts()
        specs = trainer._plan.param_specs
    finally:
        pdist.destroy_process_group()
    del trainer, model
    torch.cuda.empty_cache()
    _, plain_model = moe_model(device, layers=EP_MAIN_LAYERS)
    plain = make_trainer(plain_model, 3e-4, steps=EP_STEPS)
    plain_losses, plain_s, _, _ = timed_steps(plain, (x, y), 0, EP_STEPS)
    require(losses == plain_losses, f"ep: losses {losses} differ from the "
            f"plain step's {plain_losses}")
    want = EP_MAIN_LAYERS * EP_STEPS
    for name in TRAIN_KERNELS:
        require(counts[name] == want,
                f"ep: {name} ran {counts[name]} times, want {want}")
    emit("ep", model="MoEGPTConfig() (GPT-3 345M widths, 8 experts, top-2, "
         "MoE every 2nd block), expert_axis='dp'", layers=EP_MAIN_LAYERS,
         dtype="bf16, f32 masters", batch=MOE_BATCH, seq=MOE_SEQ,
         steps=EP_STEPS, ranks=1, losses=losses,
         losses_bitwise_equal_plain=True,
         expert_specs={k: v for k, v in specs.items() if ".experts." in k},
         step_ms=[1e3 * v for v in step_s],
         plain_step_ms=[1e3 * v for v in plain_s],
         collectives_per_step={k: v / EP_STEPS for k, v in coll.items()},
         peak_mem_gb=peak / 1e9, launches=counts)
    del plain, plain_model, x, y
    torch.cuda.empty_cache()
    return counts


def run_sp_recompute(device):
    """sp_recompute's one-rank part: fleet.utils.recompute around each
    decoder layer of the 7B-width Llama at 2 layers (bf16), one forward
    and backward of 1 x TRAIN_SEQ tokens: the gradients equal the same
    model's without it bit for bit, #7 launched twice a layer (#8, #9
    once), and less memory added at the peak."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.distributed.fleet.utils import recompute
    cfg, model = train_model(device, SEED, layers=2)
    x, y = (t.to(device) for t in token_batch(cfg.vocab_size, 1, TRAIN_SEQ,
                                              5))
    layers = list(model.llama.layers)

    def run():
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        loss = model(x, y)
        loss.backward()
        torch.cuda.synchronize()
        return (float(loss), {k: p.grad.clone()
                              for k, p in model.named_parameters()},
                kernels.launch_counts(),
                torch.cuda.max_memory_allocated() - base)

    loss_plain, ref, _, plain_added = run()
    for layer in layers:
        layer.forward = (lambda *a, _f=layer.forward: recompute(_f, *a))
    try:
        loss_rc, grads, counts, rc_added = run()
    finally:
        for layer in layers:
            del layer.forward
    unequal = [k for k, g in grads.items() if not torch.equal(g, ref[k])]
    require(not unequal and loss_rc == loss_plain,
            f"sp_recompute: gradients differ without recompute: {unequal}")
    n = len(layers)
    require(counts["flash_attention_fwd"] == 2 * n
            and counts["flash_attention_bwd_dq"] == n
            and counts["flash_attention_bwd_dkv"] == n,
            f"sp_recompute: launches {counts}")
    require(rc_added < plain_added, f"sp_recompute: {rc_added / 1e9} GB "
            f"added, without recompute {plain_added / 1e9}")
    emit("sp_recompute", part="fleet.utils.recompute",
         model="llama2_7b width", layers=n, dtype="bf16", batch=1,
         seq=TRAIN_SEQ, grads_bitwise_equal=True, loss=loss_rc,
         fwd_bwd_added_gb=rc_added / 1e9,
         fwd_bwd_added_gb_without=plain_added / 1e9, launches=counts)
    del model, ref, grads, x, y
    torch.cuda.empty_cache()
    return {k: counts[k] for k in TRAIN_KERNELS}


def run_rank_phases(train):
    """hybrid_ranks, zero_ranks, pipeline_ranks, ring_ranks, ep_ranks and
    sp_recompute's rank row through run_ranks: {phase: the launches
    summed}."""
    done = run_ranks([hybrid_rank_rows(), zero_rank_rows(),
                      pipeline_rank_rows(), ring_rank_rows(),
                      ep_rank_rows(), sp_rank_rows()], train)
    check_zero_memory(done["zero_ranks"][1])
    return {phase: counts for phase, (counts, _) in done.items()}


def fit_recipe(device, layers, model_seed):
    """fit's recipe: the model (7B width, ``layers`` layers) decorated by
    amp (O2, bf16, no f32 masters), AdamW over two parameter groups
    (embedding and head at half the rate), no decay on the norms,
    LinearWarmup(CosineAnnealingDecay), global-norm clip,
    LlamaPretrainingCriterion and a DataLoader factory over FIT_ROWS seeded
    rows. Returns (cfg, model, optimizer, criterion, loader factory)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.models import LlamaPretrainingCriterion
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)
    cfg, model = train_model(device, model_seed, dtype=torch.float32,
                             layers=layers)
    outer = ("llama.embed_tokens.weight", "lm_head.weight")
    named = list(model.named_parameters())
    opt = AdamW(LinearWarmup(CosineAnnealingDecay(3e-4, T_max=FIT_STEPS),
                             warmup_steps=2, start_lr=3e-5, end_lr=3e-4),
                parameters=[
                    {"params": [e for e in named if e[0] in outer],
                     "learning_rate": 0.5},
                    {"params": [e for e in named if e[0] not in outer]}],
                weight_decay=0.01,
                apply_decay_param_fun=lambda n: "norm" not in n,
                grad_clip=ClipGradByGlobalNorm(1.0))
    # bf16 parameters without f32 masters: the reference's ModelCheckpoint
    # saves twice (epoch 0 and the end), and with masters the two saves
    # would write 52.7 GB, past the 45 GiB a chip call may write
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16",
                              master_weight=False)
    require(all(p.dtype == torch.bfloat16 for p in model.parameters())
            and not opt._multi_precision, "fit: amp.decorate O2")
    crit = LlamaPretrainingCriterion(cfg)
    x, y = token_batch(cfg.vocab_size, FIT_ROWS, TRAIN_SEQ, 7)
    data = TensorDataset([x, y])

    def loader():
        return DataLoader(data, batch_size=FIT_BATCH, shuffle=True,
                          seed=SEED + 31)
    return cfg, model, opt, crit, loader


def run_fit(device):
    """The slice's main path: Model.fit over a DataLoader on fit_recipe's
    model, optimizer and criterion; batches prefetched to the card; the
    LRScheduler, EarlyStopping and ModelCheckpoint callbacks."""
    import shutil
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.hapi import Model, TrainStep
    from paddle_tpu_torch.hapi.callbacks import (Callback, EarlyStopping,
                                                 LRScheduler,
                                                 ModelCheckpoint)
    from paddle_tpu_torch.optimizer import AdamW
    cfg, model, opt, crit, loader = fit_recipe(device, FIT_LAYERS,
                                               SEED + 21)

    # the reference: a bare TrainStep's loss on the loader's first batch,
    # on a copy of the same weights
    first = next(iter(loader()))
    twin = copy.deepcopy(model)
    bare = TrainStep(twin, AdamW(3e-4, parameters=twin.named_parameters()),
                     loss_fn=crit, grad_accum_steps=FIT_ACCUM)
    ref_loss = float(bare.compute_loss_grads(*(t.to(device)
                                               for t in first))[0])
    del twin, bare
    torch.cuda.empty_cache()

    class Record(Callback):
        """Each step's logs; the host's clock and a CUDA event on the
        card's stream at each step's start and at the epoch's end (after
        its sync)."""

        def __init__(self):
            super().__init__()
            self.logs, self.begin, self.events = [], [], []

        def _mark(self):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            return time.perf_counter()

        def on_train_batch_begin(self, step, logs=None):
            self.begin.append(self._mark())

        def on_train_batch_end(self, step, logs=None):
            self.logs.append(dict(logs))

        def on_epoch_end(self, epoch, logs=None):
            self.end = self._mark()
            self.epoch_loss = logs.get("loss")

    shutil.rmtree(FIT_CKPT_DIR, ignore_errors=True)
    os.makedirs(FIT_CKPT_DIR, exist_ok=True)
    disk_free_gb = shutil.disk_usage(FIT_CKPT_DIR).free / 1e9
    rec = Record()
    ckpt = ModelCheckpoint(save_freq=1, save_dir=FIT_CKPT_DIR)
    fitted = Model(model)
    fitted.prepare(opt, loss=crit)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    fitted.fit(loader(), epochs=1, accumulate_grad_batches=FIT_ACCUM,
               metrics_every=FIT_METRICS_EVERY, num_iters=FIT_STEPS,
               prefetch_to_device=True, verbose=0,
               callbacks=[rec, LRScheduler(), EarlyStopping(patience=2),
                          ckpt])
    fit_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_obj = fitted._train_step
    losses = {r["loss_step"]: r["loss"] for r in rec.logs
              if r.get("loss") is not None}
    require(len(rec.logs) == FIT_STEPS, f"fit ran {len(rec.logs)} steps")
    require(all(math.isfinite(v) for v in losses.values())
            and math.isfinite(rec.epoch_loss), f"fit losses {losses}")
    require(losses.get(0) == ref_loss, f"fit: first loss {losses.get(0)} "
            f"!= a bare TrainStep's {ref_loss}")
    micro = FIT_LAYERS * FIT_ACCUM * FIT_STEPS
    for name in TRAIN_KERNELS:
        require(counts[name] == micro, f"fit: {name} ran {counts[name]} "
                f"times, want {micro}")
    # the checkpoint loads back into a fresh model with equal parameters
    _, fresh = train_model(device, SEED + 22, layers=FIT_LAYERS)
    Model(fresh).load(os.path.join(FIT_CKPT_DIR, "final"),
                      reset_optimizer=True)
    torch.cuda.synchronize()
    differ = [n for (n, a), b in zip(model.named_parameters(),
                                     fresh.parameters())
              if not torch.equal(a, b)]
    require(not differ, f"fit: checkpoint parameters differ: {differ[:3]}")
    ckpt_bytes = sum(os.path.getsize(os.path.join(FIT_CKPT_DIR, f))
                     for f in os.listdir(FIT_CKPT_DIR))
    ckpt_gb = ckpt_bytes / 1e9
    del fresh
    shutil.rmtree(FIT_CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    # steps 1.. of fit (the first also makes the optimizer state) on the
    # card's clock: from the event queued at step 1's start (it fires when
    # step 0's work is done) to the epoch's end; then a bare TrainStep
    # loop over the same batches staged on the card, timed the same way
    fit_ms = rec.events[1].elapsed_time(rec.events[-1]) / (FIT_STEPS - 1)
    gaps = np.diff(rec.begin) * 1e3
    batches = [tuple(t.to(device) for t in b) for _, b in zip(
        range(FIT_STEPS), loader())]
    loop = TrainStep(model, opt, loss_fn=crit, grad_accum_steps=FIT_ACCUM,
                     metrics_every=FIT_METRICS_EVERY)
    loop(*batches[0])
    loop.sync()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for b in batches[1:]:
        loop(*b)
    loop.sync()
    end.record()
    end.synchronize()
    bare_ms = start.elapsed_time(end) / (FIT_STEPS - 1)
    tokens = FIT_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, FIT_BATCH)
    emit("fit", model="llama2_7b width", layers=FIT_LAYERS,
         dtype="bf16 (amp O2), no masters", rows=FIT_ROWS,
         batch=FIT_BATCH, seq=TRAIN_SEQ, accumulate_grad_batches=FIT_ACCUM,
         metrics_every=FIT_METRICS_EVERY, steps=FIT_STEPS,
         losses={str(k): v for k, v in sorted(losses.items())},
         epoch_loss=rec.epoch_loss, first_loss=losses[0],
         bare_trainstep_first_loss=ref_loss,
         step_ms=fit_ms, host_gap_ms=[float(g) for g in gaps],
         bare_trainstep_step_ms=bare_ms, fit_overhead_ms=fit_ms - bare_ms,
         tokens_per_s=tokens / (fit_ms / 1e3),
         mfu_vs_989_tflops=flops / (fit_ms / 1e3) / PEAK_FLOPS[
             torch.bfloat16],
         host_wait_share=step_obj.wait_s / (rec.end - rec.begin[0]),
         host_wait_s=step_obj.wait_s, pulls=step_obj.sync_count,
         peak_mem_gb=peak / 1e9, fit_s=fit_s, checkpoint_gb=ckpt_gb,
         checkpoint_bytes=ckpt_bytes,
         disk_free_gb=disk_free_gb, launches=counts)
    del model, opt, fitted, loop, batches
    torch.cuda.empty_cache()
    return counts


# -------------------------------------------------------------------- io
IO_WORKERS, IO_ROUNDS, IO_RATE_ROWS = 4, 48, 64
# each worker's site counts its own batches: with 8 batches over 4
# workers, every=2 kills each worker at its second
IO_FAULT_SPEC, IO_MAX_RESTARTS = "dataloader_worker:every=2", 8


class TokenRows:
    """A map-style dataset of ``n`` token rows whose __getitem__ runs a
    GIL-bound pure-Python transform: IO_ROUNDS passes of a position-mixed
    LCG over the row's TRAIN_SEQ + 1 seeded tokens (tens of ms a row);
    returns (inputs, labels) int64 numpy rows."""

    def __init__(self, vocab, n=FIT_ROWS):
        rng = np.random.default_rng(SEED + 51)
        self.vocab = vocab
        self.base = rng.integers(0, vocab, (n, TRAIN_SEQ + 1)).tolist()

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        toks = self.base[i]
        for r in range(IO_ROUNDS):
            toks = [(t * 1103515245 + 12345 + j * r) % self.vocab
                    for j, t in enumerate(toks)]
        a = np.asarray(toks, np.int64)
        return a[:-1], a[1:]


class Tap:
    """An iterable over ``loader`` that keeps a host copy of each batch."""

    def __init__(self, loader):
        self.loader, self.batches = loader, []

    def __iter__(self):
        for b in self.loader:
            self.batches.append(tuple(t.clone() for t in b))
            yield b


def io_fit(device, choose):
    """Model.fit over the loader ``choose(fit_recipe's loader factory)``
    returns (tapped), on fit_recipe's model, one epoch, the loss read every
    step. Returns (the loader, losses, the batches' inputs, fit step ms on
    the card's clock from step 1, a bare TrainStep's step ms over the same
    batches staged on the card, launch counts)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.hapi import Model, TrainStep
    from paddle_tpu_torch.hapi.callbacks import Callback
    _, model, opt, crit, factory = fit_recipe(device, FIT_LAYERS, SEED + 41)
    loader = choose(factory)

    class Record(Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.events = [], []

        def on_train_batch_begin(self, step, logs=None):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs.get("loss"))

        def on_epoch_end(self, epoch, logs=None):
            self.on_train_batch_begin(None)

    rec, tap = Record(), Tap(loader)
    fitted = Model(model)
    fitted.prepare(opt, loss=crit)
    torch.cuda.synchronize()
    kernels.reset_launches()
    fitted.fit(tap, epochs=1, metrics_every=1, verbose=0, callbacks=[rec])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    steps = len(rec.losses)
    fit_ms = rec.events[1].elapsed_time(rec.events[-1]) / (steps - 1)
    batches = [tuple(t.to(device) for t in b) for b in tap.batches]
    loop = TrainStep(model, opt, loss_fn=crit)
    loop(*batches[0])
    loop.sync()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for b in batches[1:]:
        loop(*b)
    loop.sync()
    end.record()
    end.synchronize()
    bare_ms = start.elapsed_time(end) / (steps - 1)
    del model, opt, fitted, loop, batches
    torch.cuda.empty_cache()
    return (loader, rec.losses, [b[0] for b in tap.batches], fit_ms, bare_ms,
            counts)


def loader_rate(loader) -> dict:
    """One epoch of ``loader`` alone: rows a second over the epoch, the
    seconds to its first batch (worker start-up included), and rows a
    second after the first batch."""
    t0 = time.perf_counter()
    n = first = 0
    for b in loader:
        n += len(b[0])
        if not first:
            first, t1 = n, time.perf_counter()
    t2 = time.perf_counter()
    return dict(samples_per_s=n / (t2 - t0), first_batch_s=t1 - t0,
                steady_samples_per_s=(n - first) / (t2 - t1))


def run_io(device) -> dict:
    """The io phase at fit's model (7B width, FIT_LAYERS layers, amp O2):
    Model.fit over fit_recipe's shuffled TensorDataset of token ids on the
    native transport, its batches in native.shuffled_indices' order at
    seed + 1; then TokenRows (a GIL-bound transform) under IO_WORKERS
    thread workers and IO_WORKERS process workers (the same batches and
    per-step losses), and the process run again under IO_FAULT_SPEC (every
    batch once, in order; io_worker_restarts = the replaced workers, each
    dead with the fault's exit code 3; the fault-free losses); the
    transform alone under threads and processes (loader_rate); fit step ms
    beside a bare TrainStep's over the same batches (the card's idle
    share: 1 - bare / fit); exact flash launches. Returns the launch
    counts of the fits."""
    from paddle_tpu_torch import native
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.testing import faults
    from paddle_tpu_torch.models import LlamaConfig
    t_phase = time.perf_counter()
    total: dict = {}
    # the native transport: fit over fit_recipe's shuffled TensorDataset
    dl, losses, inputs, fit_ms, bare_ms, counts = io_fit(
        device, lambda factory: factory())
    require(dl.transports == ["native"], f"io: transports {dl.transports}")
    x = dl.dataset.tensors[0]
    order = native.shuffled_indices(FIT_ROWS, dl.seed + 1)
    require(torch.equal(torch.cat(inputs), x[order]),
            "io: the batches are not in the native shuffle's order")
    steps = FIT_ROWS // FIT_BATCH
    for name in TRAIN_KERNELS:
        require(counts[name] == FIT_LAYERS * steps,
                f"io native: {name} ran {counts[name]} times")
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    emit("io", transport="native", model="llama2_7b width",
         layers=FIT_LAYERS, rows=FIT_ROWS, batch=FIT_BATCH, seq=TRAIN_SEQ,
         steps=len(losses), losses=losses, order_is_native_shuffle=True,
         step_ms=fit_ms, bare_trainstep_step_ms=bare_ms,
         idle_share=1 - bare_ms / fit_ms, launches=counts)
    vocab = LlamaConfig.llama2_7b().vocab_size
    rows = TokenRows(vocab)

    def workers_loader(processes, data=rows):
        return DataLoader(data, batch_size=FIT_BATCH, shuffle=True,
                          seed=SEED + 52, num_workers=IO_WORKERS,
                          use_process_workers=processes)

    rates = {name: loader_rate(workers_loader(proc, TokenRows(
        vocab, IO_RATE_ROWS))) for name, proc in (("thread", False),
                                                  ("process", True))}
    runs = {}
    for name, proc, spec in (("thread", False, ""), ("process", True, ""),
                             ("process, faults", True, IO_FAULT_SPEC)):
        before = counter_values("io_worker_restarts")
        with faults.armed(spec,
                          dataloader_max_worker_restarts=IO_MAX_RESTARTS):
            runs[name] = io_fit(device,
                                lambda _f, proc=proc: workers_loader(proc))
        restarts = counter_delta(before, counter_values(
            "io_worker_restarts")).get("io_worker_restarts", 0)
        dl, losses, inputs, fit_ms, bare_ms, counts = runs[name]
        require(dl.transports == [name.split(",")[0]],
                f"io {name}: transports {dl.transports}")
        for kname in TRAIN_KERNELS:
            require(counts[kname] == FIT_LAYERS * steps,
                    f"io {name}: {kname} ran {counts[kname]} times")
        replaced = [e for e in dl.worker_exits if e[2]]
        if spec:
            require(replaced and all(e[1] == 3 for e in replaced),
                    f"io {name}: replaced workers {dl.worker_exits}")
            require(restarts == len(replaced), f"io {name}: "
                    f"io_worker_restarts {restarts}, replaced "
                    f"{len(replaced)}")
        ref_losses, ref_inputs = runs["thread"][1:3]
        require(len(inputs) == len(ref_inputs) and all(
            torch.equal(a, b) for a, b in zip(inputs, ref_inputs)),
            f"io {name}: the batches differ from the thread path's")
        require(losses == ref_losses, f"io {name}: losses {losses}, the "
                f"thread path's {ref_losses}")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        emit("io", transport=name, workers=IO_WORKERS, dataset="TokenRows "
             f"({IO_ROUNDS} pure-Python passes a row)", spec=spec,
             steps=len(losses), losses=losses, batches_equal_thread=True,
             losses_equal_thread=True, worker_deaths=sum(
                 1 for e in dl.worker_exits if e[1] == 3),
             io_worker_restarts=restarts, worker_exits=dl.worker_exits,
             **rates[name.split(",")[0]], step_ms=fit_ms,
             bare_trainstep_step_ms=bare_ms,
             idle_share=1 - bare_ms / fit_ms, launches=counts)
    emit("io", run="phase", seconds=time.perf_counter() - t_phase,
         rate_rows=IO_RATE_ROWS, threads=rates["thread"],
         processes=rates["process"], launches=total)
    return total


def counter_values(*names) -> dict:
    """The registry's current value of each series of ``names``."""
    from paddle_tpu_torch import observability as obs
    snap = obs.snapshot()["metrics"]
    out = {}
    for name in names:
        for s in snap.get(name, {}).get("series", []):
            key = name + "".join(f"{{{k}={v}}}"
                                 for k, v in sorted(s["labels"].items()))
            out[key] = s.get("value", s.get("count"))
    return out


def counter_delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


FAULT_COUNTERS = ("train_retries_total", "train_recoveries",
                  "train_emergency_checkpoints", "train_nan_losses",
                  "faults_injected")


def faults_fit(device, spec="", save_dir=None, loss=None, **fit_kw):
    """fit's recipe at FAULTS_LAYERS layers, FIT_STEPS steps, under the
    fault ``spec`` (backoff 0). A ModelCheckpoint without a directory
    stands in for the one ``save_dir`` would add, so only emergency
    checkpoints are written. Each recovery's and each emergency save's
    seconds are timed. Returns (the Model, its network)."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi.callbacks import ModelCheckpoint
    from paddle_tpu_torch.testing import faults

    class Timed(Model):
        def _recover_batch(self, *a, **kw):
            t0 = time.perf_counter()
            try:
                return super()._recover_batch(*a, **kw)
            finally:
                self.recover_s.append(time.perf_counter() - t0)

        def _emergency_checkpoint(self, *a, **kw):
            t0 = time.perf_counter()
            out = super()._emergency_checkpoint(*a, **kw)
            torch.cuda.synchronize()
            self.save_s.append(time.perf_counter() - t0)
            return out

    cfg, model, opt, crit, loader = fit_recipe(device, FAULTS_LAYERS,
                                               SEED + 41)
    fitted = Timed(model)
    fitted.recover_s, fitted.save_s = [], []
    fitted.prepare(opt, loss=loss or crit)
    kw = dict(epochs=1, accumulate_grad_batches=FIT_ACCUM,
              metrics_every=FIT_METRICS_EVERY, num_iters=FIT_STEPS,
              prefetch_to_device=True, verbose=0, save_dir=save_dir,
              callbacks=[ModelCheckpoint(save_dir=None)])
    kw.update(fit_kw)
    arm = (faults.armed(spec, train_retry_backoff=0.0) if spec
           else contextlib.nullcontext())
    with arm:
        fitted.fit(loader(), **kw)
    torch.cuda.synchronize()
    return fitted, model


def checkpoint_bytes(path) -> int:
    return sum(os.path.getsize(path + ext) for ext in (".pdparams", ".pdopt")
               if os.path.exists(path + ext))


def run_fit_faults(device) -> dict:
    """fit's recipe at 2 layers under FLAGS_fault_inject=FIT_FAULT_SPEC:
    every fault recovered (the dispatch fault re-dispatched, the sync fault
    retried in that recovery's drain, the save fault retried inside its
    emergency checkpoint), the recovery counters and faults_injected{site}
    equal to the schedule, the emergency checkpoint under build/ loading
    back, and the final parameters bit for bit those of a fault-free fit
    over the same batches (the step's kernels and AdamW are deterministic:
    fit's first loss equals a bare TrainStep's exactly); then a budget of
    train_max_retries=1 under train_dispatch:every=1 raising InjectedFault,
    and nan_policy="stop" on a NaN loss writing the checkpoint and
    stopping. Reports the recovery ms and the emergency save's seconds and
    bytes. Returns the launch counts of the faulted fit."""
    import shutil
    import warnings
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.framework import load
    from paddle_tpu_torch.testing import faults
    shutil.rmtree(FIT_FAULTS_DIR, ignore_errors=True)
    clean, clean_model = faults_fit(device)
    want = {k: p.detach().clone() for k, p in clean_model.named_parameters()}
    del clean, clean_model
    torch.cuda.empty_cache()

    before = counter_values(*FAULT_COUNTERS)
    kernels.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fitted, model = faults_fit(device, FIT_FAULT_SPEC,
                                   save_dir=FIT_FAULTS_DIR)
    counts = kernels.launch_counts()
    delta = counter_delta(before, counter_values(*FAULT_COUNTERS))
    schedule = {"train_retries_total": 2, "train_recoveries": 1,
                "train_emergency_checkpoints": 1,
                "faults_injected{site=train_dispatch}": 1,
                "faults_injected{site=train_sync}": 1,
                "faults_injected{site=checkpoint_save}": 1}
    require(delta == schedule, f"fit_faults: counters {delta}, want "
            f"{schedule}")
    require(fitted._optimizer.state_dict()["@step"] == FIT_STEPS,
            "fit_faults: an update was lost or repeated")
    differ = [k for k, p in model.named_parameters()
              if not torch.equal(p, want[k])]
    require(not differ, f"fit_faults: parameters differ from the fault-free "
            f"fit: {differ[:3]}")
    micro = FAULTS_LAYERS * FIT_ACCUM * FIT_STEPS
    for name in TRAIN_KERNELS:     # the failed dispatch launched nothing
        require(counts[name] == micro, f"fit_faults: {name} ran "
                f"{counts[name]} times, want {micro}")
    path = os.path.join(FIT_FAULTS_DIR, "emergency")
    ckpt_bytes = checkpoint_bytes(path)
    state = load(path + ".pdparams")
    names = dict(model.named_parameters())
    require(sorted(state) == sorted(model.state_dict())
            and all(state[k].shape == names[k].shape
                    and bool(torch.isfinite(state[k]).all())
                    for k in names), "fit_faults: the emergency checkpoint")
    recover_ms = [1e3 * s for s in fitted.recover_s]
    save_s = list(fitted.save_s)
    del fitted, model, want, state
    torch.cuda.empty_cache()

    # an exhausted budget: every dispatch fails, one retry
    before = counter_values(*FAULT_COUNTERS)
    raised = None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            with faults.armed("train_dispatch:every=1", train_max_retries=1,
                              train_retry_backoff=0.0):
                faults_fit(device)
        except faults.InjectedFault as e:
            raised = e
    require(raised is not None, "fit_faults: an exhausted budget did not "
            "raise InjectedFault")
    exhausted = counter_delta(before, counter_values(*FAULT_COUNTERS))
    require(exhausted.get("train_retries_total") == 1
            and "train_recoveries" not in exhausted,
            f"fit_faults: exhausted budget counters {exhausted}")
    torch.cuda.empty_cache()

    # nan_policy="stop": two epochs, a NaN loss at epoch 0's last step,
    # read at the epoch's sync (a NaN read mid-epoch is read again at the
    # sync: two checkpoints, as in the reference)
    from paddle_tpu_torch.models import LlamaConfig, LlamaPretrainingCriterion
    crit = LlamaPretrainingCriterion(LlamaConfig.llama2_7b())
    epoch_steps = FIT_ROWS // FIT_BATCH
    calls = [0]

    def nan_at_the_epoch_end(logits, labels):
        calls[0] += 1
        loss = crit(logits, labels)
        last = FIT_ACCUM * (epoch_steps - 1) + 1
        return loss * float("nan") if calls[0] == last else loss

    nan_dir = os.path.join(FIT_FAULTS_DIR, "nan")
    before = counter_values(*FAULT_COUNTERS)
    with warnings.catch_warnings(record=True) as nan_warned:
        warnings.simplefilter("always")
        stopped, _ = faults_fit(device, save_dir=nan_dir,
                                loss=nan_at_the_epoch_end, nan_policy="stop",
                                epochs=2, num_iters=None)
    nan_delta = counter_delta(before, counter_values(*FAULT_COUNTERS))
    nan_path = os.path.join(nan_dir, "emergency")
    require(stopped.stop_training and os.path.exists(nan_path + ".pdparams")
            and nan_delta.get("train_nan_losses") == 1
            and nan_delta.get("train_emergency_checkpoints") == 1,
            f"fit_faults: nan_policy='stop' {nan_delta}")
    stop_step = stopped._optimizer.state_dict()["@step"]
    require(stop_step == epoch_steps, f"fit_faults: the NaN stop came after "
            f"{stop_step} updates, want {epoch_steps}")
    nan_bytes = checkpoint_bytes(nan_path)
    del stopped
    shutil.rmtree(FIT_FAULTS_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    emit("fit_faults", model="llama2_7b width", layers=FAULTS_LAYERS,
         dtype="bf16 (amp O2), no masters", steps=FIT_STEPS,
         spec=FIT_FAULT_SPEC, counters=delta,
         recovery_warnings=sum("attempting recovery" in str(w.message)
                               for w in caught),
         params_equal_fault_free=True, recover_ms=recover_ms,
         emergency_save_s=save_s, emergency_checkpoint_bytes=ckpt_bytes,
         exhausted_raised=repr(raised), exhausted_counters=exhausted,
         nan_stop_updates=stop_step, nan_counters=nan_delta,
         nan_checkpoint_bytes=nan_bytes,
         nan_warnings=len(nan_warned), launches=counts)
    return counts


def run_nan_check(device) -> dict:
    """FLAGS_check_nan_inf on the card: a 2-layer bf16 Llama (7B width),
    forward and backward of one NAN_SEQ-token row. Off, no dispatch mode is
    installed; on (level 0) a clean step runs; with a NaN planted in layer
    1's down projection the step raises FloatingPointError naming the first
    ATen op whose output is not finite (a matmul), the same op the level-1
    run warns about first, and level 1 completes with a NaN loss. Reports
    the checked step's ms against the unchecked one. Returns the launch
    counts of the checked steps."""
    import warnings
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.amp import debugging as dbg
    from paddle_tpu_torch.models import LlamaPretrainingCriterion
    cfg, model = train_model(device, SEED + 51, layers=NAN_LAYERS)
    crit = LlamaPretrainingCriterion(cfg)
    x, y = (t.to(device) for t in token_batch(cfg.vocab_size, 1, NAN_SEQ,
                                              9))

    def step():
        loss = crit(model(x), y)
        loss.backward()
        model.zero_grad(set_to_none=True)
        return float(loss.detach())

    def timed(n=3):
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            loss = step()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n, loss

    require(not dbg.checker_installed() and _get_current_dispatch_mode()
            is None, "nan_check: a dispatch mode is installed with the flag "
            "off")
    plain_ms, plain_loss = timed()
    kernels.reset_launches()
    dbg.enable_tensor_checker()
    require(dbg.checker_installed(), "nan_check: no checker installed")
    checked_ms, checked_loss = timed()
    counts = kernels.launch_counts()
    dbg.disable_tensor_checker()
    require(math.isfinite(checked_loss) and checked_loss == plain_loss,
            f"nan_check: checked loss {checked_loss}, plain {plain_loss}")
    with torch.no_grad():
        model.llama.layers[1].mlp.down_proj.weight[3, 5] = float("nan")
    dbg.enable_tensor_checker()
    try:
        step()
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    dbg.disable_tensor_checker()
    model.zero_grad(set_to_none=True)
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
        debug_mode=dbg.DebugMode.CHECK_NAN_INF))
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        warn_loss = step()
    dbg.disable_tensor_checker()
    first = str(warned[0].message) if warned else None
    require(raised is not None and raised == first
            and any(f"'aten::{op}" in raised
                    for op in ("mm", "addmm", "matmul", "bmm")),
            f"nan_check: raised {raised!r}, level 1 warned first {first!r}")
    require(math.isnan(warn_loss), f"nan_check: level 1 loss {warn_loss}")
    require(not dbg.checker_installed() and _get_current_dispatch_mode()
            is None, "nan_check: the checker stayed installed")
    emit("nan_check", model="llama2_7b width", layers=NAN_LAYERS,
         dtype="bf16", seq=NAN_SEQ, raised=raised,
         level1_warnings=len(warned), level1_loss=warn_loss,
         plain_step_ms=plain_ms, checked_step_ms=checked_ms,
         checked_over_plain=checked_ms / plain_ms, launches=counts)
    del model
    torch.cuda.empty_cache()
    return counts


def grad_parity(phase, device, cpu, build_trainer, batch_of,
                want_launches):
    """One fp32 step of ``cpu`` and of its copy on the card, each through
    ``build_trainer(model)`` on ``batch_of(device)``: the loss and the
    gradients before the update agree (the loss within
    TRAIN_PARITY_LOSS_TOL relative, every gradient within
    TRAIN_PARITY_GRAD_TOL rel L2), the flash kernels launched
    ``want_launches`` times each on the card and never on the CPU, and
    the updated parameters finite. Returns the fields to emit."""
    from paddle_tpu_torch import kernels
    card = copy.deepcopy(cpu).to(device)
    results = {}
    for name, model in (("card", card), ("cpu", cpu)):
        dev = next(model.parameters()).device
        trainer = build_trainer(model)
        kernels.reset_launches()
        loss, grads = trainer.compute_loss_grads(*batch_of(dev))
        counts = kernels.launch_counts()
        grads = {k: g.detach().float().cpu() for k, g in grads.items()}
        trainer.apply_update()
        require(all(bool(torch.isfinite(p).all())
                    for p in model.parameters()),
                f"{phase}: non-finite parameters on the {name}")
        results[name] = (float(loss), grads, counts)
        del trainer
    (l_card, g_card, counts), (l_cpu, g_cpu, cpu_counts) = (
        results["card"], results["cpu"])
    for k in TRAIN_KERNELS:
        require(counts[k] == want_launches,
                f"{phase}: {k} ran {counts[k]} times on the card, want "
                f"{want_launches}")
        require(cpu_counts[k] == 0, f"{phase}: {k} launched on the CPU")
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    require(loss_rel <= TRAIN_PARITY_LOSS_TOL,
            f"{phase}: loss {l_card} vs {l_cpu}")
    require(sorted(g_card) == sorted(g_cpu), f"{phase}: grad names")
    worst, worst_name = 0.0, None
    for k, g in g_cpu.items():
        err = float((g_card[k] - g).norm() / g.norm().clamp_min(1e-30))
        if err > worst:
            worst, worst_name = err, k
    require(worst <= TRAIN_PARITY_GRAD_TOL,
            f"{phase}: grad of {worst_name} off by {worst} (rel L2)")
    del card
    torch.cuda.empty_cache()
    return dict(dtype="fp32", loss_card=l_card, loss_cpu=l_cpu,
                loss_rel_err=loss_rel, loss_tol=TRAIN_PARITY_LOSS_TOL,
                grads=len(g_cpu), grad_rel_l2_max=worst,
                grad_worst=worst_name, grad_tol=TRAIN_PARITY_GRAD_TOL,
                launches=counts)


def run_train_parity(device):
    """One fp32 TrainStep at Llama-2-7B width and TRAIN_PARITY_LAYERS
    layers on the card (the flash kernels) and on a CPU copy (their
    plain versions): grad_parity."""
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b()
    cfg.num_hidden_layers = TRAIN_PARITY_LAYERS
    cpu = LlamaForCausalLM(cfg, device="cpu", dtype=torch.float32,
                           generator=seed(SEED + 11))
    x, y = token_batch(cfg.vocab_size, 1, TRAIN_PARITY_SEQ, 6)
    fields = grad_parity("train_parity", device, cpu,
                         lambda m: make_trainer(m, 3e-4),
                         lambda dev: (x.to(dev), y.to(dev)),
                         TRAIN_PARITY_LAYERS)
    emit("train_parity", model="llama2_7b width", layers=TRAIN_PARITY_LAYERS,
         batch=1, seq=TRAIN_PARITY_SEQ, **fields)
    del cpu


# ------------------------------------------------------------------- moe
def moe_flops(cfg, batch, seq, capacity) -> dict:
    """One training step's operations at ``batch`` rows of ``seq`` tokens:
    ``model`` counts each token's own work (6 x the matmul parameters it
    meets, its k experts only, the tied LM head, plus causal attention at
    forward 1x and backward 2.5x); ``executed`` adds what the
    static-capacity routing computes besides: every expert over all its
    ``capacity`` slots, and the dispatch and combine products (forward 2,
    backward 3, each 2 T E C d)."""
    h, i, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    n_moe = cfg.num_hidden_layers // cfg.moe_every
    n_dense = cfg.num_hidden_layers - n_moe
    t = batch * seq
    dense = 4 * h * h + 2 * h * i
    moe = 4 * h * h + cfg.top_k * 2 * h * i + h * e
    head = cfg.vocab_size * h
    pairs = seq * (seq + 1) // 2
    attn = 3.5 * 4.0 * pairs * h * cfg.num_hidden_layers * batch
    model = 6.0 * (n_dense * dense + n_moe * moe + head) * t + attn
    padded = n_moe * 6.0 * 2 * h * i * (e * capacity - cfg.top_k * t)
    routing = n_moe * 5 * 2.0 * t * e * capacity * h
    return dict(model=model, attention=attn, expert_capacity_padding=padded,
                dispatch_combine=routing, executed=model + padded + routing)


def moe_model(device, dtype=torch.bfloat16, layers=None, seed_offset=21,
              expert_axis=None):
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import MoEGPTConfig, MoEGPTForCausalLM
    cfg = MoEGPTConfig(expert_axis=expert_axis)
    if layers is not None:
        cfg.num_hidden_layers = layers
    return cfg, MoEGPTForCausalLM(cfg, device=device, dtype=dtype,
                                  generator=seed(SEED + seed_offset, device))


def moe_routing(model, x) -> list:
    """Each MoE block's routing of one forward of ``x`` (no grad): its
    gate's aux loss and the choices dropped at capacity (T k - the kept
    dispatch slots), from the gates' logits tapped by forward hooks."""
    from paddle_tpu_torch.incubate.distributed.models.moe import \
        top_k_dispatch
    blocks = [b for b in model.h if hasattr(b, "moe")]
    taps = []
    hooks = [b.moe.gate.register_forward_hook(
        lambda m, args, out: taps.append(out.detach())) for b in blocks]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for hk in hooks:
            hk.remove()
    aux_total = model.total_aux_loss()           # collects and clears
    out = []
    for b, logits in zip(blocks, taps):
        t = logits.shape[0]
        cap = b.moe.capacity(t)
        _, dispatch, aux = top_k_dispatch(logits, b.moe.top_k, cap,
                                          b.moe.gate.aux_loss_mode)
        kept = int(dispatch.sum())
        out.append(dict(capacity=cap, aux_loss=float(aux),
                        dropped=t * b.moe.top_k - kept,
                        choices=t * b.moe.top_k))
    require(abs(sum(r["aux_loss"] for r in out) - float(aux_total))
            <= 1e-3 * max(1.0, abs(float(aux_total))),
            "moe: the gates' stored losses disagree with their routing")
    return out


def run_moe(device):
    """MoEGPTConfig() (GPT-3 345M widths, 24 layers, 8 experts top-2 on
    every 2nd block), bf16 with f32 masters, seeded, trained by TrainStep
    with AdamW + global-norm clip + warmup/cosine LR for MOE_STEPS steps on
    one fixed batch of MOE_BATCH x MOE_SEQ tokens: finite, falling losses,
    #7, #8 and #9 launched exactly once a layer a step and no other kernel,
    every gate's loss collected by the step, memwatch's train_step row for
    this model; step ms, tokens/s, MFU, peak memory, and before and after
    the steps each MoE block's aux loss and dropped choices."""
    from paddle_tpu_torch.generation.program_cache import model_signature
    from paddle_tpu_torch.observability import memory
    t0 = time.perf_counter()
    cfg, model = moe_model(device)
    params = sum(p.numel() for p in model.parameters())
    trainer = make_trainer(model, 3e-4, steps=MOE_STEPS)
    x, y = (t.to(device) for t in token_batch(cfg.vocab_size, MOE_BATCH,
                                              MOE_SEQ, 21))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    routing_init = moe_routing(model, x)
    losses, step_s, counts, peak = timed_steps(trainer, (x, y), 0, MOE_STEPS)
    require(all(math.isfinite(v) for v in losses), f"moe losses {losses}")
    require(losses[-1] < losses[0], f"moe loss did not fall: {losses}")
    want = cfg.num_hidden_layers * MOE_STEPS
    for name, n in counts.items():
        require(n == (want if name in TRAIN_KERNELS else 0),
                f"moe: {name} ran {n} times, want "
                f"{want if name in TRAIN_KERNELS else 0}")
    require(model.total_aux_loss() is None,
            "moe: a gate kept its loss past the step")
    sig = model_signature(model)[:8]
    rows = [r for r in memory.program_table()
            if r["kind"] == "train_step" and r["model"] == sig]
    require(len(rows) == 1 and rows[0]["captures"] == 1
            and rows[0]["temp"] > 0 and rows[0]["bucket"] == MOE_BATCH,
            f"moe: memwatch rows {rows}")
    print(memory.format_program_table(rows), flush=True)
    routing = moe_routing(model, x)
    tokens = MOE_BATCH * MOE_SEQ
    step_ms = 1e3 * float(np.median(step_s))
    flops = moe_flops(cfg, MOE_BATCH, MOE_SEQ, routing[0]["capacity"])
    emit("moe", model="MoEGPTConfig() (GPT-3 345M widths, 8 experts, "
         "top-2, MoE every 2nd block)", layers=cfg.num_hidden_layers,
         params=params, dtype="bf16, f32 masters", batch=MOE_BATCH,
         seq=MOE_SEQ, steps=MOE_STEPS, losses=losses,
         step_ms=[1e3 * v for v in step_s], step_ms_median=step_ms,
         tokens_per_s=tokens / (step_ms / 1e3), peak_mem_gb=peak / 1e9,
         flops_per_step=flops,
         mfu_vs_989_tflops=flops["model"] / (step_ms / 1e3) / PEAK_FLOPS[
             torch.bfloat16],
         routing=routing, routing_before_training=routing_init,
         aux_loss_total=sum(r["aux_loss"] for r in routing),
         dropped_choices=sum(r["dropped"] for r in routing),
         aux_loss_total_before=sum(r["aux_loss"] for r in routing_init),
         dropped_choices_before=sum(r["dropped"] for r in routing_init),
         choices=sum(r["choices"] for r in routing),
         launches=counts, model_build_s=build_s,
         memwatch_train_step=rows[0])
    del model, trainer, x, y
    torch.cuda.empty_cache()
    return counts


def run_moe_parity(device):
    """One fp32 step of MoE-GPT at full width and MOE_PARITY_LAYERS layers
    (a dense block and an MoE block) on the card (the flash kernels) and
    on a CPU copy (their plain versions): grad_parity, as train_parity
    holds Llama."""
    cfg, cpu = moe_model("cpu", torch.float32, MOE_PARITY_LAYERS, 22)
    x, y = token_batch(cfg.vocab_size, 1, MOE_PARITY_SEQ, 22)
    fields = grad_parity("moe_parity", device, cpu,
                         lambda m: make_trainer(m, 3e-4),
                         lambda dev: (x.to(dev), y.to(dev)),
                         MOE_PARITY_LAYERS)
    emit("moe_parity", model="MoEGPTConfig() width",
         layers=MOE_PARITY_LAYERS, batch=1, seq=MOE_PARITY_SEQ, **fields)
    del cpu


# ------------------------------------------------------------ unet, bert
def unet_model(device, dtype=torch.bfloat16, cfg=None, seed_offset=31):
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import UNet2DConditionModel, UNetConfig
    cfg = cfg or UNetConfig.sd15()
    return cfg, UNet2DConditionModel(
        cfg, device=device, dtype=dtype,
        generator=seed(SEED + seed_offset, device))


def unet_batch(cfg, batch, device, dtype, seed_offset=31):
    """Seeded (latents, timesteps, context, noise) as the JAX bench draws
    them: unit-normal latents of the config's channels and size,
    timesteps in [0, 1000), UNET_CONTEXT context tokens of the
    cross-attention width, unit-normal noise."""
    rng = np.random.default_rng(SEED + seed_offset)
    n = cfg.sample_size
    lat = rng.standard_normal((batch, cfg.in_channels, n, n))
    t = torch.from_numpy(rng.integers(0, 1000, (batch,))).to(device)
    ctx = rng.standard_normal((batch, UNET_CONTEXT,
                               cfg.cross_attention_dim))
    noise = rng.standard_normal(lat.shape)

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                          dtype=dtype)

    return put(lat), t, put(ctx), put(noise)


def unet_trainer(model, lr=UNET_LR):
    """TrainStep over UNetDenoiseLoss with AdamW (f32 masters for a bf16
    model): the JAX bench's recipe."""
    from paddle_tpu_torch.hapi import TrainStep
    from paddle_tpu_torch.models import UNetDenoiseLoss
    from paddle_tpu_torch.optimizer import AdamW
    return TrainStep(UNetDenoiseLoss(model), AdamW(
        lr, parameters=model.named_parameters(), multi_precision=True))


def unet_attention(model) -> list:
    """The UNet's attention modules: one call each a forward (self- or
    cross-attention), each at its head dim."""
    from paddle_tpu_torch.models.unet import Attention
    return [m for m in model.modules() if isinstance(m, Attention)]


def run_unet(device):
    """UNetConfig.sd15() at full width and depth, bf16 with f32 masters,
    seeded, trained by TrainStep(UNetDenoiseLoss) + AdamW on one fixed
    batch: finite losses that fall from the first step, #7, #8 and #9
    launched once an attention call a step and no other kernel; step ms,
    images/s, peak memory."""
    t0 = time.perf_counter()
    cfg, model = unet_model(device)
    params = sum(p.numel() for p in model.parameters())
    attention = unet_attention(model)
    calls = len(attention)
    require(calls == UNET_SD15_ATTENTION_CALLS,
            f"unet: {calls} attention calls a forward")
    trainer = unet_trainer(model)
    batch = unet_batch(cfg, UNET_BATCH, device, torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    losses, step_s, counts, peak = timed_steps(trainer, batch, UNET_WARMUP,
                                               UNET_STEPS)
    require(all(math.isfinite(v) for v in losses), f"unet losses {losses}")
    require(losses[-1] < losses[0], f"unet loss did not fall: {losses}")
    want = calls * UNET_STEPS
    for name, n in counts.items():
        require(n == (want if name in TRAIN_KERNELS else 0),
                f"unet: {name} ran {n} times, want "
                f"{want if name in TRAIN_KERNELS else 0}")
    step_ms = 1e3 * float(np.median(step_s))
    heads = sorted({m.head_dim for m in attention})
    emit("unet", model="UNetConfig.sd15() (SD-1.5: 320/640/1280/1280, "
         "8 heads, 77 x 768 context)", params=params,
         dtype="bf16, f32 masters", batch=UNET_BATCH,
         latent=[cfg.in_channels, cfg.sample_size, cfg.sample_size],
         context=[UNET_CONTEXT, cfg.cross_attention_dim], head_dims=heads,
         attention_calls_per_forward=calls, remat=False, lr=UNET_LR,
         warmup_steps=UNET_WARMUP, steps=UNET_STEPS, losses=losses,
         step_ms=[1e3 * v for v in step_s], step_ms_median=step_ms,
         images_per_s=UNET_BATCH / (step_ms / 1e3), peak_mem_gb=peak / 1e9,
         launches=counts, model_build_s=build_s)
    del model, trainer, batch
    torch.cuda.empty_cache()
    return counts


def run_unet_parity(device):
    """One fp32 step of SD-1.5's widths cut to 3 blocks of 1 layer at
    UNET_PARITY_SIZE latents (heads of 40 and 80 in the blocks, 160 in
    the mid block; cross-attention against 77 tokens) on the card (the
    flash kernels, cuDNN) and on a CPU copy (their plain versions)."""
    from paddle_tpu_torch.models import UNetConfig
    cfg = UNetConfig(sample_size=UNET_PARITY_SIZE,
                     block_out_channels=UNET_PARITY_BLOCKS,
                     layers_per_block=1)
    cfg, cpu = unet_model("cpu", torch.float32, cfg, seed_offset=32)
    attention = unet_attention(cpu)
    heads = sorted({m.head_dim for m in attention})
    require(heads == [40, 80, 160], f"unet_parity: head dims {heads}")
    fields = grad_parity(
        "unet_parity", device, cpu, lambda m: unet_trainer(m),
        lambda dev: unet_batch(cfg, UNET_BATCH, dev, torch.float32, 32),
        len(attention))
    emit("unet_parity", model="SD-1.5 widths, blocks "
         f"{list(UNET_PARITY_BLOCKS)}, 1 layer a block", head_dims=heads,
         batch=UNET_BATCH, latent=[cfg.in_channels, UNET_PARITY_SIZE,
                                   UNET_PARITY_SIZE], **fields)
    del cpu


class BertPretrainingLoss(torch.nn.Module):
    """BertForPretraining and its criterion as one module: ``forward(ids,
    token types, MLM labels, NSP labels)`` -> the loss TrainStep steps."""

    def __init__(self, model, criterion):
        super().__init__()
        self.model, self.criterion = model, criterion

    def forward(self, ids, token_types, mlm_labels, nsp_labels):
        pred, nsp = self.model(ids, token_types)
        return self.criterion(pred, nsp, mlm_labels, nsp_labels)


def bert_batch(cfg, batch, seq, device, seed_offset=41):
    """Seeded pretraining rows: real lengths in [BERT_MIN_LEN, seq] (one
    row full) padded with pad_token_id, the first half of a row's tokens
    segment 0 and the rest segment 1, BERT_MLM_SHARE of the real tokens
    labelled for the MLM (their inputs BERT_MASK_ID, the other labels
    -100), random NSP labels. Returns (ids, token types, MLM labels, NSP
    labels, real tokens)."""
    rng = np.random.default_rng(SEED + seed_offset)
    lens = rng.integers(min(BERT_MIN_LEN, seq), seq + 1, batch)
    lens[0] = seq
    # past bert-base-uncased's special and unused ids (below 1000)
    ids = rng.integers(min(1000, cfg.vocab_size // 2), cfg.vocab_size,
                       (batch, seq))
    tt = np.zeros((batch, seq), np.int64)
    mlm = np.full((batch, seq), -100, np.int64)
    for i, n in enumerate(lens):
        ids[i, n:] = cfg.pad_token_id
        tt[i, n // 2:n] = 1
        pick = rng.choice(n, max(1, int(round(BERT_MLM_SHARE * n))),
                          replace=False)
        mlm[i, pick] = ids[i, pick]
        ids[i, pick] = BERT_MASK_ID
    nsp = rng.integers(0, 2, (batch,))
    out = tuple(torch.from_numpy(np.asarray(a, np.int64)).to(device)
                for a in (ids, tt, mlm, nsp))
    return out + (int(lens.sum()),)


def bert_model(cls, cfg, device, dtype=torch.bfloat16, seed_offset=41,
               **kw):
    from paddle_tpu_torch.device import seed
    return cls(cfg, device=device, dtype=dtype,
               generator=seed(SEED + seed_offset, device), **kw)


def bert_trainer(model, cfg, lr=BERT_LR):
    from paddle_tpu_torch.hapi import TrainStep
    from paddle_tpu_torch.models import BertPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    return TrainStep(BertPretrainingLoss(model,
                                         BertPretrainingCriterion(cfg)),
                     AdamW(lr, parameters=model.named_parameters(),
                           multi_precision=True))


def run_bert(device):
    """BertConfig.bert_base() pretraining (MLM + NSP), bf16 with f32
    masters, dropout 0.1 from the model's generator, through TrainStep +
    AdamW on one fixed batch: finite losses that fall, no kernel launched
    (SDPA's dense path under the padding mask); step ms, tokens/s, peak
    memory; then a BertForSequenceClassification eval forward on the
    same rows, again launching nothing."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         BertForSequenceClassification)
    cfg = BertConfig.bert_base()
    t0 = time.perf_counter()
    model = bert_model(BertForPretraining, cfg, device)
    params = sum(p.numel() for p in model.parameters())
    trainer = bert_trainer(model, cfg)
    *batch, real = bert_batch(cfg, BERT_BATCH, BERT_SEQ, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    losses, step_s, counts, peak = timed_steps(trainer, batch, BERT_WARMUP,
                                               BERT_STEPS)
    require(all(math.isfinite(v) for v in losses), f"bert losses {losses}")
    require(losses[-1] < losses[0], f"bert loss did not fall: {losses}")
    require(not any(counts.values()),
            f"bert: kernels launched {counts} (the dense path launches "
            f"none)")
    step_ms = 1e3 * float(np.median(step_s))
    del trainer, model
    torch.cuda.empty_cache()
    clf = bert_model(BertForSequenceClassification, cfg, device,
                     seed_offset=42).eval()
    kernels.reset_launches()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits = clf(batch[0], batch[1])
        torch.cuda.synchronize()
        eval_ms = 1e3 * (time.perf_counter() - t0)
    eval_counts = kernels.launch_counts()
    require(tuple(logits.shape) == (BERT_BATCH, 2)
            and bool(torch.isfinite(logits).all()),
            f"bert: classifier logits {tuple(logits.shape)}")
    require(not any(eval_counts.values()),
            f"bert: the classifier launched {eval_counts}")
    tokens = BERT_BATCH * BERT_SEQ
    emit("bert", model="BertConfig.bert_base() (bert-base-uncased)",
         params=params, dtype="bf16, f32 masters", batch=BERT_BATCH,
         seq=BERT_SEQ, real_tokens=real, mlm_labels=int(
             (batch[2] != -100).sum()), dropout=cfg.hidden_dropout_prob,
         lr=BERT_LR, warmup_steps=BERT_WARMUP, steps=BERT_STEPS,
         losses=losses, step_ms=[1e3 * v for v in step_s],
         step_ms_median=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
         real_tokens_per_s=real / (step_ms / 1e3), peak_mem_gb=peak / 1e9,
         launches=counts, model_build_s=build_s,
         classifier_eval_ms=eval_ms, classifier_launches=eval_counts)
    del clf, batch
    torch.cuda.empty_cache()
    return counts


def run_bert_parity(device):
    """One fp32 step of bert-base at BERT_PARITY_LAYERS layers without
    dropout on the card and on a CPU copy (SDPA's dense path on both)."""
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    cfg = dataclasses.replace(
        BertConfig.bert_base(), num_hidden_layers=BERT_PARITY_LAYERS,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cpu = bert_model(BertForPretraining, cfg, "cpu", torch.float32, 43)
    fields = grad_parity(
        "bert_parity", device, cpu, lambda m: bert_trainer(m, cfg),
        lambda dev: bert_batch(cfg, BERT_PARITY_BATCH, BERT_PARITY_SEQ, dev,
                               43)[:4], 0)
    emit("bert_parity", model="BertConfig.bert_base() width",
         layers=BERT_PARITY_LAYERS, batch=BERT_PARITY_BATCH,
         seq=BERT_PARITY_SEQ, **fields)
    del cpu


def dense_bshd(q, k, v, segment_ids=None, kv_segment_ids=None,
               causal: bool = True, sm_scale=None):
    """``flash_attention_bshd``'s dense twin: ``flash_attention_ref`` (f32
    scores, autograd) in the same ``(B, S, H, D)`` layout; no launch."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    b, s, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]

    def to_bhsd(t, sl, nh):
        return t.transpose(1, 2).reshape(b * nh, sl, d)

    out = fa.flash_attention_ref(to_bhsd(q, s, h), to_bhsd(k, skv, hkv),
                                 to_bhsd(v, skv, hkv), causal=causal,
                                 sm_scale=sm_scale, n_heads=h, n_kv_heads=hkv)
    return out.reshape(b, h, s, d).transpose(1, 2)


@contextlib.contextmanager
def dense_sdpa():
    """For the ``with`` block, SDPA's flash route swapped for its dense
    twin (the name ``nn.functional`` calls): the same entry points, no
    launch."""
    from paddle_tpu_torch.nn import functional as F
    real = F.flash_attention_bshd
    F.flash_attention_bshd = dense_bshd
    try:
        yield
    finally:
        F.flash_attention_bshd = real


def run_fused_layers(device):
    """The fused attention layers at GPT-3 345M's width (hidden 1024, 16
    heads of 64, FFN 4096), bf16, B x S = FUSED_BATCH x FUSED_SEQ:
    FusedTransformerEncoderLayer (post-LN, GELU) in eval mode against the
    same layer on the dense attention (its plain composition), and
    fused_multi_head_attention (pre-LN, biases) forward and backward at
    dropout 0 against the dense reference: outputs and gradients within
    GRAD_TOL of their largest element (the bf16 attention outputs differ
    by about one ulp, which the layers after it carry). Launch counts exact: the flash forward #7
    non-causal once a call, #8 and #9 once a backward. Returns them."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.incubate import nn as fused
    from paddle_tpu_torch.incubate.nn import functional as FF
    dtype, h, nh, ffn = torch.bfloat16, 1024, 16, 4096
    gen = torch.Generator(device=device).manual_seed(SEED + 23)
    layer = fused.FusedTransformerEncoderLayer(
        h, nh, ffn, activation="gelu", device=device, dtype=dtype,
        generator=seed(SEED + 23, device)).eval()
    x = _rand(gen, (FUSED_BATCH, FUSED_SEQ, h), dtype, device)
    total: dict = {}

    def counted_call(fn):
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        c = kernels.launch_counts()
        for k, n in c.items():
            total[k] = total.get(k, 0) + n
        return out, c

    with torch.no_grad():
        out, c_layer = counted_call(lambda: layer(x))
        with dense_sdpa():
            ref, c_ref = counted_call(lambda: layer(x))
    tol = GRAD_TOL[dtype]
    layer_rel = rel_err(out, ref)
    require(c_layer["flash_attention_fwd"] == 1
            and sum(c_layer.values()) == 1 and sum(c_ref.values()) == 0,
            f"fused_layers: encoder launches {c_layer} / {c_ref}")
    require(layer_rel <= tol, f"fused_layers: encoder layer off by "
            f"{layer_rel} of its largest element")
    layer_ms = time_ms(lambda: layer(x), iters=10, warmup=2)
    with dense_sdpa():
        layer_plain_ms = time_ms(lambda: layer(x), iters=3, warmup=1)

    s = 0.02
    args = dict(qkv_weight=_rand(gen, (3, nh, h // nh, h), dtype, device, s),
                linear_weight=_rand(gen, (h, h), dtype, device, s),
                qkv_bias=_rand(gen, (3, nh, h // nh), dtype, device, s),
                linear_bias=_rand(gen, (h,), dtype, device, s),
                pre_ln_scale=1.0 + _rand(gen, (h,), dtype, device, s),
                pre_ln_bias=_rand(gen, (h,), dtype, device, s))
    dout = _rand(gen, x.shape, dtype, device)

    def mha():
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, args["qkv_weight"], args["linear_weight"])]
        o = FF.fused_multi_head_attention(
            leaves[0], leaves[1], leaves[2], pre_layer_norm=True,
            dropout_rate=0.0, attn_dropout_rate=0.0, training=True,
            **{k: v for k, v in args.items()
               if k not in ("qkv_weight", "linear_weight")})
        return (o.detach(),) + torch.autograd.grad(o, leaves, dout)

    got, c_mha = counted_call(mha)
    with dense_sdpa():
        want, _ = counted_call(mha)
    require(all(c_mha[k] == 1 for k in TRAIN_KERNELS)
            and sum(c_mha.values()) == 3,
            f"fused_layers: fused_multi_head_attention launches {c_mha}")
    mha_rel = rel_err(got[0], want[0])
    grad_rel = [rel_err(g, w) for g, w in zip(got[1:], want[1:])]
    require(max([mha_rel] + grad_rel) <= tol,
            f"fused_layers: fused_multi_head_attention out {mha_rel}, "
            f"grads {grad_rel}")
    mha_ms = time_ms(mha, iters=10, warmup=2)
    with dense_sdpa():
        mha_plain_ms = time_ms(mha, iters=3, warmup=1)
    emit("fused_layers", width="GPT-3 345M (1024, 16 heads of 64, FFN "
         "4096)", dtype="bf16", batch=FUSED_BATCH, seq=FUSED_SEQ,
         tol=tol, encoder_layer=dict(
             rel_err=layer_rel, max_err=max_err(out, ref), ms=layer_ms,
             plain_ms=layer_plain_ms, launches=c_layer),
         fused_multi_head_attention=dict(
             rel_err=mha_rel, grad_rel_err=grad_rel, fwd_bwd_ms=mha_ms,
             plain_fwd_bwd_ms=mha_plain_ms, launches=c_mha))
    del layer, x
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------- train_varlen
def pack_ids(lens, device) -> torch.Tensor:
    """A pack's token segment ids: document j's tokens carry j + 1."""
    return torch.repeat_interleave(
        torch.arange(1, len(lens) + 1, dtype=torch.int32, device=device),
        torch.tensor(lens, device=device))


def in_kv_groups(call, h, hkv):
    """``call(q_rows, kv_rows, n_kv)`` over up to PLAIN_KV_GROUPS equal
    slices of the kv heads (B = 1: rows are heads) and their query heads,
    concatenated along the rows: the plain flash twins are independent per
    head, and a slice's dense f32 scores stay a fraction of the card's
    memory."""
    groups = math.gcd(hkv, PLAIN_KV_GROUPS)
    per, rep = hkv // groups, h // hkv
    outs = [call(slice(g * per * rep, (g + 1) * per * rep),
                 slice(g * per, (g + 1) * per), per) for g in range(groups)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def per_document(q, k, v, do, lens, h, hkv):
    """The pack's reference: plain causal attention (dense f32, autograd)
    of each document alone, ``(T, H, D)`` tensors in and out, with the
    gradients of q, k and v."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    outs, grads, s0 = [], ([], [], []), 0
    for n in lens:
        rows = slice(s0, s0 + n)
        s0 += n
        leaves = [t[rows].transpose(0, 1).contiguous().requires_grad_(True)
                  for t in (q, k, v)]
        o = fa.flash_attention_ref(*leaves, causal=True, n_heads=h,
                                   n_kv_heads=hkv)
        gs = torch.autograd.grad(o, leaves,
                                 do[rows].transpose(0, 1).contiguous())
        outs.append(o.detach().transpose(0, 1))
        for acc, g in zip(grads, gs):
            acc.append(g.transpose(0, 1))
        del leaves, o, gs
    return torch.cat(outs), [torch.cat(acc) for acc in grads]


def hold(tag, out, ref_out, grads, ref_grads, dtype):
    """Outputs within OUT_TOL elementwise, gradients within GRAD_TOL of
    their largest element; returns (max abs err, worst grad rel err)."""
    atol, rtol = OUT_TOL[dtype]
    over = excess(out, ref_out, rtol)
    require(over <= atol, f"{tag}: out {over} over {rtol} |ref|")
    worst = max(rel_err(g, r) for g, r in zip(grads, ref_grads))
    require(worst <= GRAD_TOL[dtype], f"{tag}: grads off by {worst}")
    return max_err(out, ref_out), worst


def run_train_varlen(device):
    """The varlen path through its public entry points, bf16, launch counts
    exact; then each public result against its plain reference. Returns
    the counts."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import rms_norm as rn
    from paddle_tpu_torch.nn import functional as F
    dtype = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    norms = [(case, [_rand(gen, (n, hid), dtype, device) for _ in range(3)],
              (1.0 + 0.1 * torch.randn(hid, generator=gen, device=device)
               ).to(dtype)) for case, n, hid in RMS_SHAPES]
    packs = []
    for case, lens, h, hkv in VARLEN_PACKS:
        t = sum(lens)
        cu = torch.tensor((0,) + tuple(np.cumsum(lens)), dtype=torch.int32,
                          device=device)
        packs.append((case, lens, h, hkv, cu, [
            _rand(gen, (t, n_h, HEAD_DIM), dtype, device)
            for n_h in (h, hkv, hkv, h)]))
    vl = [_rand(gen, (len(VLMEA_LENS), HEADS, VLMEA_SEQ, HEAD_DIM), dtype,
                device) for _ in range(3)]
    vl_lens = torch.tensor(VLMEA_LENS, dtype=torch.int32, device=device)
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    norm_res = []
    for case, (x, res, g), w in norms:
        leaves = [t.clone().requires_grad_(True) for t in (x, res, w)]
        out, hsum = IF.fused_rms_norm(leaves[0], leaves[2], epsilon=RMS_EPS,
                                      residual=leaves[1])
        norm_res.append((out.detach(), hsum.detach(),
                         torch.autograd.grad(out, leaves, g)))
    pack_res = []
    for case, lens, h, hkv, cu, (q, k, v, do) in packs:
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out, _ = F.flash_attn_unpadded(*leaves, cu, cu, max(lens), max(lens),
                                       causal=True)
        pack_res.append((out.detach(), torch.autograd.grad(out, leaves, do)))
    vl_out = IF.variable_length_memory_efficient_attention(*vl, vl_lens,
                                                           causal=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = dict(rms_norm_fwd=len(norms), rms_norm_bwd_dx=len(norms),
                flash_attention_fwd_seg=len(packs) + 1,
                flash_attention_bwd_dq_seg=len(packs),
                flash_attention_bwd_dkv_seg=len(packs))
    require_launches(counts, {**dict.fromkeys(counts, 0), **want},
                     "train_varlen")

    for (case, (x, res, g), w), (out, hsum, grads) in zip(norms, norm_res):
        leaves = [t.clone().requires_grad_(True) for t in (x, res, w)]
        ref_h = leaves[0] + leaves[1]
        ref = rn.rms_norm_ref(ref_h, leaves[2], RMS_EPS)
        ref_grads = torch.autograd.grad(ref, leaves, g)
        require(torch.equal(hsum, (x + res)), f"fused_rms_norm {case}: h")
        err, grad_rel = hold(f"fused_rms_norm {case}", out, ref, grads,
                             ref_grads, dtype)
        emit("train_varlen", entry="fused_rms_norm", case=case,
             rows=x.shape[0], hidden=x.shape[1], dtype="bf16",
             out_max_err=err, grad_rel_err=grad_rel)
        del leaves, ref, ref_grads
    for (case, lens, h, hkv, cu, (q, k, v, do)), (out, grads) in zip(
            packs, pack_res):
        ref_out, ref_grads = per_document(q, k, v, do, lens, h, hkv)
        err, grad_rel = hold(f"flash_attn_unpadded {case}", out, ref_out,
                             grads, ref_grads, dtype)
        emit("train_varlen", entry="flash_attn_unpadded", case=case,
             doc_lens=list(lens), H=h, Hkv=hkv, dtype="bf16",
             reference="each document alone", out_max_err=err,
             grad_rel_err=grad_rel)
        del ref_out, ref_grads
        torch.cuda.empty_cache()
    b = len(VLMEA_LENS)
    seg = (torch.arange(VLMEA_SEQ, device=device)[None, :]
           >= vl_lens[:, None]).to(torch.int32).repeat_interleave(HEADS, 0)
    ref = in_kv_groups(lambda qr, kr, n: fa.flash_attention_fwd_ref(
        *(t.reshape(b * HEADS, VLMEA_SEQ, HEAD_DIM)[qr] for t in vl[:1]),
        *(t.reshape(b * HEADS, VLMEA_SEQ, HEAD_DIM)[kr] for t in vl[1:]),
        True, None, n, n, seg[qr], seg[kr])[0], b * HEADS, b * HEADS)
    atol, rtol = OUT_TOL[dtype]
    over = excess(vl_out.reshape(b * HEADS, VLMEA_SEQ, HEAD_DIM), ref, rtol)
    require(over <= atol, f"variable_length_memory_efficient_attention: "
            f"{over} over {rtol} |ref|")
    emit("train_varlen", entry="variable_length_memory_efficient_attention",
         B=b, S=VLMEA_SEQ, seq_lens=list(VLMEA_LENS), H=HEADS, dtype="bf16",
         out_max_err=max_err(vl_out.reshape(ref.shape), ref),
         out_excess=over, seconds_whole_path=seconds, launches=counts)
    del norms, norm_res, packs, pack_res, vl, vl_out, ref
    torch.cuda.empty_cache()
    return counts


def check_rms_norm(dtype, device, rows):
    """The RMSNorm forward and dx kernels against their plain twins on the
    fused input (x + residual) at the 7B and 70B widths; kernel, plain,
    library (torch.nn.functional.rms_norm forward, forward + backward and
    its backward alone) and bound times."""
    from paddle_tpu_torch.kernels import rms_norm as rn
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    for case, n, hid in RMS_SHAPES:
        x = _rand(gen, (n, hid), dtype, device) + _rand(gen, (n, hid), dtype,
                                                        device)
        w = (1.0 + 0.1 * torch.randn(hid, generator=gen, device=device)
             ).to(dtype)
        g = _rand(gen, (n, hid), dtype, device)
        y, r = rn.rms_norm_fwd(x, w, RMS_EPS)
        y_r, r_r = rn.rms_norm_fwd_ref(x, w, RMS_EPS)
        dx = rn.rms_norm_bwd_dx(x, w, g, r)
        dx_r = rn.rms_norm_bwd_dx_ref(x, w, g, r)
        torch.cuda.synchronize()
        atol, rtol = OUT_TOL[dtype]
        over = excess(y, y_r, rtol)
        r_rel = float(((r - r_r).abs() / r_r).max())
        dx_rel = rel_err(dx, dx_r)
        tag = f"rms_norm {case} {DTYPE_NAME[dtype]}"
        require(over <= atol, f"{tag}: y {over} over {rtol} |ref|")
        require(r_rel <= 1e-5, f"{tag}: r off by {r_rel} relative")
        require(dx_rel <= GRAD_TOL[dtype], f"{tag}: dx off by {dx_rel}")
        t = dict(
            fwd=time_ms(lambda: rn.rms_norm_fwd(x, w, RMS_EPS)),
            dx=time_ms(lambda: rn.rms_norm_bwd_dx(x, w, g, r)),
            fwd_plain=time_ms(lambda: rn.rms_norm_fwd_ref(x, w, RMS_EPS)),
            dx_plain=time_ms(lambda: rn.rms_norm_bwd_dx_ref(x, w, g, r)),
            lib_fwd=time_ms(lambda: torch.nn.functional.rms_norm(
                x, (hid,), w, RMS_EPS)))
        lx, lw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)

        def lib_fwd_bwd():
            o = torch.nn.functional.rms_norm(lx, (hid,), lw, RMS_EPS)
            torch.autograd.grad(o, (lx, lw), g)

        t["lib_fwd_bwd"] = time_ms(lib_fwd_bwd)
        o = torch.nn.functional.rms_norm(lx, (hid,), lw, RMS_EPS)
        t["lib_bwd"] = time_ms(lambda: torch.autograd.grad(
            o, (lx, lw), g, retain_graph=True))
        elem = x.element_size()
        bounds = dict(
            fwd=bound_ms(elem * (2 * x.numel() + hid) + 4 * n,
                         4.0 * x.numel(), dtype),
            dx=bound_ms(elem * (3 * x.numel() + hid) + 4 * n,
                        6.0 * x.numel(), dtype))
        emit("train_varlen", kernel="rms_norm", case=case, rows=n,
             hidden=hid, dtype=DTYPE_NAME[dtype], y_max_err=max_err(y, y_r),
             y_excess=over, atol=atol, rtol=rtol, r_rel_err=r_rel,
             dx_rel_err=dx_rel, grad_tol=GRAD_TOL[dtype],
             kernel_ms=dict(fwd=t["fwd"], dx=t["dx"]),
             plain_ms=dict(fwd=t["fwd_plain"], dx=t["dx_plain"]),
             library_ms=dict(rms_norm_fwd=t["lib_fwd"],
                             rms_norm_fwd_bwd=t["lib_fwd_bwd"],
                             rms_norm_bwd=t["lib_bwd"]),
             bound_ms={key: val[0] for key, val in bounds.items()},
             bound_by={key: val[1] for key, val in bounds.items()})
        for name, key, err, lib in (
                ("rms_norm_fwd", "fwd", max_err(y, y_r), t["lib_fwd"]),
                ("rms_norm_bwd_dx", "dx", max_err(dx, dx_r), t["lib_bwd"])):
            rows.append(dict(
                kernel=name, dtype=DTYPE_NAME[dtype], case=case,
                max_err=err, kernel_ms=t[key], plain_ms=t[key + "_plain"],
                library_ms=lib, bound_ms=bounds[key][0],
                bound_by=bounds[key][1]))
        del x, g, y, y_r, dx, dx_r, lx, lw, o
        torch.cuda.empty_cache()


def check_varlen_attention(dtype, device, rows):
    """The segment-id variant of the forward, dq and dk/dv kernels on each
    pack (B = 1, the (H, T, D) layout flash_attn_unpadded hands them)
    against their plain twins, run in groups of kv heads; kernel, plain,
    library (SDPA, causal, per document, summed: forward, forward +
    backward, backward alone) and bound times, the bound counting the
    pairs that share a document."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    for case, lens, h, hkv in VARLEN_PACKS:
        t = sum(lens)
        q, do = (_rand(gen, (h, t, HEAD_DIM), dtype, device)
                 for _ in range(2))
        k, v = (_rand(gen, (hkv, t, HEAD_DIM), dtype, device)
                for _ in range(2))
        ids = pack_ids(lens, device)
        seg_q = ids.repeat(h, 1)
        seg_kv = ids.repeat(hkv, 1)
        kw = dict(causal=True, n_heads=h, n_kv_heads=hkv, seg_q=seg_q,
                  seg_kv=seg_kv)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        delta = (out.float() * do.float()).sum(-1)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)

        def plain_fwd():
            return in_kv_groups(lambda qr, kr, n: fa.flash_attention_fwd_ref(
                q[qr], k[kr], v[kr], True, None, n * h // hkv, n, seg_q[qr],
                seg_kv[kr]), h, hkv)

        def plain_dq():
            return in_kv_groups(
                lambda qr, kr, n: fa.flash_attention_bwd_dq_ref(
                    q[qr], k[kr], v[kr], do[qr], lse[qr], delta[qr], True,
                    None, n * h // hkv, n, seg_q[qr], seg_kv[kr]), h, hkv)

        def plain_dkv():
            return in_kv_groups(
                lambda qr, kr, n: fa.flash_attention_bwd_dkv_ref(
                    q[qr], k[kr], v[kr], do[qr], lse[qr], delta[qr], True,
                    None, n * h // hkv, n, seg_q[qr], seg_kv[kr]), h, hkv)

        out_r, lse_r = plain_fwd()
        dq_r, (dk_r, dv_r) = plain_dq(), plain_dkv()
        torch.cuda.synchronize()
        atol, rtol = OUT_TOL[dtype]
        tag = f"{case} {DTYPE_NAME[dtype]}"
        out_excess, lse_err = excess(out, out_r, rtol), max_err(lse, lse_r)
        dq_rel = rel_err(dq, dq_r)
        dkv_rel = max(rel_err(dk, dk_r), rel_err(dv, dv_r))
        require(out_excess <= atol, f"flash fwd seg {tag}: {out_excess} "
                f"over {rtol} |ref|")
        require(lse_err <= LSE_TOL[dtype], f"flash fwd seg {tag}: lse "
                f"{lse_err}")
        require(dq_rel <= GRAD_TOL[dtype], f"flash dq seg {tag}: {dq_rel}")
        require(dkv_rel <= GRAD_TOL[dtype], f"flash dk/dv seg {tag}: "
                f"{dkv_rel}")
        errs = dict(fwd=max(max_err(out, out_r), lse_err),
                    dq=max_err(dq, dq_r),
                    dkv=max(max_err(dk, dk_r), max_err(dv, dv_r)))
        del out_r, lse_r, dq_r, dk_r, dv_r
        torch.cuda.empty_cache()

        bwd = (q, k, v, do, lse, delta)
        tm = dict(
            fwd=time_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw),
                        iters=10, warmup=2),
            dq=time_ms(lambda: fa.flash_attention_bwd_dq(*bwd, **kw),
                       iters=10, warmup=2),
            dkv=time_ms(lambda: fa.flash_attention_bwd_dkv(*bwd, **kw),
                        iters=10, warmup=2),
            fwd_plain=time_ms(plain_fwd, iters=3, warmup=1),
            dq_plain=time_ms(plain_dq, iters=3, warmup=1),
            dkv_plain=time_ms(plain_dkv, iters=3, warmup=1))
        starts = np.cumsum((0,) + lens)
        docs = [tuple(x[:, s0:s0 + n][None] for x in (q, k, v, do))
                for s0, n in zip(starts, lens)]
        tm["sdpa_fwd"] = time_ms(lambda: [sdpa(a, b_, c, is_causal=True)
                                          for a, b_, c, _ in docs],
                                 iters=10, warmup=2)
        leaves = [[x.clone().requires_grad_(True) for x in d[:3]]
                  for d in docs]

        def sdpa_fwd_bwd():
            for ls, d in zip(leaves, docs):
                torch.autograd.grad(sdpa(*ls, is_causal=True), ls, d[3])

        tm["sdpa_fwd_bwd"] = time_ms(sdpa_fwd_bwd, iters=10, warmup=2)
        outs = [sdpa(*ls, is_causal=True) for ls in leaves]
        tm["sdpa_bwd"] = time_ms(lambda: [torch.autograd.grad(
            o, ls, d[3], retain_graph=True) for o, ls, d in zip(
                outs, leaves, docs)], iters=10, warmup=2)
        del docs, leaves, outs

        elem = q.element_size()
        pairs = h * sum(n * (n + 1) // 2 for n in lens)   # same document
        fwd_ops = 4.0 * pairs * HEAD_DIM
        stats = 4 * 2 * h * t                             # lse, delta f32
        ids_bytes = 4 * (h + hkv) * t
        bounds = dict(
            fwd=bound_ms(elem * (2 * q.numel() + k.numel() + v.numel())
                         + 4 * h * t + ids_bytes, fwd_ops, dtype),
            dq=bound_ms(elem * (3 * q.numel() + k.numel() + v.numel())
                        + stats + ids_bytes, 1.5 * fwd_ops, dtype),
            dkv=bound_ms(elem * (2 * q.numel() + 2 * k.numel()
                                 + 2 * v.numel()) + stats + ids_bytes,
                         2.0 * fwd_ops, dtype))
        emit("train_varlen", kernel="flash_attention_seg", case=case,
             doc_lens=list(lens), H=h, Hkv=hkv, D=HEAD_DIM,
             dtype=DTYPE_NAME[dtype], out_excess=out_excess, out_atol=atol,
             out_rtol=rtol, lse_max_err=lse_err, dq_rel_err=dq_rel,
             dkv_rel_err=dkv_rel, grad_tol=GRAD_TOL[dtype],
             causal_pairs_of_the_pack=h * t * (t + 1) // 2,
             pairs_in_documents=pairs,
             kernel_ms=dict(fwd=tm["fwd"], dq=tm["dq"], dkv=tm["dkv"]),
             plain_ms=dict(fwd=tm["fwd_plain"], dq=tm["dq_plain"],
                           dkv=tm["dkv_plain"]),
             library_ms=dict(sdpa_fwd=tm["sdpa_fwd"],
                             sdpa_fwd_bwd=tm["sdpa_fwd_bwd"],
                             sdpa_bwd=tm["sdpa_bwd"]),
             bound_ms={key: val[0] for key, val in bounds.items()},
             bound_by={key: val[1] for key, val in bounds.items()},
             bound_frac={key: bounds[key][0] / tm[key]
                         for key in BOUND_FRAC_KEYS})
        for name, key, lib in (
                ("flash_attention_fwd_seg", "fwd", tm["sdpa_fwd"]),
                ("flash_attention_bwd_dq_seg", "dq", tm["sdpa_bwd"]),
                ("flash_attention_bwd_dkv_seg", "dkv", tm["sdpa_bwd"])):
            rows.append(dict(
                kernel=name, dtype=DTYPE_NAME[dtype], case=case,
                max_err=errs[key], kernel_ms=tm[key],
                plain_ms=tm[key + "_plain"], library_ms=lib,
                bound_ms=bounds[key][0], bound_by=bounds[key][1],
                **frac(bounds, tm, key)))
        del q, k, v, do, out, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import _build

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    emit("build", seconds=_build.build_all(),
         libraries=sorted(_build.sources()), dir=str(_build.build_dir()))

    results = []
    for dtype in (torch.bfloat16, torch.float32):
        for check in (check_flash_prefill, check_generation_prefill,
                      check_paged_attention, check_paged_chunk_attention,
                      check_fused_block_decode,
                      check_public_fused_block_decode,
                      check_fused_multi_block_decode, check_spec_kernels,
                      check_gpt_kernels):
            done = len(results)
            check(dtype, device, results)
            for r in results[done:]:
                emit("kernels", **r)

    counts, serve_paths = run_serve(device)
    gpt_counts = run_gpt(device)
    serve_paths["gpt"] = gpt_counts
    counts = {k: n + gpt_counts.get(k, 0) for k, n in counts.items()}
    run_parity(device)

    train_rows = []
    lse_counts: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        check_flash_attention(dtype, device, train_rows)
        for n, c in check_flash_with_lse(dtype, device).items():
            lse_counts[n] = lse_counts.get(n, 0) + c
    unet_counts = run_unet(device)
    run_unet_parity(device)
    bert_counts = run_bert(device)
    run_bert_parity(device)
    moe_counts = run_moe(device)
    run_moe_parity(device)
    fused_counts = run_fused_layers(device)
    train_counts, train = run_train(device)
    remat_counts = run_train_remat(device, train)
    hybrid_counts, hybrid_coll = run_hybrid(device, train)
    zero_counts = run_zero(device, train, hybrid_coll)
    ep_counts = run_ep(device)             # this slice: ep, sp_recompute,
    sp_counts = run_sp_recompute(device)   # ring_ranks and ep_ranks
    rank_counts = run_rank_phases(train)
    fit_counts = run_fit(device)
    io_counts = run_io(device)
    fit_fault_counts = run_fit_faults(device)
    run_train_parity(device)

    varlen_counts = run_train_varlen(device)
    varlen_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        check_rms_norm(dtype, device, varlen_rows)
        check_varlen_attention(dtype, device, varlen_rows)
    nan_counts = run_nan_check(device)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    summary = []
    for name, (source, replaces) in SOURCES.items():
        if name in TRAIN_KERNELS:
            rows = [r for r in train_rows if r["kernel"] == name
                    and r["dtype"] == "bf16"]
            main_row = rows[0]       # Llama-2-7B heads, S = 4096, bf16
            # this slice's paths: the ring, Ulysses and expert parallelism
            by_path = dict(ring_ranks=rank_counts["ring_ranks"][name],
                           ep=ep_counts[name],
                           ep_ranks=rank_counts["ep_ranks"][name],
                           sp_recompute=sp_counts[name])
            launches = sum(by_path.values())
            by_path.update(
                pipeline_ranks=rank_counts["pipeline_ranks"][name],
                zero=zero_counts[name],
                zero_ranks=rank_counts["zero_ranks"][name],
                hybrid=hybrid_counts[name],
                hybrid_ranks=rank_counts["hybrid_ranks"][name],
                unet=unet_counts[name], bert=bert_counts[name],
                moe=moe_counts[name], train=train_counts[name],
                train_remat=remat_counts[name], fit=fit_counts[name],
                io=io_counts[name], with_lse=lse_counts[name],
                fit_faults=fit_fault_counts[name],
                nan_check=nan_counts[name], fused_layers=fused_counts[name])
        elif name in VARLEN_KERNELS:
            rows = [r for r in varlen_rows if r["kernel"] == name
                    and r["dtype"] == "bf16"]
            main_row = rows[0]       # 7B width / the 8192-token pack, bf16
            launches = varlen_counts[name]
        else:
            rows = [r for r in results if r["kernel"] == name
                    and r["dtype"] == "bf16" and "kernel_ms" in r]
            # the largest serving shape in bf16 (the spec, generation and
            # GPT rows are new shapes beside it)
            main_row = [r for r in rows if "spec" not in r
                        and "generation" not in r and "gpt" not in r
                        and "tp" not in r][-1]
            # every serving phase, then generation and the handoff
            launches = counts[name]
            by_path = {path: c.get(name, 0)
                       for path, c in serve_paths.items()}
        require(launches > 0, f"{name}: no launch on the main paths")
        if name in VARLEN_KERNELS:
            by_path = None
        summary.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches,
            max_abs_err=max(r["max_err"] for r in rows),
            ms=main_row["kernel_ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"],
            **({"bound_frac": main_row["bound_frac"]}
               if "bound_frac" in main_row else {}),
            **({"launches_by_path": by_path} if by_path else {})))
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
