#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. card     — ``nvidia-smi`` name and power limit (also printed raw);
  2. build    — compile every CUDA source under ``kernels/csrc`` from the
                checkout, one ``nvcc`` each, in parallel; each library's
                ``ptxas`` registers and spills, and 0 bytes of spill in
                every ``lstm_forward`` kernel, the three staged gossip
                kernels and the four builds of the two gate kernels
                (``lstm_train``);
  3. kernel   — each kernel against its plain PyTorch twin on the card,
                on distinct seeded per-row weights (max |diff| <= 1e-5,
                TF32 off), at every path ``lstm_cell._plan`` takes
                (weights in registers, in shared memory by TMA or
                cp.async, streamed); a row's output bitwise independent
                of the batch it was launched in (row 5 of a G=64 launch,
                and rows at row-tile edges of the (1, 2034) eval launch,
                against their own R=1 launches; a middle group of the
                sweep's (15, 2034) eval launch against its own G=1
                launch);
  4. serve    — the main path at full width: the REPLACE-BG fast twin
                (N=226 patients), an H=128 population from a seeded
                ``torch.Generator``, buckets 1,4,16,64, 4096 requests
                through ``MicroBatcher`` + ``replay``; every forecast
                bitwise equal to a direct apply and within 1e-5 of the
                plain twin; the kernel's launch count read around it;
  5. narrow   — the committed H=8 checkpoint through the CLI entry point
                (``repro_torch.launch.serve``, width inferred), 256
                requests, ``--selfcheck``;
  6. timing   — at G=64, R=1, H=128, L=12 (one serving batch): the
                kernel, its plain twin and cuDNN's LSTM + Linear on the
                shared population weights (the yardstick; the port never
                calls it), CUDA events, median of >= 50 runs after
                warm-up; and the least time the card could take (bytes
                over 3.35 TB/s, operations over 67 TFLOP/s fp32); the
                same three at the training path's G=1, R=2034 (the
                eval) and R=329 (a patient's test split), each shape
                with its ``_plan``, warm and L2-flushed times, bound and
                bound share;
  7. profile  — ``torch.profiler`` over a replay of 1024 requests: the
                card's busy time and share of the wall time, and the
                largest device items;
  8. gossip   — the four gossip kernels against their plain twins at
                N in {1, 12, 37, 226}, D in {1, 513, 66,689}, active
                ratios 0, 0.3 and 1, on real mixing matrices and (N, 8)
                neighbor tables (max |diff| <= 1e-6); inactive rows
                bitwise copies, also with a NaN planted in an active row;
                two launches bitwise equal; ``gossip_mix``,
                ``gossip_mix_dp`` and ``gossip_mix_sparse_dp`` (staged)
                bitwise equal to the row-wise kernel at every case, and
                also at the largest N each stages and the next;
  9. train    — the training path at full width through the CLI entry
                point (``repro_torch.launch.train.run``): REPLACE-BG
                (N=226) with the sparse kernel, then OhioT1DM (N=12)
                with the dense kernel; H=128, 30% of nodes inactive,
                64 rounds, Adam at 1e-3 and batch 64 (TrainConfig),
                eval every 16 rounds; the data are the 6-day fast twins
                (the round's work does not depend on the series'
                length).  Each run: the gossip-repr the CLI resolved,
                one gossip launch per round, ``lstm_forward`` launches
                for the evals, the last 16 rounds' loss below the first
                16's, the last val RMSE record and every patient's test
                forecasts within 1e-5 of the plain twin on the trained
                population, and the checkpoint served through
                ``load_population`` + ``GlucoseServable`` with a bitwise
                selfcheck; then rounds/s over a 32-round chunk;
 10. dp       — the local-DP training path (``GluADFL`` with
                ``dp_noise_sigma=0.01``, kernel mixer) for 8 rounds at
                each representation, at full width: one launch of the
                fused DP kernel per round;
 11. mixers   — one state and one round's draws through the kernel
                mixer and the tree mixer, both representations, DP off
                and on: the mixed params agree within 1e-6;
 12. gtiming  — each gossip kernel at its main-path shape (sparse:
                N=226, dense: N=12, D=66,689, 30% inactive): CUDA-event
                time, its plain twin, a PyTorch yardstick (dense:
                ``torch.where(act, M @ W, W)``; sparse: ``torch.sparse.mm``
                of the table as a CSR matrix; DP: the same on W + Z
                with the self-restore), and the least time the card
                could take; the three staged kernels timed in turns with
                their row-wise parent (parent, kernel, kernel, parent),
                warm and L2-flushed, and both by ``torch.profiler``'s
                device time (every kernel's device time too); beside
                sparse DP, ``torch.add(W, Z)``, the same bytes read and
                written as one contiguous stream; the staged dense DP
                kernel at each tile of ``DP_TILES``;
 13. tprofile — ``torch.profiler`` over an 8-round chunk of the sparse
                training path: the card's busy time split by the
                trainer's spans (draws, mixing operator, gossip, local
                step, mask, eval, sync) and its share of the wall, and
                the local step's GEMM kernels' own device time;
 14. swa      — the bf16 kernel's ``ptxas`` registers, shared memory
                and spills; ``swa_attention`` against its plain twin at S
                in {128, 256, 1024, 3072} x window in {64, 100, 300, 1024,
                4096} x hd in {64, 128} x H/K in {1, 12} x B in {1, 2},
                fp32 (max |diff| <= 3e-5) and bf16 (<= 5e-2, and
                elementwise within ``ref.swa_bf16_bound`` of the fp32
                twin: the rounding of P and of the output), TF32 off;
                then hd 256 (bf16 on the ``wgmma`` kernel's 64-key
                tiles, fp32 on the scalar kernel), 512, 768, 2,304 and
                4,096 (two passes through a banded score workspace), 96
                and 288 (zero-padded to 128 and 512) at S in {1024,
                3072} x window in {100, 2048}, with 0 bytes of spill in
                the five ``wgmma`` kernels (none of them serialized by
                ptxas), the band builds' four kernels, the three fp32
                one-block kernels (``swa_attention_kernel_bulk``:
                TMA-staged, 8 x 8 register tiles) and the two chunked
                scalar kernels; at RecurrentGemma-9B's local attention
                (B=1, S=8,192, H=16, K=1, window 2048) at its hd 256 and
                at hd 288, 512, 768, 2,048, 2,304 and 4,096 (each
                launch's build checked by name: the one-block builds at
                256, the band builds above) against the fp32
                ``banded_flash_attention``: fp32 within 3e-5, bf16
                elementwise within ``swa_bf16_bound``; at every hd but
                288 in both dtypes its time (bf16 at hd 256 and 512 also
                L2-flushed), the banded path's,
                ``scaled_dot_product_attention``'s and its bound, every
                build above hd 256 required faster than the banded path
                and no slower than SDPA; fp32 at hd 256 beside the
                one-block code it replaced (the chunked build at one
                chunk); at hd 2,304 and 4,096 the band builds beside the
                chunked build they replaced (3 launches), required
                faster, and by pass (the scores alone timed beside
                both); at
                the LM prefill's shape (B=1, S=32,768, H=96, K=8, hd=128,
                window 4096) against the plain ``banded_flash_attention``
                in fp32 on the same inputs (the fp32 build also timed
                there beside the banded path and SDPA in fp32, and at hd
                64 on that shape, a synthetic one): the
                kernel's fp32 build within 3e-5, its bf16 build elementwise within
                ``swa_bf16_bound`` (given the banded path); and against
                the banded path in bf16, as JAX runs it (<= 5e-2); two
                launches bitwise equal;
 15. lmprefill — the third slice at full width: Mistral-Large-123B
                (d=12288, 96 heads, 8 KV heads, d_ff=28672) with its
                depth cut to 4 of 88 layers and the batch to 1 of 32,
                bf16 weights from a seeded ``torch.Generator``, through
                ``repro_torch.arch.build_arch``: ``prefill_fn`` on a
                32,768-token prompt (one ``swa_attention`` launch and one
                banded branch per layer, finite logits, caches of the
                window), then 16 greedy ``decode_fn`` steps; the same
                path at the reduced width (fp32, window 1024, S=3072) on
                the card and on the CPU from the same weights (logits
                within 1e-4, caches within 1e-5, 4 decode steps; one
                launch a layer, all on ``scalar-fp32-hd64``); and the
                ``arch_demo`` CLI on the card;
 16. lmtiming — the kernel at the prefill's shape: CUDA-event time, the
                plain banded twin, ``scaled_dot_product_attention`` with
                a band mask per 1024-row query block (the yardstick; the
                port never calls it), and the least time the card could
                take (bf16 tensor-core peak; the fp32 one beside it),
                the kernel's TFLOP/s and its share of that bound;
                then the prefill's wall time, tokens/s and its device
                time split into the kernel, the GEMMs and the rest, and
                decode steps/s;
 17. personalize — cold-start personalization, then serving, at full
                width: the REPLACE-BG fast twin, an H=128 population
                from a seeded ``torch.Generator``, the last 32 patients
                as a cohort with 24 windows each, fine-tuned by one
                ``GlucoseServable.personalize`` call (100 Adam steps at
                5e-4, batch 24, the servable's defaults, through the
                CLI's ``personalize_cohort``): every patient's last-10
                loss below its first-10; for one patient
                ``personalize`` bitwise ``personalize_loop`` and within
                1e-6 of its batched row (bitwise or not, reported);
                4096 requests mixing personalized and population rows
                through ``MicroBatcher`` + ``replay``, bitwise the
                direct apply and within 1e-5 of the plain twin, the
                ``lstm_forward`` launch count read around it; the
                fine-tune's time (ms a step, patients/s), p50/p99,
                forecasts/s; and ``launch.serve --personalize 4
                --selfcheck`` on the committed H=8 checkpoint;
 18. masked   — ``gossip_impl="masked"`` training at full width:
                REPLACE-BG (N=226, sparse kernel) and OhioT1DM (N=12,
                dense kernel), H=128, 30% inactive, 8 rounds, DP off
                and at sigma=0.01: each masked run bitwise its unmasked
                twin from the same seed (params, optimizer rows,
                history), one gossip launch a round in both; rounds/s
                of each in turns, the ``round.secure_mask`` span's
                device time a round (``torch.profiler``) and peak
                memory; then ``simulate_wires`` at N=37, D=66,689: no
                valid slot of a row with >= 2 of them puts its raw row
                on the wire, and the books balance within 1e-5 of the
                sparse mix;
 19. sweep    — the scenario-sweep engine (``GluADFL.train_sweep``, tree
                mixer): (a) the paper's Fig-5 grid (ring, cluster,
                random x inactive 0, 0.3, 0.5, 0.7, 0.9, seed 0: G=15)
                on the REPLACE-BG fast twin (N=226, sparse) at H=128,
                Adam 1e-3, batch 64, 32 rounds in chunks of 16, eval
                every 16: one ``lstm_forward`` launch (G=15 groups) per
                eval and no gossip kernel launch, finite losses, the
                last 8 rounds' mean loss below the first 8's at every
                ratio <= 0.7, the val records within 1e-5 of the plain
                twin on the same populations, and ring@0.3, cluster@0
                and random@0.7 within 1e-5 of their serial ``train()``
                runs (losses, val records, population; bitwise or not,
                reported); (b) the CLI, ``--sweep-ratios 0,0.3,0.7
                --sweep-seeds 2`` for 16 rounds: 6 summary records
                with the JAX launcher's keys and 226 prediction
                launches (one per patient over the 6 populations); (c)
                OhioT1DM (N=12, dense) with every axis armed (3
                topologies x 0.3, 0.7 x bernoulli, markov x skews 0,
                0.5 x DP sigma 0.01, 0.05: G=48) for 16 rounds, one
                scenario engaging all three axes within 1e-5 of its
                serial twin; (d) ``gossip_impl="masked"`` sweeps
                bitwise the unmasked ones over 4 rounds (REPLACE-BG,
                ring, cluster, random x 0.3: G=3, with peak memory;
                and the OhioT1DM G=48 grid); (e) scenario-rounds/s of
                the G=15 grid over a 16-round chunk, in turns with one
                serial scenario's rounds/s on the tree and the kernel
                mixer, peak memory, the device busy share and span
                split of a profiled 4-round swept chunk, and
                ``lstm_forward`` at the sweep's eval shape (G=15,
                R=2034) timed as phase 6 times the others;
 20. baselines — the paper's baselines (``core.fedavg``, ``core.meta``,
                ``core.supervised``, ``repro_torch.paper``) on the
                REPLACE-BG fast twin (N=226, D=66,689) at H=128, batch
                64: (1) two FedAvg rounds (2 local steps, Adam 2e-3, 30%
                inactive) and two MAML and two MetaSGD meta-steps (3
                second-order inner steps at 1e-2, SGD 2e-2) on the card
                and on the CPU from one set of draws, the change of the
                params (and of MetaSGD's rates) within a relative norm
                of 1e-4, losses within 1e-4 (Adam) / 1e-5 (SGD), and a
                first-order MAML run on the card outside that limit;
                (2) the Table-4 grid
                (``run_baseline_grid``: FedAvg, MAML, MetaSGD, pooled
                LSTM, 32 rounds each) in <= 4 chunks through
                ``chunked.dispatch_chunk``, finite histories, each
                population through ``eval_population`` (226
                ``lstm_forward`` launches each, 904 in all, the counted
                main path), every test forecast within 1e-5 of the plain
                twin; (3) each method's chunk in turns (fedavg, maml,
                metasgd, lstm, then back), rounds / meta-steps / steps
                a second, the peak memory it adds, and a profiled short
                chunk's device time split by the trainers' spans and
                its busy share; (4) Table 4 with all eleven methods on
                OhioT1DM and ABC4D (H=128, 16 rounds, 64 supervised
                steps; the GBT's host fit kept off REPLACE-BG's 220,923
                windows), every seen/unseen metric finite, and Fig 3 on
                OhioT1DM; (5) ``lstm_forward`` at the pooled val set's
                (G=1, R=71,317) timed as phase 6 times the others;
 21. figures  — the paper's Figs 4 and 5 (``repro_torch.paper``) on the
                REPLACE-BG fast twin (N=226) at H=128, batch 64, B=7:
                (a) Fig 4 (ring, cluster, random: G=3) for 32 rounds,
                its mg/dL val RMSE ``eval_fn`` every 8 rounds over the
                71,317 pooled val windows: 3 ``lstm_forward`` launches
                an eval round and no gossip kernel, on the sweep path
                (the counted main path) and on ``--serial``; every
                record within 1e-4 relative of the plain twin's eval of
                the same population and of the serial curve; the swept
                chunk timed with and without the eval in turns; (b) Fig
                5 (the G=15 grid) for 16 rounds, then ``eval_population``
                per scenario: 226 launches each, 3,390 in all, three
                scenarios' forecasts within 1e-5 of the plain twin and
                their metrics those forecasts', the wall split into
                training and eval; (c) the paper driver
                (``repro_torch.paper.run``) at ``--quick``: its eight
                CSV lines and finite results; (d) the four examples
                (``repro_torch.examples``) at their own sizes, each
                with finite results and its wall time;
 22. sharded  — the sharded mixer (``core.distributed``) over a one-rank
                NCCL process group on ``cuda:0`` (a free localhost port;
                the card has no second rank, so the multi-rank
                arithmetic is held on the CPU over gloo by the tests) on
                the REPLACE-BG fast twin (N=226, D=66,689) at H=128,
                batch 64, 30% inactive, random topology, B=7, Adam 1e-3,
                8 rounds with an eval every 4: ``allgather`` on sparse,
                ``allgather``, ``psum`` on dense, ``masked`` and
                ``gather`` on sparse, and ``allgather`` on sparse at DP
                sigma=0.05, each against ``mixer="tree"`` from the same
                generator seed: the node params and optimizer rows
                bitwise (``torch.equal``), the population, losses and
                val records within 1e-6 relative; masked bitwise
                allgather; no gossip kernel and two ``lstm_forward``
                launches (the evals) a run; then rounds/s of each
                schedule beside the tree and kernel mixers, in turns;
                the peak memory of each; a profiled 4-round chunk of
                allgather (sparse) and psum (dense): the ``round.gossip``
                span's device time a round, the kernels in it (the NCCL
                ones named) and the card's busy share; then the CLI,
                ``--mixer sharded --gossip-impl gather --num-processes
                1`` for 4 rounds at H=128 (226 ``lstm_forward`` launches
                for the test forecasts, no gossip kernel);
 23. hybrid   — RecurrentGemma-9B through ``repro_torch.arch.build_arch``
                at full width and full depth (13 super-blocks of rglru,
                rglru, attn: 39 layers; d_model and lru_width 4096, 16
                heads, 1 KV head, hd 256, d_ff 12,288, vocab 256,000,
                window 2048), bf16 weights (~21 GB) from a seeded
                ``torch.Generator`` on the card, nothing cut: two
                prefills of 8,192 tokens at batch 1, bitwise equal and
                finite, each with 13 ``swa_attention`` launches, all on
                the ``wgmma`` hd-256 build (0 on a scalar build), and 13
                banded branches; 16 greedy ``decode_fn`` steps from
                ``init_state``; the prefill's wall (median of 3) and
                decode ms a step; a profiled prefill's device time split
                into GEMMs, ``swa_attention``, the RG-LRU scan (the
                ``rglru.scan`` span) and the rest, with the busy share;
                one attention layer at full width (its weights on a
                normed random input) against ``ref.swa_attention_plain``
                within ``swa_bf16_bound``; and the model at one
                super-block, full width, fp32, on the card against the
                CPU from the same weights at S=4,096 (the banded branch
                on both; logits of the prefill and two decode steps
                within 1e-4);
 24. swept    — the swept-sharded engine (``train_sweep`` with
                ``mixer="sharded"``) on the (1, 1) sweep mesh of a
                one-rank NCCL group on ``cuda:0``
                (``make_sweep_mesh(15, 226)``: its node and grid
                subgroups, one rank each; the multi-rank layouts are held
                on the CPU over gloo by the tests): the Fig-5 grid (G=15)
                on the REPLACE-BG fast twin (N=226, D=66,689) at H=128,
                batch 64, random topology, B=7, Adam 1e-3, 8 rounds with
                an eval every 4, on ``allgather`` sparse, ``psum`` dense,
                ``masked`` sparse and ``allgather`` sparse at a DP sigma
                axis of 0.05, each against the tree sweep from the same
                seeds: node params and optimizer rows bitwise
                (``torch.equal``), populations, losses and val records
                within 1e-6 relative; masked bitwise allgather; one
                ``lstm_forward`` launch of 15 groups an eval and no
                gossip kernel; scenario-rounds/s of each beside the tree
                sweep, in turns; the peak memory of each; a profiled
                4-round chunk of allgather (sparse) and psum (dense): the
                ``round.gossip`` span's device time a round, the kernels
                in it (the NCCL ones named) and the card's busy share;
                then the sweep CLI ``--sweep-ratios 0,0.3,0.7
                --sweep-seeds 2 --mixer sharded --num-processes 1`` for 4
                rounds (226 ``lstm_forward`` launches for the test
                forecasts, finite records, the histories and summary the
                tree CLI's);
 25. zoo      — the rest of the LM zoo's serving families through
                ``build_arch`` at full width, bf16, batch 1, each with
                random weights from a seeded generator: Mixtral-8x22B (4
                of 56 layers; S=32,768; MoE, window 4096 at hd 128),
                Granite-3.0-1B-A400M (24 layers, S=4,096; MoE, full
                attention), Mamba2-370M (48 layers, S=8,192; SSD) and
                Whisper-medium (24 + 24 layers, 1,500 frames and 448
                tokens): for each, the init time, two prefills (bitwise
                equal), the launches and ``gqa_attention`` branches of a
                prefill (Mixtral: 4 ``swa_attention`` launches on the
                ``wgmma-bf16-hd128`` build and 4 banded branches; no
                kernel of ours on the other three), the peak memory, 16
                greedy decode steps (Mixtral, Granite and Mamba2 from the
                prefill's state, Whisper from ``init_state`` with the
                frames; 0 launches), decode ms a step (median of 16),
                the prefill's wall (median of 3) and tokens/s, a profiled
                prefill's device time split into GEMMs,
                ``swa_attention``, the MoE's GEMMs and dispatch (the
                ``moe`` span), the SSD's GEMMs and passes (the
                ``ssm.ssd`` span) and the rest, with the busy share;
                Whisper's ``init_decode_state`` path (the zero encoder
                output) held too; one Mixtral attention layer's
                ``swa_attention`` at S=8,192 against
                ``ref.swa_attention_plain`` within ``swa_bf16_bound``,
                and the kernel timed at the prefill's shape beside the
                banded SDPA; one layer of each config (Whisper: one
                encoder and one decoder layer) at full width in fp32 on
                the card against the CPU from the same weights (logits
                of the prefill and two decode steps within 1e-4); and
                ``arch_demo`` on each config's reduced variant;
 26. train    — the LM zoo's train step (``arch.common.make_train_step``,
                plain PyTorch autograd: JAX's train step reaches no
                Pallas kernel) at Granite-MoE-1B-A400M's full width and
                depth (24 layers, d_model 1024, 16 heads, 8 KV heads, 32
                experts top-8, vocab 49,155; ~1.38 B params) from fp32
                masters (``init_params(..., dtype=float32)``) cast to
                bf16 at each forward, the ``train_4k`` shape (S=4,096)
                with the global batch cut from 256 to 4 in 2
                microbatches, random tokens and labels, Adam at 3e-4:
                4 steps on one fixed batch with every count at 0 before
                them (no kernel of ours launched, 0 ``swa_attention``,
                every layer's flash branch twice a microbatch: forward
                and its rematerialisation), finite losses and grad
                norms, the loss falling from step 1 to 4, every leaf
                moved, finite moments; two forwards of a microbatch
                bitwise equal (the rematerialised forward is the first,
                the MoE's ``scatter_add_`` combine included); ms a step (median of steps 2-4),
                tokens/s, peak memory, and a profiled fifth step's
                device time split and busy share; one train step (M=2,
                lr 1e-3) of a reduced config of each family (Yi-6B,
                Mixtral-8x22B, LLaVA-NeXT, Mamba2, RecurrentGemma-9B,
                Whisper-medium) on the card against the CPU from the
                same params and batch: loss within 1e-5 relative, m
                within 1e-5 of each leaf's max, params within lr·1e-3
                where |g| > 1e-6 and 2·lr elsewhere; at a banded shape
                (S=8,192, window 2048, H=8, K=2, hd 128, bf16) under
                grad ``gqa_attention`` takes ``banded_grad``, its output
                and q, k, v gradients bitwise ``banded_flash_attention``'s
                with no kernel launch, and without grad one
                ``swa_attention`` launch; then on a one-rank NCCL group
                ``gossip_mix_params`` (``allgather``, ``masked``,
                ``psum``) and ``ring_mix_params`` over the trained
                params on ``make_gossip_dp_mesh``'s (1, 1, 1) layout,
                each its input bitwise, and ``GossipDPSchedule``
                (bernoulli, markov) drawing row-stochastic 16-node mixes
                on the card;
 27. dryrun   — the multi-pod dry run (``repro_torch.launch.dryrun``),
                traced in two processes on the CPU, started after phase
                26 so that no timed phase shares the cores with them
                (they see no card): its
                ``build_step`` and tracker on a
                (1, 1) fake mesh at phase 26's train step
                (Granite-MoE-1B-A400M, full width and depth, S=4,096,
                batch 4 in 2 microbatches) must predict the rise of
                ``max_memory_allocated`` above the pre-step baseline of
                that step's first run within 10%; the same pair, with no
                bound, for phase 23's RecurrentGemma-9B prefill and phase
                25's Mixtral prefill (the card launches ``swa_attention``
                there, the trace runs ``banded_flash_attention``); and
                the CLI on the 256-rank production mesh at full width
                and depth for Mistral-Large-123B's ``prefill_32k``,
                ``decode_32k`` and ``long_500k``: status ok, neither JAX
                nor the JAX package imported; each combination's per-rank
                bytes, their share of the card's memory, collective
                counts and seconds;

 28. lstmtrain — run after phase 26 and before phase 27's processes
                start: the trainer's gate kernels (``lstm_gates_fwd``,
                ``lstm_gates_bwd``, ``kernels/lstm_train.py``; they port
                no Pallas kernel) at the benchmark's two cells' shapes
                (N=3,390, B=64, H=128 and N=226, B=64, H=512; L=12,
                I=1): one step of each against its plain twin on the
                same views (gates, c, h, dG, dc within 1e-6; db and dwx
                within 1e-5 of their largest value; the forward bitwise
                or not, reported), each timed (CUDA events, 100 runs)
                beside its byte bound and its twin; then the whole loss
                and gradient
                (``mse_value_and_grad``) by hand against autograd through
                ``apply_nodes``, the path it replaces: L launches of each
                kernel, losses within 1e-6 relative and every leaf
                within 1e-5 of its largest |gradient|, both timed in
                turns (autograd, hand, hand, autograd) beside the
                operations bound, and the memory each adds;

then one ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
non-zero and prints no result, as it does when CUDA is absent or when it
stands alone without the repository.
"""
from __future__ import annotations

import atexit
import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "experiments" / "checkpoints" / "gluadfl_ohiot1dm_ring.npz"
TOL = 1e-5  # fp32 summation order over 12 recurrent steps, H <= 313

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # dense, tensor cores

# (G, R, L, I, H): serving shapes (R=1, L=12, I=1) across widths, one
# multivariate, multi-row, single-step case, and the training path's
# population forward (G=1, H=128): the streaming eval's val windows at
# REPLACE-BG (226 x 9) and OhioT1DM (12 x 170), and the longest
# per-patient test split of the REPLACE-BG fast twin; then each path of
# ``lstm_cell._plan`` at its edges: a ragged last row tile (R = 8 + 1)
# with weights in registers, the largest H a cluster of 8 holds
# (cp.async, H % 4 != 0), the first H that streams, and a cp.async
# slice with L=1, I=3; last, the sweep's eval: the Fig-5 grid's 15
# populations over the REPLACE-BG val windows
SWEEP_EVAL = (15, 2034, 12, 1, 128)
SWEEP_EVAL_GROUP = 7  # a middle group, held bitwise against its own G=1 launch
CASES = [(1, 1, 12, 1, 8), (37, 1, 12, 1, 32), (64, 1, 12, 1, 128),
         (64, 1, 12, 1, 256), (5, 3, 1, 3, 16),
         (1, 2034, 12, 1, 128), (1, 2040, 12, 1, 128), (1, 329, 12, 1, 128),
         (37, 9, 12, 1, 128), (3, 9, 12, 1, 312), (2, 3, 12, 1, 313), (4, 9, 1, 3, 30),
         SWEEP_EVAL]
# rows of the (1, 2034) eval launch held bitwise against their own R=1
# launches: both edges of the first, a middle and the last (ragged) tile
TILE_ROWS = (0, 7, 8, 9, 1015, 1016, 2031, 2032, 2033)
# the kernel's timed shapes: a serving batch, the eval, a test split
LSTM_TIMED = ((64, 1, 12, 1, 128), (1, 2034, 12, 1, 128), (1, 329, 12, 1, 128))

# gossip: fp32 sums of <= B+1 = 8 row-stochastic weights times values
# ~1, the kernel with FMAs against the twin's multiply-then-add
GOSSIP_TOL = 1e-6
COMM_BATCH = 7  # B of Algorithm 1 (FLConfig default): tables of 8 slots
GOSSIP_NODES = (1, 12, 37, 226)
GOSSIP_COLS = (1, 513, 66_689)  # 66,689 = the H=128 LSTM's parameter count
GOSSIP_RATIOS = (0.0, 0.3, 1.0)
# (tile, threads) of the staged gossip_mix_dp timed at its main-path shape
DP_TILES = ((64, 256), (128, 256), (256, 256), (256, 512), (512, 512))
TRAIN_ROUNDS = 64
EVAL_EVERY = 16
# the cold-start cohort: the last 32 REPLACE-BG patients, 24 windows each
PERSONALIZE_COHORT = 32
PERSONALIZE_WINDOWS = 24
# personalize against its row of the batched call: bitwise on the CPU; on
# the card cuBLAS may pick another bmm at batch 1 than at batch 32
PERSONALIZE_ROW_TOL = 1e-6
MASKED_ROUNDS = 8
# phase 19: the Fig-5 grid's run, its serial twins (topology, ratio; seed
# 0), the CLI's grid, the all-axes OhioT1DM grid and its serial twin
SWEEP_ROUNDS, SWEEP_CHUNK, SWEEP_EVAL_EVERY = 32, 16, 16
SWEEP_SERIAL = (("ring", 0.3), ("cluster", 0.0), ("random", 0.7))
SWEEP_TOL = 1e-5
SWEEP_CLI = ["--dataset", "replace-bg", "--fast-data", "--topology", "random",
             "--sweep-ratios", "0,0.3,0.7", "--sweep-seeds", "2", "--rounds", "16"]
SWEEP_AXES = dict(schedules=("bernoulli", "markov"), skews=(0.0, 0.5), dp_sigmas=(0.01, 0.05))
SWEEP_AXES_RATIOS = (0.3, 0.7)
SWEEP_AXES_TWIN = ("cluster", 0.7, "markov", 0.5, 0.05, 0)
SWEEP_SHORT = 16  # rounds of the CLI's and the axes' runs, and of a timed chunk
SWEEP_MASKED_ROUNDS = 4
SWEEP_PROFILED_ROUNDS = 4
DEV = "cuda"
WIRES_NODES = 37
# the wires' books: fp32 sums of <= 8 weighted rows, each a raw row plus
# <= 7 signed unit-normal masks, against the plain sparse mix
WIRES_TOL = 1e-5
# swa_attention: JAX's own tolerances for this kernel (tests/test_kernels.py):
# fp32 sums over <= 4096 keys in another order; bf16 inputs with fp32
# inside on both sides and the output rounded to bf16 (at the prefill's
# shape the plain banded path also rounds scores and probabilities to bf16)
SWA_TOL = {torch.float32: 3e-5, torch.bfloat16: 5e-2}
SWA_SEQS = (128, 256, 1024, 3072)
SWA_WINDOWS = (64, 100, 300, 1024, 4096)
# the head dims beyond the hd 64/128 builds: 256 (bf16 on the wgmma
# kernel's 64-key tiles, fp32 on the scalar kernel), 512, 768, 2,304 and
# 4,096 (the two passes through the band's score workspace), 96
# zero-padded to 128 and 288 to 512
SWA_WIDE = {"seqs": (1024, 3072), "windows": (100, 2048),
            "hds": (256, 512, 96, 288, 768, 2304, 4096)}
HYBRID_ARCH = "recurrentgemma-9b"  # local attention at hd 256, one KV head
HYBRID_SEQ = 8192
# its own hd, one padded to 512, and wider ones: each with the builds it
# must run (fp32, bf16)
HYBRID_BUILDS = {
    256: ("scalar-fp32-hd256", "wgmma-bf16-hd256"),
    **{hd: ("band-scalar-fp32", "band-wgmma-bf16") for hd in (288, 512, 768, 2048, 2304, 4096)},
}
HYBRID_TIMED = (256, 512, 768, 2048, 2304, 4096)
HYBRID_BAND = (2304, 4096)  # timed beside the chunked build they replaced
SWA_CHUNKED_RUNS = 3  # the chunked build takes ~0.5 s a call at hd 2,304, ~1.5 s at 4,096
HYBRID_DECODE_STEPS = 16
HYBRID_TIMED_RUNS = 3
HYBRID_SLICE_SEQ = 4096  # the least S % 1024 == 0 at which window 2048 takes the banded branch
HYBRID_SCAN_SPAN = "rglru.scan"
LM_ARCH = "mistral-large-123b"
LM_LAYERS = 4           # of 88
LM_DECODE_STEPS = 16
LM_SLICE_TOL = {"logits": 1e-4, "caches": 1e-5}  # fp32, card against CPU, 2 layers
# substrings of the names of cuBLAS's GEMM kernels on Hopper
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")
# the trainer's record_function spans, in the order of a round
SPANS = ("round.draws", "round.mixing_operator", "round.gossip", "round.local_step",
         "round.mask", "round.eval", "chunk.sync")
# the masked round's span, inside round.gossip
MASK_SPANS = ("round.secure_mask",)
# phase 20: the Table-4 baselines on the REPLACE-BG fast twin at H=128.
# The grid's rounds (FedAvg rounds, meta-steps, supervised steps); the
# rounds held card against CPU; each method's timed and profiled chunk
# and its spans; the pooled supervised val set's eval shape; the
# datasets of the eleven-method Table 4
BASELINE_ROUNDS = 32
BASELINE_TIMED = {"fedavg": 8, "maml": 4, "metasgd": 4, "lstm": 32}
BASELINE_PROFILED = {"fedavg": 2, "maml": 1, "metasgd": 1, "lstm": 8}
BASELINE_SPANS = {
    "fedavg": ("fedavg.draws", "fedavg.local_step", "fedavg.aggregate", "fedavg.eval",
               "chunk.sync"),
    "maml": ("meta.draws", "meta.inner", "meta.outer", "meta.eval", "chunk.sync"),
    "lstm": ("supervised.draws", "supervised.step", "supervised.eval", "chunk.sync"),
}
BASELINE_SPANS["metasgd"] = BASELINE_SPANS["maml"]
# card against CPU from one set of draws, held on what training changed
# (params - init) by relative norm: FedAvg under Adam (two rounds, each
# of two local steps from a fresh Adam, so each round's second step
# weighs the gradients' sizes, not only their signs), MAML and MetaSGD
# under SGD (the change is the meta-gradient itself, size and all; the
# grid's inner rate 1e-2 and 3 inner steps).  Autograd sums in another
# order on each side (TF32 off): losses within 1e-4 under Adam and 1e-5
# under SGD, as tests/test_torch_gpu.py; changes within a relative norm
# of 1e-4.  A first-order MAML run on the card is read against the CPU's
# second-order one and must fall outside that limit
BASELINE_VS_CPU = {"fedavg": ("adam", 2e-3, 2), "maml": ("sgd", 2e-2, 2),
                   "metasgd": ("sgd", 2e-2, 2)}
VS_CPU_LOSS_TOL = {"adam": 1e-4, "sgd": 1e-5}
VS_CPU_CHANGE_REL = 1e-4
POOLED_EVAL = (1, 71_317, 12, 1, 128)  # REPLACE-BG's pooled val windows, one population
TABLE4_DATASETS = ["ohiot1dm", "abc4d"]
TABLE4_SCALE = dict(hidden=128, rounds=16, sup_steps=64, max_patients=None)
# phase 21: Figs 4 and 5 at REPLACE-BG fast (N=226), H=128, batch 64,
# B=7, through the experiments' own ``run``; Fig 4's curves (mg/dL val
# RMSE) held against the plain twin's eval of the same populations and
# against the serial path by relative difference (the batched and serial
# rows differ by ~2.4e-7 on the card, PR 19); Fig 5's sampled scenarios'
# forecasts as phase 20 holds them; the sweep timed with and without
# the eval in turns; the driver at --quick and the four examples
FIG_SCALE = dict(hidden=128, batch_size=64, max_patients=None)
FIG4_ROUNDS, FIG4_EVAL_EVERY, FIG4_TIMED = 32, 8, 16
FIG4_REL_TOL = 1e-4
FIG5_ROUNDS = 16
FIG5_SAMPLE = (0, 7, 14)  # ring@0, cluster@0.5, random@0.9
DRIVER_LINES = ["fl.gluadfl_round.ring", "fl.gluadfl_round.random", "table2.generalization",
                "table3.supervised", "table4.baselines", "fig3.personalization",
                "fig4.topology", "fig5.async"]
EXAMPLES = {"quickstart": [], "topology_async_ablation": [], "cross_patient": [],
            "serve_arch": []}
SHARDED_ROUNDS = 8
SHARDED_EVAL = 4
# (gossip_impl, gossip_repr, DP sigma) of phase 22; "auto" picks allgather on sparse at N=226
SHARDED_RUNS = (("allgather", "sparse", 0.0), ("allgather", "dense", 0.0), ("psum", "dense", 0.0),
                ("masked", "sparse", 0.0), ("gather", "sparse", 0.0), ("allgather", "sparse", 0.05))
SHARDED_PROFILED = (("allgather", "sparse", 0.0), ("psum", "dense", 0.0))
SHARDED_PROFILED_ROUNDS = 4
# the population (an all_reduce of the row sums over N against the tree
# path's mean), losses and val records: relative, norm-wise
SHARDED_TOL = 1e-6
SHARDED_CLI_ROUNDS = 4
# phase 24: the swept-sharded engine on the (1, 1) sweep mesh of a one-rank
# NCCL group, the Fig-5 grid at REPLACE-BG fast, H=128; its schedules
# (gossip_impl, gossip_repr, DP sigma: an armed dp_sigmas axis), each
# against the tree sweep; the profiled ones; the CLI's grid
SWEPT_DATASET, SWEPT_HIDDEN = "replace-bg", 128
SWEPT_ROUNDS, SWEPT_EVAL = 8, 4
SWEPT_RUNS = (("allgather", "sparse", 0.0), ("psum", "dense", 0.0), ("masked", "sparse", 0.0),
              ("allgather", "sparse", 0.05))
SWEPT_PROFILED = (("allgather", "sparse", 0.0), ("psum", "dense", 0.0))
SWEPT_PROFILED_ROUNDS = 4
# phase 25: (config, layers kept or None for all, prompt tokens, one
# prefill's gqa_attention branches, the prompt of the fp32 one-layer slice)
ZOO = (("mixtral-8x22b", 4, 32_768, {"plain": 0, "flash": 0, "banded": 4, "banded_grad": 0}, 512),
       ("granite-moe-1b-a400m", None, 4_096,
        {"plain": 0, "flash": 24, "banded": 0, "banded_grad": 0}, 4_096),
       ("mamba2-370m", None, 8_192, {"plain": 0, "flash": 0, "banded": 0, "banded_grad": 0}, 2_048),
       ("whisper-medium", None, 448, {"plain": 72, "flash": 0, "banded": 0, "banded_grad": 0}, 448))
ZOO_DECODE_STEPS = 16
ZOO_TIMED_RUNS = 3
# record_function span -> the shares of its GEMMs and of its other items
ZOO_SPANS = {"moe": ("moe_gemm", "moe_dispatch"), "ssm.ssd": ("ssd_gemm", "ssd_passes")}
MIXTRAL_LAYER_SEQ = 8_192  # the attention layer held against the twin, which holds (S, S) scores
# phase 26: Granite-MoE-1B-A400M's train step at full width and depth, the
# train_4k shape with the global batch cut from 256; one reduced config a
# family held card against CPU at one step (the CPU tests' tolerances:
# loss 1e-5 relative, m 1e-5 of each leaf's max, params lr·1e-3 where
# |g| > 1e-6 and 2·lr elsewhere); the banded shape under grad; gossip-DP
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 4_096, 4, 2, 4
TRAIN_SLICES = ("yi-6b", "mixtral-8x22b", "llava-next-mistral-7b", "mamba2-370m",
                "recurrentgemma-9b", "whisper-medium")
TRAIN_SLICE_LR, TRAIN_SLICE_BATCH, TRAIN_SLICE_SEQ = 1e-3, 2, 32
TRAIN_SLICE_TOL = {"loss": 1e-5, "moment": 1e-5, "param": 1e-3, "g_noise": 1e-6}
TRAIN_BANDED = dict(s=8_192, h=8, kh=2, hd=128, window=2_048)  # bf16
GOSSIP_DP_NODES, GOSSIP_DP_MIXES = 16, 4
# phase 27: the dry run's traces, in processes of their own on the CPU
# after the card's timed phases: its memory prediction for three steps the card
# runs (phase 26's train step, phase 23's and phase 25's Mixtral prefills)
# on a (1, 1) fake mesh, and full-width combinations of its CLI on the
# 256-rank production mesh
DRYRUN_OUT = ROOT / "chiprun_out" / "dryrun"
DRYRUN_FIT_TOL = 0.10  # the train step's predicted rise against the allocator's
DRYRUN_CLI = ["--arch", "mistral-large-123b", "--shape", "prefill_32k", "--shape", "decode_32k",
              "--shape", "long_500k", "--jobs", "3"]
DRYRUN_REQUIRED = ("prefill_32k", "decode_32k")
DRYRUN_WAIT_S = 600
# the card's rise above the pre-step baseline, filled by phases 23, 25, 26
MEASURED_RISE: dict[str, dict[str, int]] = {}
# phase 28: the trainer's gate kernels at the benchmark's two cells' shapes,
# (N, B, L, I, H): the Fig-5 sweep's G*N rows at H=128, one federation at
# H=512; their tolerances against the twins and of the hand-written
# gradient against autograd (fp32 sums in another order), as the tests'
LSTM_TRAIN_SHAPES = {"fig5_sweep.replace-bg-h128": (3390, 64, 12, 1, 128),
                     "train_sparse.replace-bg-h512": (226, 64, 12, 1, 512)}
LSTM_GATES_ATOL, LSTM_GATE_SUMS_RTOL, LSTM_VG_RTOL = 1e-6, 1e-5, 1e-5
# every trained window's length L: each local step of the LSTM launches
# each gate kernel L times
LSTM_STEPS = 12
GATE_KERNELS = ("lstm_gates_fwd", "lstm_gates_bwd")
SWEPT_CLI = ["--fast-data", "--topology", "random", "--sweep-ratios", "0,0.3,0.7",
             "--sweep-seeds", "2", "--rounds", "4"]


def require(cond, what) -> None:
    """Fail the run (an ``assert`` that ``-O`` cannot remove)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def random_inputs(gen: torch.Generator, g, r, steps, isz, hsz):
    """Distinct per-row weights at the model's init scales."""
    def normal(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).cuda()

    return (
        normal(g, r, steps, isz),
        normal(g, isz, 4 * hsz, scale=1 / math.sqrt(isz)),
        normal(g, hsz, 4 * hsz, scale=1 / math.sqrt(hsz)),
        normal(g, 4 * hsz, scale=0.5),
        normal(g, hsz, 1, scale=1 / math.sqrt(hsz)),
        normal(g, 1, scale=0.5),
    )


def time_ms(fn, runs: int, flush: torch.Tensor | None = None, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``runs`` CUDA-event pairs,
    after ``warmup`` calls; with ``flush``, the L2 is overwritten before each.
    A spin kernel (~0.2 s) holds the card while the host queues the runs,
    so the events time the card and not the host's launch overhead, as
    long as queueing takes less than the spin (a host-bound ``fn``, such
    as the plain twin's ~9,000 small launches, still times the host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(350_000_000)  # cycles of the SM clock
    pairs = []
    for _ in range(runs):
        if flush is not None:
            flush.add_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in pairs)


def device_us(fn, runs: int = 50) -> float:
    """Device time of one call of ``fn`` in microseconds, from
    ``torch.profiler``: its kernels' device time over ``runs`` calls
    after one warm-up, divided by ``runs`` -- without the few
    microseconds of launch and event overhead that ``time_ms`` counts
    for a kernel that short."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                for e in prof.key_averages())
    return total / runs


def lstm_forward_cost(x, wx, wh, b, w_out, b_out) -> tuple[float, float]:
    """Bytes (each input read once, the output written once) and
    operations of one ``lstm_forward`` call: the gate and head FMAs as 2
    each, the two adds per gate column, and 4 per unit for the c/h
    update (the 5 transcendentals per unit are not counted)."""
    g, r, steps, isz = x.shape
    hsz = wh.shape[1]
    nbytes = 4 * (sum(t.numel() for t in (x, wx, wh, b, w_out, b_out)) + g * r)
    per_step = 2 * (isz + hsz) * 4 * hsz + 2 * 4 * hsz + 4 * hsz
    ops = g * r * (steps * per_step + 2 * hsz + 1)
    return nbytes, ops


def gossip_inputs(gen: torch.Generator, n: int, d: int, ratio: float):
    """Seeded (N, D) params and DP noise, an active mask, and the round's
    mixing matrix and neighbor table from a random topology."""
    from repro_torch.core.topology import mixing_matrix, neighbor_table, random_adjacency

    w = torch.randn((n, d), generator=gen, device="cuda")
    z = 0.01 * torch.randn((n, d), generator=gen, device="cuda")
    act = (torch.rand(n, generator=gen, device="cuda") >= ratio).float()
    if n > 1:
        adj = random_adjacency(torch.rand((n, n), generator=gen, device="cuda"),
                               min(COMM_BATCH, n - 1))
    else:
        adj = torch.zeros((1, 1), device="cuda")
    idx, wgt = neighbor_table(adj, act, COMM_BATCH)
    return w, z, act, mixing_matrix(adj, act, COMM_BATCH), idx, wgt


def gossip_calls(w, z, act, mix, idx, wgt):
    """(name, kernel wrapper, plain twin, args) for the four kernels."""
    from repro_torch.kernels import gossip_mix as gk
    from repro_torch.kernels import ref

    return [
        ("gossip_mix", gk.gossip_mix, ref.gossip_mix_plain, (mix, w, act)),
        ("gossip_mix_sparse", gk.gossip_mix_sparse, ref.gossip_mix_sparse_plain,
         (idx, wgt, w, act)),
        ("gossip_mix_dp", gk.gossip_mix_dp, ref.gossip_mix_dp_plain, (mix, w, z, act)),
        ("gossip_mix_sparse_dp", gk.gossip_mix_sparse_dp, ref.gossip_mix_sparse_dp_plain,
         (idx, wgt, w, z, act)),
    ]


def rowwise_calls(w, z, act, mix, idx, wgt):
    """name -> (the row-wise parent wrapper, args) of the three kernels
    with a staged design."""
    from repro_torch.kernels import gossip_mix as gk

    return {"gossip_mix": (gk.gossip_mix_rowwise, (mix, w, act)),
            "gossip_mix_dp": (gk.gossip_mix_dp_rowwise, (mix, w, z, act)),
            "gossip_mix_sparse_dp": (gk.gossip_mix_sparse_dp_rowwise, (idx, wgt, w, z, act))}


def staged_limit(name: str, slots: int) -> int:
    """The largest N at which ``name`` runs the staged kernel (the pure
    plan; D does not enter)."""
    from repro_torch.kernels import gossip_mix as gk

    return max(n for n in range(1, 1200) if gk._plan(name, n, slots, 1).design == "staged")


def dp_tile_sweep(w, z, act, mix, want) -> dict[str, dict[str, float]]:
    """The staged ``gossip_mix_dp`` kernel at each (tile, threads) of
    DP_TILES, launched through its C entry point (not the wrapper, so
    uncounted): bitwise ``want`` at each, then its CUDA-event time and
    profiler device time -- what ``STAGED_TILE`` was chosen from."""
    from repro_torch.kernels import gossip_mix as gk

    launch = gk._fn("gossip_mix_dp_launch")
    out = torch.empty_like(w)
    n, d = w.shape
    sweep = {}
    for tile, threads in DP_TILES:
        def call():
            stream = torch.cuda.current_stream().cuda_stream
            err = launch(mix.data_ptr(), w.data_ptr(), z.data_ptr(), act.data_ptr(),
                         out.data_ptr(), n, d, tile, threads, stream)
            require(err == 0, f"gossip_mix_dp at T={tile}, {threads} threads: cudaError {err}")

        out.fill_(float("nan"))
        call()
        require(torch.equal(out.view(torch.int32), want.view(torch.int32)),
                f"gossip_mix_dp at T={tile}, {threads} threads: not bitwise the wrapper's")
        sweep[f"T={tile}/threads={threads}"] = dict(ms=time_ms(call, 200), device_us=device_us(call))
    return sweep


def gossip_library(name, w, z, act, mix, idx, wgt):
    """The PyTorch yardstick for one gossip kernel (timed, never used by
    the port): dense ``torch.where(act, M @ W, W)``; sparse
    ``torch.sparse.mm`` of the table as a CSR matrix; the DP variants
    the same on ``W + Z`` with the clean-self restore."""
    n = w.shape[0]
    keep = act[:, None] > 0
    if name in ("gossip_mix", "gossip_mix_dp"):
        if name == "gossip_mix":
            return lambda: torch.where(keep, mix @ w, w)
        diag = torch.diagonal(mix)[:, None]
        return lambda: torch.where(keep, mix @ (w + z) - diag * z, w)
    from repro_torch.core.topology import densify_neighbor_table

    # a well-formed CSR matrix: sorted columns, the zero-weight padding
    # slots dropped
    table = densify_neighbor_table(idx, wgt).to_sparse_csr()
    if name == "gossip_mix_sparse":
        return lambda: torch.where(keep, torch.sparse.mm(table, w), w)
    self_w = wgt[:, :1]
    return lambda: torch.where(keep, torch.sparse.mm(table, w + z) - self_w * z, w)


def gossip_cost(name, w, act, idx) -> tuple[float, float]:
    """Bytes (each input read once, the output written once) and the
    operations this run's data needs: an FMA (2 operations) per weight
    and column of each ACTIVE row (inactive rows are copies), plus for
    DP one add per weight and column and the restore's multiply-add."""
    n, d = w.shape
    rows = float(act.sum())
    sparse = "sparse" in name
    dp = name.endswith("_dp")
    slots = idx.shape[1] if sparse else n
    table = n * slots * 8 if sparse else n * n * 4
    nbytes = 4 * n * d * (3 if dp else 2) + table + 4 * n
    ops = rows * d * (2 * slots + (slots + 2 if dp else 0))
    return nbytes, ops


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def swa_cost(q: torch.Tensor, k: torch.Tensor, window: int) -> tuple[float, float]:
    """Bytes (q, k, v read once, o written once) and operations of one
    ``swa_attention`` call: 4 hd per (query, key) pair in the band (the
    two products' multiply-adds; the softmax is not counted)."""
    b, s, h, hd = q.shape
    w = min(window, s)
    pairs = w * (w + 1) // 2 + (s - w) * w  # per (batch, head)
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return nbytes, 4.0 * hd * pairs * b * h


def swa_inputs(gen: torch.Generator, b, s, h, kh, hd, dtype):
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))


def band_sdpa(q, k, v, window: int, block: int = 1024):
    """The PyTorch yardstick for ``swa_attention`` (timed, never used by
    the port): ``scaled_dot_product_attention`` once per ``block`` query
    rows, over that block's band of keys with a boolean band mask, the
    KV heads repeated to H beforehand.  Returns the call; its output is
    (B, H, S, hd)."""
    s, h = q.shape[1], q.shape[2]
    rep = h // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    kv_blocks = -(-window // block) + 1
    pos = torch.arange(s, device=q.device)
    calls = []
    for i in range(s // block):
        lo, hi = max(i - kv_blocks + 1, 0) * block, (i + 1) * block
        qp, kp = pos[i * block:hi, None], pos[None, lo:hi]
        calls.append((slice(i * block, hi), slice(lo, hi), (kp <= qp) & (kp > qp - window)))

    def run():
        return torch.cat([torch.nn.functional.scaled_dot_product_attention(
            qt[:, :, rows], kt[:, :, keys], vt[:, :, keys], attn_mask=mask)
            for rows, keys, mask in calls], dim=2)

    return run


def launched_build(before: dict[str, int]) -> str:
    """The one ``swa_attention`` build launched since ``before``, a copy
    of ``BUILD_LAUNCHES``."""
    from repro_torch.kernels import swa_attention as swa_kernel

    ran = [b for b, n in swa_kernel.BUILD_LAUNCHES.items() if n != before.get(b, 0)]
    require(len(ran) == 1, f"swa_attention builds launched: {ran}")
    return ran[0]


def swa_chunked(q, k, v, window: int) -> torch.Tensor:
    """The chunked scalar build (hd / 256 chunks, each recomputing the
    scores over the whole head dim), which the C entry still runs for a
    split the wrapper never sends: the code ``scalar-fp32-hd256`` replaced
    (fp32 at one chunk) and the code the band builds replaced above hd
    2,048, in q's dtype.  Timed beside the builds, never counted."""
    from repro_torch.kernels import swa_attention as swa_kernel

    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    err = swa_kernel._fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
                           k.shape[2], hd, window, hd ** -0.5, int(q.dtype == torch.bfloat16),
                           swa_kernel.CHUNKS, torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"the chunked build failed to launch: cudaError {err}")
    return out


def swa_band(q, k, v, window: int, passes: int = 3) -> torch.Tensor:
    """The band build through its C entry, ``passes`` 1 for the scores
    alone: timed by pass, never counted."""
    from repro_torch.kernels import swa_attention as swa_kernel

    out = torch.empty_like(q)
    err = swa_kernel._launch_band(q, k, v, out, window=window, scale=q.shape[-1] ** -0.5,
                                  stream=torch.cuda.current_stream().cuda_stream, passes=passes)
    require(err == 0, f"the band build failed to launch: cudaError {err}")
    return out


def swa_timing(q, k, v, window: int, ops_per_s: float, runs: int = 20) -> dict:
    """``swa_attention`` at one shape: its CUDA-event time (``runs``
    launches), the plain banded path's, :func:`band_sdpa`'s (and its
    distance from the kernel), and the least time the card could take at
    ``ops_per_s``."""
    from repro_torch.kernels import swa_attention as swa_kernel
    from repro_torch.nn import attention as attn

    call = lambda: swa_kernel.swa_attention(q, k, v, window=window)  # noqa: E731
    library = band_sdpa(q, k, v, window)
    nbytes, ops = swa_cost(q, k, window)
    row = dict(ms=time_ms(call, runs),
               plain_ms=time_ms(lambda: attn.banded_flash_attention(q, k, v, window=window),
                                max(3, runs // 4), warmup=1),
               library_ms=time_ms(library, max(5, runs // 2), warmup=2),
               library_max_abs_err=float((library().transpose(1, 2).float()
                                          - call().float()).abs().max()))
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, ops_per_s)
    row.update(bound_share=row["bound_ms"] / row["ms"], tflop_per_s=ops / (row["ms"] * 1e-3) / 1e12)
    return row


def ptxas_report(log: str, *needles: str) -> dict[str, list[str]]:
    """``ptxas -v`` lines (registers, shared memory, spills) of each entry
    function of a build log whose (mangled) name holds every one of
    ``needles``, and under "warnings" any line that says the compiler
    serialized ``wgmma``."""
    found: dict[str, list[str]] = {}
    name = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif "wgmma.mma_async" in line or "Performance Loss" in line:
            found.setdefault("warnings", []).append(line.strip())
        elif name and all(n in name for n in needles) and ("registers" in line or "spill" in line):
            found.setdefault(name, []).append(line.strip())
    return found


def spill_free(report: dict[str, list[str]]) -> bool:
    """Every kernel of a :func:`ptxas_report` reports 0 bytes of spill."""
    spills = [ln for name, lines in report.items() if name != "warnings"
              for ln in lines if "spill" in ln]
    return bool(spills) and all("0 bytes spill stores, 0 bytes spill loads" in ln for ln in spills)


def cudnn_lstm(wx, wh, b, w_out, b_out):
    """cuDNN's ``torch.nn.LSTM`` + ``nn.Linear`` holding one weight set
    (wx (I, 4H), wh (H, 4H), b (4H,), w_out (H, 1), b_out (1,)): the
    yardstick for ``lstm_forward`` at G=1 or on shared weights, which
    the port never calls.  Returns x (R, L, I) -> y (R,)."""
    isz, hsz = wx.shape[0], wh.shape[0]
    with torch.no_grad():
        lstm = torch.nn.LSTM(isz, hsz, batch_first=True).cuda()
        head = torch.nn.Linear(hsz, 1).cuda()
        lstm.weight_ih_l0.copy_(wx.T)
        lstm.weight_hh_l0.copy_(wh.T)
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
        head.weight.copy_(w_out.T)
        head.bias.copy_(b_out)

    def run(xs):
        with torch.no_grad():
            out, _ = lstm(xs)
            return head(out[:, -1])[:, 0]

    return run


def served_vs_plain(sv, reqs, preds: dict[int, float]) -> float:
    """The largest |served forecast - the plain twin's| over a replay,
    each store row's requests as one plain forward under that row."""
    from repro_torch.kernels.ref import lstm_forward_plain

    err = 0.0
    for row in sorted({r.patient for r in reqs}):
        mine = [r for r in reqs if r.patient == row]
        params = sv.params_rows([row])
        x = torch.tensor(np.stack([r.window for r in mine]), device="cuda")[None, :, :, None]
        ref = lstm_forward_plain(x, params["wx"], params["wh"], params["b"],
                                 params["w_out"], params["b_out"])[0].cpu()
        got = torch.tensor([preds[r.rid] for r in mine])
        err = max(err, float((got - ref).abs().max()))
    return err


def reset_launches() -> None:
    """Every kernel's launch count to 0, just before a path runs."""
    from repro_torch.kernels import gossip_mix as gk
    from repro_torch.kernels import lstm_cell, lstm_train, swa_attention

    lstm_cell.LAUNCHES = 0
    swa_attention.LAUNCHES = 0
    swa_attention.BUILD_LAUNCHES.clear()
    for counter in (gk.LAUNCHES, lstm_train.LAUNCHES):
        for k in counter:
            counter[k] = 0


def launches() -> dict[str, int]:
    from repro_torch.kernels import gossip_mix as gk
    from repro_torch.kernels import lstm_cell, lstm_train, swa_attention

    return {"lstm_forward": lstm_cell.LAUNCHES, **gk.LAUNCHES, **lstm_train.LAUNCHES,
            "swa_attention": swa_attention.LAUNCHES}


def others(counts: dict[str, int]) -> int:
    """Launches of every kernel but the trainer's two gate kernels."""
    return sum(v for k, v in counts.items() if k not in GATE_KERNELS)


def hand_steps(counts: dict[str, int], what: str, want: int | None = None) -> int:
    """The local steps a run took through the LSTM's hand-written
    gradient, each L launches of both gate kernels: ``want`` of them, or
    at least one where ``want`` is None (a driver whose local steps the
    smoke does not reckon).  Returns the count."""
    fwd, bwd = (counts[k] for k in GATE_KERNELS)
    steps = fwd // LSTM_STEPS
    require(fwd == bwd == steps * LSTM_STEPS and (steps > 0 if want is None else steps == want),
            f"{what}: gate kernel launches {fwd} and {bwd}, want {LSTM_STEPS} of each a local "
            f"step and {'some' if want is None else want} local steps")
    return steps


def _is_annotation(e) -> bool:
    """A span's range on the device timeline, not a kernel or copy."""
    return getattr(e, "is_user_annotation", False) or e.name in SPANS + MASK_SPANS


def span_breakdown(prof, spans=SPANS) -> tuple[dict[str, float], dict[str, float], float, int]:
    """Device busy time (ms) of one profile, split by the trainer's
    ``spans``: each device kernel or copy goes to the span whose range
    on the device timeline holds its start ("other" if none).  Also the
    same split of the GEMM kernels alone (a "gemm" in the kernel's
    name), the total, and the number of device kernels and copies.
    Spans not in ``spans`` are neither ranges nor work: no user
    annotation (a span's range on the device timeline, the nested
    ``step.*`` ones too) counts as work."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in on_device if e.name in spans]
    busy = dict.fromkeys(spans + ("other",), 0.0)
    gemm = dict.fromkeys(spans + ("other",), 0.0)
    work = [e for e in on_device if not _is_annotation(e) and e.name not in spans]
    for e in work:
        start = e.time_range.start
        owner = next((name for name, lo, hi in ranges if lo <= start < hi), "other")
        busy[owner] += (e.time_range.end - start) / 1e3
        if "gemm" in e.name.lower():
            gemm[owner] += (e.time_range.end - start) / 1e3
    return busy, gemm, sum(busy.values()), len(work)


def span_items(prof, span: str) -> dict[str, float]:
    """Device time (ms) by kernel or copy name of the items whose start
    lies inside ``span``'s ranges on the device timeline (the rule of
    :func:`span_breakdown`)."""
    from torch.autograd import DeviceType

    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = [(e.time_range.start, e.time_range.end) for e in on_device if e.name == span]
    items: dict[str, float] = {}
    for e in on_device:
        if _is_annotation(e):
            continue
        if any(lo <= e.time_range.start < hi for lo, hi in ranges):
            items[e.name] = items.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return items


def rel_diff(a, b) -> float:
    """``||a - b|| / ||b||`` of two sequences or tensors (0 when both are 0)."""
    a = torch.as_tensor(a, dtype=torch.float64).reshape(-1)
    b = torch.as_tensor(b, dtype=torch.float64).reshape(-1)
    den = float(torch.linalg.vector_norm(b))
    num = float(torch.linalg.vector_norm(a - b))
    return num / den if den else num


def sweep_phase(feds, card: str, flush: torch.Tensor, errs: list) -> dict:
    """Phase 19, the scenario-sweep engine; returns the ``lstm_forward``
    row's fields for the sweep's eval (its launches on the main path,
    its times at the (15, 2034) shape)."""
    from repro_torch.config import FLConfig, SweepConfig
    from repro_torch.core import GluADFL, SweepGrid, choose_gossip_repr
    from repro_torch.kernels import lstm_cell
    from repro_torch.kernels.ref import lstm_forward_plain
    from repro_torch.launch.train import run as train_run
    from repro_torch.launch.train import val_windows
    from repro_torch.metrics import all_metrics
    from repro_torch.models import LSTMModel
    from repro_torch.optim import get_optimizer

    def trainer(n, *, topology="random", ratio=0.0, mixer="tree", impl="allgather", sigma=0.0,
                **fl):
        return GluADFL(LSTMModel(hidden=128).as_model(), get_optimizer("adam", 1e-3),
                       FLConfig(topology=topology, num_nodes=n, inactive_ratio=ratio, **fl),
                       mixer=mixer, gossip_impl=impl,
                       gossip_repr=choose_gossip_repr(n, COMM_BATCH), dp_noise_sigma=sigma,
                       device=DEV)

    def sync():
        if DEV == "cuda":
            torch.cuda.synchronize()

    start = {}

    def reset_peak():
        sync()
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
            start["bytes"] = torch.cuda.memory_allocated()

    def peak_gb():
        """The peak since :func:`reset_peak`, and how far it rose above
        what earlier phases still held then, in GB."""
        if DEV != "cuda":
            return None
        peak = torch.cuda.max_memory_allocated()
        return {"peak": peak / 1e9, "added": (peak - start["bytes"]) / 1e9}

    def against_serial(data, pops, hists, states, g, twin, rounds, **kw):
        """Scenario g of a sweep against its serial run from a generator
        seeded with its seed (0): the largest loss, val and population
        differences, and whether the params and the history are bitwise
        the scenario's (a static topology's serial run mixes over its
        candidates' shorter table, so its sums may differ in the last
        bit)."""
        pop, hist, state = twin.train(torch.Generator(device=DEV).manual_seed(0), data.x, data.y,
                                      data.counts, batch_size=64, rounds=rounds, **kw)
        loss = max(abs(a["loss"] - b["loss"]) for a, b in zip(hist, hists[g]))
        val = max((abs(a["val_rmse"] - b["val_rmse"]) for a, b in zip(hist, hists[g])
                   if "val_rmse" in a), default=0.0)
        population = max(float((pop[k] - pops[k][g]).abs().max()) for k in pop)
        return dict(loss_max_abs_diff=loss, val_rmse_max_abs_diff=val,
                    population_max_abs_diff=population,
                    params_max_abs_diff=float((state.params - states.params[g]).abs().max()),
                    params_bitwise=torch.equal(state.params, states.params[g]),
                    history_bitwise=hist == hists[g])

    # (a) the Fig-5 grid through the API (the main path) ---------------------
    fed = feds["replace-bg"]
    n = fed.num_nodes
    fig5 = SweepConfig()
    grid = SweepGrid.build(fig5.topologies, fig5.inactive_ratios, fig5.seed_list(), num_nodes=n)
    vx, vy = val_windows(fed)
    swept = trainer(n)
    reset_peak()
    reset_launches()
    t0 = time.perf_counter()
    pops, hists, states = swept.train_sweep(fed.x, fed.y, fed.counts, grid=grid, batch_size=64,
                                            rounds=SWEEP_ROUNDS, chunk=SWEEP_CHUNK,
                                            eval_every=SWEEP_EVAL_EVERY, val_data=(vx, vy))
    sync()
    run_s = time.perf_counter() - t0
    counts = launches()
    evals = SWEEP_ROUNDS // SWEEP_EVAL_EVERY
    require(counts["lstm_forward"] == evals and others(counts) == evals,
            f"Fig-5 sweep: launches {counts}, want {evals} of lstm_forward and no gossip or "
            f"attention kernel")
    hand_steps(counts, "Fig-5 sweep", SWEEP_ROUNDS)
    run_peak = peak_gb()
    losses = np.array([[h["loss"] for h in hist] for hist in hists])
    require(losses.shape == (grid.size, SWEEP_ROUNDS) and np.isfinite(losses).all(),
            "Fig-5 sweep: losses")
    first, last = losses[:, :8].mean(axis=1), losses[:, -8:].mean(axis=1)
    names = [f"{lab[0]}@{lab[1]}" for lab in grid.labels]
    slow = [names[g] for g in range(grid.size)
            if grid.labels[g][1] <= 0.7 and last[g] >= first[g]]
    require(not slow, f"Fig-5 sweep: the loss did not fall in {slow}")
    xs = torch.as_tensor(vx, device=DEV)[None, :, :, None].expand(grid.size, -1, -1, -1)
    plain = lstm_forward_plain(xs.contiguous(), *(pops[k].contiguous()
                                                  for k in ("wx", "wh", "b", "w_out", "b_out")))
    plain_rmse = torch.sqrt(torch.mean(torch.square(plain - torch.as_tensor(vy, device=DEV)),
                                       dim=1)).tolist()
    val_err = max(abs(plain_rmse[g] - hists[g][-1]["val_rmse"]) for g in range(grid.size))
    require(val_err <= TOL, f"Fig-5 sweep: val RMSE records vs the plain twin: {val_err}")
    errs.append(val_err)
    serial = {}
    for topo, ratio in SWEEP_SERIAL:
        g = grid.labels.index((topo, ratio, 0))
        serial[names[g]] = cmp = against_serial(
            fed, pops, hists, states, g, trainer(n, topology=topo, ratio=ratio), SWEEP_ROUNDS,
            chunk=SWEEP_CHUNK, eval_every=SWEEP_EVAL_EVERY, val_data=(vx, vy))
        require(max(cmp["loss_max_abs_diff"], cmp["val_rmse_max_abs_diff"],
                    cmp["population_max_abs_diff"]) <= SWEEP_TOL,
                f"Fig-5 sweep: {names[g]} vs its serial run: {cmp}")
    emit("sweep", dataset=fed.name, nodes=n, hidden=128, scenarios=grid.size,
         gossip_repr=swept.plan.gossip_repr, rounds=SWEEP_ROUNDS, chunk=SWEEP_CHUNK,
         launches=counts, scenario_rounds_per_s_whole_run=grid.size * SWEEP_ROUNDS / run_s,
         memory_gb=run_peak, loss_first8=dict(zip(names, first.tolist())),
         loss_last8=dict(zip(names, last.tolist())), val_rmse_vs_plain_max_abs_err=val_err,
         serial=serial, tol=SWEEP_TOL, nvidia_smi=card)

    # (b) the CLI -----------------------------------------------------------
    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        run = train_run([*SWEEP_CLI, "--hidden", "128", "--device", DEV,
                         "--out", str(ROOT / "build" / "chip_smoke")])
    cli_counts = launches()
    records = json.loads(run.checkpoint.read_text())
    keys = {"topology", "inactive_ratio", "schedule", "skew", "dp_sigma", "seed", "final_loss",
            *all_metrics(np.array([100.0, 120.0]), np.array([110.0, 118.0]))}
    require(len(records) == 6 and all(set(r) == keys for r in records),
            f"sweep CLI: {len(records)} records, keys {[sorted(r) for r in records[:1]]}")
    require(all(math.isfinite(r["final_loss"]) and math.isfinite(r["rmse"]) for r in records),
            "sweep CLI: non-finite records")
    require(cli_counts["lstm_forward"] == n and others(cli_counts) == n,
            f"sweep CLI: launches {cli_counts}, want {n} lstm_forward (one per patient)")
    hand_steps(cli_counts, "sweep CLI", int(SWEEP_CLI[SWEEP_CLI.index("--rounds") + 1]))
    emit("sweep_cli", argv=SWEEP_CLI, records=len(records), launches=cli_counts,
         summary=[{k: r[k] for k in ("inactive_ratio", "seed", "final_loss", "rmse", "mard")}
                  for r in records], seconds=run.seconds)

    # (c) OhioT1DM with every axis armed -------------------------------------
    ohio = feds["ohiot1dm"]
    grid48 = SweepGrid.build(fig5.topologies, SWEEP_AXES_RATIOS, (0,),
                             num_nodes=ohio.num_nodes, **SWEEP_AXES)
    axes_trainer = trainer(ohio.num_nodes)
    t0 = time.perf_counter()
    pops48, hists48, states48 = axes_trainer.train_sweep(
        ohio.x, ohio.y, ohio.counts, grid=grid48, batch_size=64, rounds=SWEEP_SHORT)
    sync()
    axes_s = time.perf_counter() - t0
    require(grid48.size == 48 and all(math.isfinite(h["loss"]) for hist in hists48 for h in hist),
            "all-axes sweep: losses")
    topo, ratio, sched, skew, sigma, _ = SWEEP_AXES_TWIN
    twin = against_serial(ohio, pops48, hists48, states48, grid48.labels.index(SWEEP_AXES_TWIN),
                          trainer(ohio.num_nodes, topology=topo, ratio=ratio, sigma=sigma,
                                  schedule=sched, data_skew=skew), SWEEP_SHORT)
    require(max(twin["loss_max_abs_diff"], twin["population_max_abs_diff"]) <= SWEEP_TOL,
            f"all-axes sweep: {SWEEP_AXES_TWIN} vs its serial twin: {twin}")
    emit("sweep_axes", dataset=ohio.name, nodes=ohio.num_nodes, scenarios=grid48.size,
         gossip_repr=axes_trainer.plan.gossip_repr, rounds=SWEEP_SHORT,
         scenario_rounds_per_s=grid48.size * SWEEP_SHORT / axes_s, twin=SWEEP_AXES_TWIN,
         vs_serial=twin, tol=SWEEP_TOL)

    # (d) masked sweeps, bitwise the unmasked ones ---------------------------
    grid3 = SweepGrid.build(fig5.topologies, (0.3,), (0,), num_nodes=n)
    for data, masked_grid in ((fed, grid3), (ohio, grid48)):
        runs = {}
        for impl in ("allgather", "masked"):
            reset_peak()
            reset_launches()
            _, h, st = trainer(data.num_nodes, impl=impl).train_sweep(
                data.x, data.y, data.counts, grid=masked_grid, batch_size=64,
                rounds=SWEEP_MASKED_ROUNDS)
            sync()
            require(others(launches()) == 0,
                    f"masked sweep {data.name}: a gossip, attention or forward kernel ran")
            hand_steps(launches(), f"masked sweep {data.name}", SWEEP_MASKED_ROUNDS)
            runs[impl] = (h, st, peak_gb())
        (ha, a, peak_a), (hb, b, peak_b) = runs["allgather"], runs["masked"]
        require(ha == hb and torch.equal(a.params, b.params) and
                all(torch.equal(a.opt_state[k], b.opt_state[k]) for k in a.opt_state),
                f"masked sweep {data.name}: not bitwise the unmasked sweep")
        emit("sweep_masked", dataset=data.name, nodes=data.num_nodes, scenarios=masked_grid.size,
             rounds=SWEEP_MASKED_ROUNDS, bitwise_params_opt_state_history=True,
             memory_gb_unmasked=peak_a, memory_gb_masked=peak_b)

    # (e) the swept chunk in turns with one scenario's serial chunk ----------
    gens = [torch.Generator(device=DEV).manual_seed(100 + s) for s in range(grid.size)]
    serial_runs = {}
    for mixer in ("tree", "kernel"):
        tr = trainer(n, topology="random", ratio=0.3, mixer=mixer)
        gen = torch.Generator(device=DEV).manual_seed(7)
        serial_runs[mixer] = (tr, gen, tr.train(gen, fed.x, fed.y, fed.counts, batch_size=64,
                                                rounds=2)[2])

    def sweep_chunk(rounds=SWEEP_SHORT):
        nonlocal states
        _, _, states = swept.train_sweep(fed.x, fed.y, fed.counts, grid=grid, generators=gens,
                                         batch_size=64, rounds=rounds, chunk=rounds,
                                         states=states)

    def serial_chunk(mixer):
        tr, gen, state = serial_runs[mixer]
        state = tr.train(gen, fed.x, fed.y, fed.counts, batch_size=64, rounds=SWEEP_SHORT,
                         chunk=SWEEP_SHORT, state=state)[2]
        serial_runs[mixer] = (tr, gen, state)

    walls = {"sweep": [], "tree": [], "kernel": []}
    reset_peak()
    for key in ("sweep", "tree", "kernel", "kernel", "tree", "sweep"):
        sync()
        t0 = time.perf_counter()
        sweep_chunk() if key == "sweep" else serial_chunk(key)
        sync()
        walls[key].append(time.perf_counter() - t0)
    timed_peak = peak_gb()
    profile = {}
    if DEV == "cuda":
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            sweep_chunk(SWEEP_PROFILED_ROUNDS)
            sync()
        by_span, gemm_by_span, busy_ms, items = span_breakdown(prof)
        require(by_span["round.local_step"] > 0, f"the profile saw no local-step work: {by_span}")
        per_round = {k: v / SWEEP_PROFILED_ROUNDS for k, v in by_span.items()}
        round_wall_ms = statistics.median(walls["sweep"]) * 1e3 / SWEEP_SHORT
        profile = dict(device_ms_per_round=busy_ms / SWEEP_PROFILED_ROUNDS,
                       wall_ms_per_round=round_wall_ms,
                       device_busy_share=busy_ms / SWEEP_PROFILED_ROUNDS / round_wall_ms,
                       device_ms_by_span_per_round=per_round,
                       gemm_device_ms_by_span_per_round={
                           k: v / SWEEP_PROFILED_ROUNDS for k, v in gemm_by_span.items()},
                       device_items_per_round=items / SWEEP_PROFILED_ROUNDS)
    emit("sweep_timing", scenarios=grid.size, rounds=SWEEP_SHORT,
         order="sweep, tree, kernel, kernel, tree, sweep",
         scenario_rounds_per_s=[grid.size * SWEEP_SHORT / w for w in walls["sweep"]],
         serial_rounds_per_s_tree=[SWEEP_SHORT / w for w in walls["tree"]],
         serial_rounds_per_s_kernel=[SWEEP_SHORT / w for w in walls["kernel"]],
         memory_gb=timed_peak, **profile, nvidia_smi=card)

    # the sweep's eval launch at its shape, timed as phase 6 times the others
    args = random_inputs(torch.Generator().manual_seed(19), *SWEEP_EVAL)
    library = cudnn_lstm(*(t[0] for t in args[1:]))
    windows = args[0].reshape(-1, *args[0].shape[2:])  # the 15 x 2034 windows, one weight set
    nbytes, ops = lstm_forward_cost(*args)
    bound_ms, bound_by = bound(nbytes, ops)
    ms = time_ms(lambda: lstm_cell.lstm_forward(*args), 200)
    timing = dict(ms=ms, ms_l2_flushed=time_ms(lambda: lstm_cell.lstm_forward(*args), 200, flush),
                  bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms,
                  plain_ms=time_ms(lambda: lstm_forward_plain(*args), 10),
                  library_ms=time_ms(lambda: library(windows), 100),
                  library="torch.nn.LSTM (cuDNN) + nn.Linear over the 15 x 2034 windows",
                  bytes=nbytes, ops=ops, plan=lstm_cell._plan(*SWEEP_EVAL)._asdict())
    emit("timing", shape=dict(zip("GRLIH", SWEEP_EVAL)), **timing)
    return dict(launches_sweep=counts["lstm_forward"],
                gate_launches_sweep={k: counts[k] for k in GATE_KERNELS}, sweep_eval_ms=ms,
                sweep_eval_bound_ms=bound_ms, sweep_eval_bound_share=timing["bound_share"],
                sweep_eval_plain_ms=timing["plain_ms"],
                sweep_eval_library_ms=timing["library_ms"])


def baselines_phase(feds, card: str, flush: torch.Tensor, errs: list) -> dict:
    """Phase 20, the paper's baselines; returns the ``lstm_forward``
    row's fields for them (the grid's evaluation launches, the pooled
    val set's shape timed)."""
    import repro_torch.core.chunked as chunked
    from repro_torch.config import FLConfig
    from repro_torch.core import MAML, FedAvg, MetaSGD, train_supervised
    from repro_torch.kernels import lstm_cell
    from repro_torch.kernels.ref import lstm_forward_plain
    from repro_torch.metrics import all_metrics
    from repro_torch.models import LSTMModel
    from repro_torch.core.chunked import initial_row
    from repro_torch.core.gluadfl import FedTensors
    from repro_torch.optim import adam, get_optimizer
    from repro_torch.paper import common, fig3_personalization, table4_baselines
    from repro_torch.utils.pytree import tree_to_vector
    from repro_torch.utils.rng import draw_meta, draw_round

    fed = feds["replace-bg"]
    n = fed.num_nodes
    for data in feds.values():  # the experiments read the phases' datasets
        common.preload(data)
    model = LSTMModel(hidden=128).as_model()
    counts = torch.as_tensor(fed.counts)

    def trainer(method, dev, opt=None):
        if method == "fedavg":
            return FedAvg(model, opt or adam(2e-3), FLConfig(num_nodes=n, inactive_ratio=0.3,
                                                             local_steps=2), device=dev)
        return {"maml": MAML, "metasgd": MetaSGD}[method](model, opt or adam(1e-3), inner_lr=1e-2,
                                                          inner_steps=3, device=dev)

    # (1) card against CPU from one set of draws ------------------------------
    init = LSTMModel(hidden=128).init(torch.Generator().manual_seed(20))
    start = tree_to_vector(init)

    def first_order_change(meta, draws, lr):
        """MAML's steps under SGD ``lr`` with the inner gradients taken
        without a graph, so the meta-gradient drops the second-order
        term: the params' change, on the card."""
        data = FedTensors.of(fed.x, fed.y, fed.counts, DEV)
        row = theta = initial_row(model, meta.layout, None, init, DEV)
        for d in draws:
            th = theta.detach().requires_grad_(True)
            with torch.enable_grad():
                rows = th.expand(n, -1)
                for s in range(meta.inner_steps):
                    losses = meta._task_losses(rows, data, d.support[:, s].to(DEV))
                    (g,) = torch.autograd.grad(losses.sum(), rows)
                    rows = rows - meta.inner_lr * g
                (meta_g,) = torch.autograd.grad(
                    meta._task_losses(rows, data, d.query.to(DEV)).mean(), th)
            theta = th.detach() - lr * meta_g
        return tree_to_vector(meta.layout.row(theta - row)).cpu()

    vs_cpu = {}
    for method, (opt, lr, rounds) in BASELINE_VS_CPU.items():
        if method == "fedavg":
            draws = [draw_round(torch.Generator().manual_seed(200 + r), counts, local_steps=2,
                                batch_size=64, random_topology=False) for r in range(rounds)]
        else:
            draws = [draw_meta(torch.Generator().manual_seed(210 + r), counts, inner_steps=3,
                               batch_size=64) for r in range(rounds)]
        runs = {}
        for dev in (DEV, "cpu"):
            tr = trainer(method, dev, get_optimizer(opt, lr))
            t0 = time.perf_counter()
            if method == "fedavg":
                params, hist = tr.train(None, fed.x, fed.y, fed.counts, batch_size=64,
                                        rounds=rounds, params=init, draws=draws)
                lrs = None
            else:
                params, lrs, hist = tr.train(None, fed.x, fed.y, fed.counts, batch_size=64,
                                             steps=rounds, params=init, draws=draws)
            learn_lr = getattr(tr, "learn_inner_lr", False)
            runs[dev] = (tree_to_vector(params).cpu() - start, tree_to_vector(lrs).cpu()
                         - tr.inner_lr if learn_lr else None, [h["loss"] for h in hist],
                         time.perf_counter() - t0)
        (ca, la, ha, sa), (cb, lb, hb, sb) = runs[DEV], runs["cpu"]
        loss_diff = max(abs(a - b) for a, b in zip(ha, hb))
        rel = float((ca - cb).norm() / cb.norm())
        lrs_rel = None if la is None else float((la - lb).norm() / lb.norm())
        vs_cpu[method] = dict(optimizer=opt, lr=lr, rounds=rounds, loss_max_abs_diff=loss_diff,
                              change_rel_norm=rel, lrs_change_rel_norm=lrs_rel,
                              change_over_params_norm=float(cb.norm() / (start + cb).norm()),
                              seconds_card=sa, seconds_cpu=sb)
        if method == "maml":
            fo = first_order_change(trainer(method, DEV), draws, lr)
            vs_cpu[method]["first_order_change_rel_norm"] = float((fo - cb).norm() / cb.norm())
        require(all(math.isfinite(v) for v in ha) and loss_diff <= VS_CPU_LOSS_TOL[opt]
                and rel <= VS_CPU_CHANGE_REL
                and (lrs_rel is None or lrs_rel <= VS_CPU_CHANGE_REL),
                f"{method} on the card vs the CPU: {vs_cpu[method]}")
    require(vs_cpu["maml"]["first_order_change_rel_norm"] > VS_CPU_CHANGE_REL,
            f"a first-order MAML run passes the card-vs-CPU limit: {vs_cpu['maml']}")
    emit("baselines_vs_cpu", dataset=fed.name, nodes=n, hidden=128, batch=64, inner_lr=1e-2,
         inner_steps=3, loss_tol=VS_CPU_LOSS_TOL, change_rel_tol=VS_CPU_CHANGE_REL, **vs_cpu)

    # (2) the Table-4 grid, then every population's evaluation (the main path)
    scale = common.Scale(rounds=BASELINE_ROUNDS, sup_steps=BASELINE_ROUNDS, max_patients=None,
                         hidden=128, device=DEV)
    dispatched = []
    dispatch = chunked.dispatch_chunk

    def counting(fn, *args, **kwargs):
        dispatched.append(fn)
        return dispatch(fn, *args, **kwargs)

    chunked.dispatch_chunk = counting
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        grid = table4_baselines.run_baseline_grid("replace-bg", scale)
        metrics = {m: common.eval_population(d["model"], d["params"], fed)
                   for m, d in grid.items()}
        torch.cuda.synchronize()
        grid_s = time.perf_counter() - t0
        grid_counts = launches()
    finally:
        chunked.dispatch_chunk = dispatch
    tested = sum(len(p.test_x) > 0 for p in fed.patients)
    require(len(dispatched) <= 4, f"the Table-4 grid took {len(dispatched)} chunks")
    require(grid_counts["lstm_forward"] == tested * len(grid)
            and others(grid_counts) == grid_counts["lstm_forward"],
            f"Table-4 grid: launches {grid_counts}, want {tested} lstm_forward per population")
    hand_steps(grid_counts, "Table-4 grid")
    grid_rows = {}
    for method, d in grid.items():
        losses = [h["loss"] for h in d["history"]]
        require(len(losses) == BASELINE_ROUNDS and all(math.isfinite(v) for v in losses),
                f"Table-4 grid: {method}'s history")
        params = d["params"]
        preds, plain_preds, ys = [], [], []
        err = 0.0
        for p in fed.patients:
            x = torch.as_tensor(p.test_x, device=DEV)
            got = model.apply(params, x)
            want = lstm_forward_plain(x[None, :, :, None], *(params[k][None] for k in
                                                             ("wx", "wh", "b", "w_out", "b_out")))[0]
            err = max(err, float((got - want).abs().max()))
            preds.append(got.cpu().numpy() * fed.sd + fed.mean)
            plain_preds.append(want.cpu().numpy() * fed.sd + fed.mean)
            ys.append(p.test_y_raw)
        require(err <= TOL, f"Table-4 grid: {method}'s test forecasts vs the plain twin: {err}")
        errs.append(err)
        plain = all_metrics(np.concatenate(ys), np.concatenate(plain_preds))
        again = all_metrics(np.concatenate(ys), np.concatenate(preds))
        require(again == metrics[method] and all(math.isfinite(v) for v in plain.values()),
                f"Table-4 grid: {method}'s metrics")
        grid_rows[method] = dict(loss_first=losses[0], loss_last=losses[-1],
                                 metrics=metrics[method],
                                 rmse_plain_minus_kernel=plain["rmse"] - metrics[method]["rmse"],
                                 max_abs_err_vs_plain=err)
    emit("baselines_grid", dataset=fed.name, nodes=n, hidden=128, rounds=BASELINE_ROUNDS,
         dispatches=len(dispatched), launches=grid_counts, patients_evaluated=tested,
         seconds=grid_s, methods=grid_rows, tol=TOL, nvidia_smi=card)

    # (3) each method's chunk in turns, its profile and its peak memory -------
    pooled_x, pooled_y = common.pooled(fed, "train")
    state = {m: d["params"] for m, d in grid.items()}
    trainers = {m: trainer(m, DEV) for m in ("fedavg", "maml", "metasgd")}

    def chunk(method, rounds):
        """``rounds`` of ``method`` from its last params, ending in the
        chunk's one host sync (the data's upload included)."""
        gen = torch.Generator(device=DEV).manual_seed(300)
        if method == "lstm":
            state[method] = train_supervised(model, adam(2e-3), gen, pooled_x, pooled_y,
                                             steps=rounds, batch_size=64, chunk=rounds,
                                             params=state[method], device=DEV)[0]
        elif method == "fedavg":
            state[method] = trainers[method].train(gen, fed.x, fed.y, fed.counts, batch_size=64,
                                                   rounds=rounds, chunk=rounds,
                                                   params=state[method])[0]
        else:
            state[method] = trainers[method].train(gen, fed.x, fed.y, fed.counts, batch_size=64,
                                                   steps=rounds, chunk=rounds,
                                                   params=state[method])[0]

    for method in grid:  # warm: the first call of each path builds cuBLAS handles
        chunk(method, 1)
    walls = {m: [] for m in grid}
    order = list(grid) + list(reversed(grid))
    for method in order:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        chunk(method, BASELINE_TIMED[method])
        torch.cuda.synchronize()
        walls[method].append((time.perf_counter() - t0,
                              (torch.cuda.max_memory_allocated() - held) / 1e9))
    timing = {}
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for method in grid:
        rounds = BASELINE_PROFILED[method]
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            chunk(method, rounds)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        by_span, gemm_by_span, busy_ms, items = span_breakdown(prof, BASELINE_SPANS[method])
        require(busy_ms > 0, f"the profile saw no device work for {method}")
        per_round_ms = statistics.median(w for w, _ in walls[method]) * 1e3 / BASELINE_TIMED[method]
        timing[method] = dict(
            rounds=BASELINE_TIMED[method],
            per_s=[BASELINE_TIMED[method] / w for w, _ in walls[method]],
            wall_ms_per_round=per_round_ms,
            peak_gb_added=[g for _, g in walls[method]],
            device_ms_per_round=busy_ms / rounds,
            device_busy_share=busy_ms / rounds / per_round_ms,
            profiled_wall_ms_per_round=prof_wall * 1e3 / rounds,
            device_ms_by_span_per_round={k: v / rounds for k, v in by_span.items()},
            gemm_device_ms_per_round=sum(gemm_by_span.values()) / rounds,
            device_items_per_round=items / rounds)
    emit("baselines_timing", order=", ".join(order),
         unit={"fedavg": "rounds", "maml": "meta-steps", "metasgd": "meta-steps",
               "lstm": "steps"}, **timing, nvidia_smi=card)

    # (4) all eleven methods, then Fig 3 ---------------------------------------
    small = common.Scale(**TABLE4_SCALE, device=DEV)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        table4 = table4_baselines.run(small, datasets=TABLE4_DATASETS)
    table4_s = time.perf_counter() - t0
    for ds, rows in table4.items():
        require(sorted(rows) == sorted(table4_baselines.METHODS), f"Table 4 {ds}: methods")
        for method, row in rows.items():
            require(all(math.isfinite(v) for part in ("seen", "unseen") for v in row[part].values()),
                    f"Table 4 {ds}/{method}: a non-finite metric")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        fig3 = fig3_personalization.run(small, datasets=["ohiot1dm"])
    fig3_s = time.perf_counter() - t0
    require(all(math.isfinite(v["rmse"]) for v in fig3["ohiot1dm"].values()), "Fig 3: rmse")
    emit("table4", datasets=TABLE4_DATASETS, scale=TABLE4_SCALE,
         seen_rmse={ds: {m: r["seen"]["rmse"] for m, r in rows.items()} for ds, rows in table4.items()},
         unseen_rmse={ds: {m: r["unseen"]["rmse"] for m, r in rows.items()}
                      for ds, rows in table4.items()},
         seconds=table4_s, fig3_rmse={k: v["rmse"] for k, v in fig3["ohiot1dm"].items()},
         fig3_seconds=fig3_s)

    # (5) lstm_forward at the pooled val set's shape, timed as phase 6 times the others
    args = random_inputs(torch.Generator().manual_seed(20), *POOLED_EVAL)
    library = cudnn_lstm(*(t[0] for t in args[1:]))
    library_err = float((library(args[0][0]) - lstm_cell.lstm_forward(*args)[0]).abs().max())
    nbytes, ops = lstm_forward_cost(*args)
    bound_ms, bound_by = bound(nbytes, ops)
    ms = time_ms(lambda: lstm_cell.lstm_forward(*args), 100)
    pooled_err = float((lstm_cell.lstm_forward(*args) - lstm_forward_plain(*args)).abs().max())
    require(pooled_err <= TOL, f"lstm_forward at {POOLED_EVAL} vs the plain twin: {pooled_err}")
    errs.append(pooled_err)
    row = dict(ms=ms, ms_l2_flushed=time_ms(lambda: lstm_cell.lstm_forward(*args), 100, flush),
               bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms,
               plain_ms=time_ms(lambda: lstm_forward_plain(*args), 20),
               library_ms=time_ms(lambda: library(args[0][0]), 50),
               library="torch.nn.LSTM (cuDNN) + nn.Linear", library_max_abs_err=library_err,
               max_abs_err=pooled_err, bytes=nbytes, ops=ops,
               plan=lstm_cell._plan(*POOLED_EVAL)._asdict())
    emit("timing", shape=dict(zip("GRLIH", POOLED_EVAL)), **row)
    return dict(launches_baselines=grid_counts["lstm_forward"], pooled_eval_ms=ms,
                pooled_eval_bound_ms=bound_ms, pooled_eval_bound_share=row["bound_share"],
                pooled_eval_plain_ms=row["plain_ms"], pooled_eval_library_ms=row["library_ms"])


def finite_leaves(tree) -> bool:
    """Every number in a nested result (dicts, lists, tuples) is finite,
    and there is at least one."""
    seen = []

    def walk(v):
        if isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            seen.append(math.isfinite(v))
    walk(tree)
    return bool(seen) and all(seen)


def figures_phase(feds, card: str, errs: list) -> dict:
    """Phase 21, Figs 4 and 5, the paper driver and the examples; returns
    the ``lstm_forward`` row's launches on the two figures' paths."""
    from repro_torch.config import FLConfig
    from repro_torch.core import GluADFL, SweepGrid
    from repro_torch.examples import cross_patient, quickstart, serve_arch
    from repro_torch.examples import topology_async_ablation
    from repro_torch.kernels.ref import lstm_forward_plain
    from repro_torch.metrics import all_metrics
    from repro_torch.models import LSTMModel
    from repro_torch.optim import adam
    from repro_torch.paper import common, fig4_topology, fig5_async
    from repro_torch.paper import run as driver

    fed = feds["replace-bg"]
    common.preload(fed)
    weights = ("wx", "wh", "b", "w_out", "b_out")

    def sync():
        if DEV == "cuda":
            torch.cuda.synchronize()

    # (a) Fig 4: the sweep (the main path), each eval's population kept -----
    scale4 = common.Scale(rounds=FIG4_ROUNDS, device=DEV, **FIG_SCALE)
    make_eval = fig4_topology._val_rmse_fn
    evaluated = []

    def keeping(model, data):
        fn = make_eval(model, data)

        def val_rmse(params, vx, vy):
            evaluated.append({k: v.clone() for k, v in params.items()})
            return fn(params, vx, vy)
        return val_rmse

    fig4_topology._val_rmse_fn = keeping
    try:
        curves = {}
        for serial in (False, True):
            evaluated.clear()
            sync()
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                curves[serial] = fig4_topology.run(scale4, datasets=[fed.name],
                                                   eval_every=FIG4_EVAL_EVERY,
                                                   serial=serial)[fed.name]
            sync()
            seconds = time.perf_counter() - t0
            counts = launches()
            if not serial:
                fig4_counts, fig4_s, fig4_pops = counts, seconds, list(evaluated)
            else:
                serial_counts, serial_s = counts, seconds
    finally:
        fig4_topology._val_rmse_fn = make_eval
    evals = FIG4_ROUNDS // FIG4_EVAL_EVERY
    topos = fig4_topology.TOPOLOGIES
    for name, counts in (("sweep", fig4_counts), ("serial", serial_counts)):
        require(counts["lstm_forward"] == len(topos) * evals
                and others(counts) == counts["lstm_forward"],
                f"Fig 4 {name}: launches {counts}, want {len(topos)} lstm_forward an eval round")
        hand_steps(counts, f"Fig 4 {name}")
    vx = torch.as_tensor(np.concatenate([p.val_x for p in fed.patients]), device=DEV)
    vy = torch.as_tensor(np.concatenate([p.val_y * fed.sd + fed.mean for p in fed.patients]),
                         dtype=torch.float32, device=DEV)
    plain_rel, serial_rel = 0.0, 0.0
    for j in range(evals):
        for g, topo in enumerate(topos):
            params = fig4_pops[j * len(topos) + g]
            pred = lstm_forward_plain(vx[None, :, :, None], *(params[k][None] for k in weights))[0]
            plain = float(torch.sqrt(torch.mean(torch.square(pred * fed.sd + fed.mean - vy))))
            got = curves[False][topo][j][1]
            require(curves[False][topo][j][0] == (j + 1) * FIG4_EVAL_EVERY - 1 and
                    math.isfinite(got), f"Fig 4 {topo}: record {j}")
            plain_rel = max(plain_rel, abs(got - plain) / plain)
            other = curves[True][topo][j][1]
            serial_rel = max(serial_rel, abs(got - other) / abs(other))
    require(plain_rel <= FIG4_REL_TOL, f"Fig 4: val RMSE vs the plain twin: {plain_rel}")
    require(serial_rel <= FIG4_REL_TOL, f"Fig 4: the sweep vs the serial curves: {serial_rel}")

    # the swept chunk with and without the eval, in turns
    model = LSTMModel(hidden=FIG_SCALE["hidden"]).as_model()
    trainer = GluADFL(model, adam(2e-3), FLConfig(num_nodes=fed.num_nodes, comm_batch=7),
                      device=DEV)
    grid3 = SweepGrid.build(topos, [0.0], [0], num_nodes=fed.num_nodes)
    gens = [torch.Generator(device=DEV).manual_seed(400 + g) for g in range(grid3.size)]
    val = (vx.cpu().numpy(), vy.cpu().numpy())
    eval_fn = make_eval(model, fed)
    state = None

    def chunk(rounds, with_eval):
        nonlocal state
        kw = dict(eval_every=FIG4_EVAL_EVERY, eval_fn=eval_fn, val_data=val) if with_eval else {}
        _, _, state = trainer.train_sweep(fed.x, fed.y, fed.counts, grid=grid3, generators=gens,
                                          batch_size=FIG_SCALE["batch_size"], rounds=rounds,
                                          chunk=rounds, states=state, **kw)

    chunk(FIG4_EVAL_EVERY, True)  # warm: cuBLAS handles, the first eval
    walls = {True: [], False: []}
    for with_eval in (True, False, False, True):
        sync()
        t0 = time.perf_counter()
        chunk(FIG4_TIMED, with_eval)
        sync()
        walls[with_eval].append(time.perf_counter() - t0)
    per_eval_ms = ((statistics.mean(walls[True]) - statistics.mean(walls[False])) * 1e3
                   / (FIG4_TIMED // FIG4_EVAL_EVERY))
    emit("fig4", dataset=fed.name, nodes=fed.num_nodes, hidden=FIG_SCALE["hidden"],
         batch=FIG_SCALE["batch_size"], comm_batch=7,
         scenarios=len(topos), rounds=FIG4_ROUNDS, eval_every=FIG4_EVAL_EVERY,
         launches=fig4_counts, launches_serial=serial_counts,
         val_rows=int(vx.shape[0]), seconds=fig4_s, seconds_serial=serial_s,
         final_val_rmse={t: curves[False][t][-1][1] for t in topos},
         val_rmse_vs_plain_max_rel=plain_rel, sweep_vs_serial_max_rel=serial_rel,
         rel_tol=FIG4_REL_TOL, timed_rounds=FIG4_TIMED, order="eval, none, none, eval",
         scenario_rounds_per_s_with_eval=[grid3.size * FIG4_TIMED / w for w in walls[True]],
         scenario_rounds_per_s_without_eval=[grid3.size * FIG4_TIMED / w for w in walls[False]],
         eval_ms_per_eval_round=per_eval_ms, nvidia_smi=card)

    # (b) Fig 5: the G=15 grid, then every scenario's eval_population -------
    scale5 = common.Scale(rounds=FIG5_ROUNDS, device=DEV, **FIG_SCALE)
    eval_population = fig5_async.eval_population
    kept, eval_s = [], []

    def timed_eval(model, params, data):
        t0 = time.perf_counter()
        out = eval_population(model, params, data)
        eval_s.append(time.perf_counter() - t0)
        kept.append((model, params, out))
        return out

    fig5_async.eval_population = timed_eval
    try:
        sync()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            fig5 = fig5_async.run(scale5, datasets=[fed.name])[fed.name]
        sync()
        fig5_s = time.perf_counter() - t0
        fig5_counts = launches()
    finally:
        fig5_async.eval_population = eval_population
    tested = sum(len(p.test_x) > 0 for p in fed.patients)
    g5 = len(kept)
    require(g5 == len(topos) * len(fig5_async.RATIOS), f"Fig 5: {g5} scenarios evaluated")
    require(fig5_counts["lstm_forward"] == tested * g5
            and others(fig5_counts) == fig5_counts["lstm_forward"],
            f"Fig 5: launches {fig5_counts}, want {tested} lstm_forward a scenario")
    hand_steps(fig5_counts, "Fig 5")
    require(finite_leaves(fig5), f"Fig 5: a non-finite curve: {fig5}")
    fig5_err = 0.0
    for g in FIG5_SAMPLE:
        model5, params, metrics = kept[g]
        preds, ys = [], []
        for p in fed.patients:
            x = torch.as_tensor(p.test_x, device=DEV)
            with torch.no_grad():
                got = model5.apply(params, x)
            want = lstm_forward_plain(x[None, :, :, None], *(params[k][None] for k in weights))[0]
            fig5_err = max(fig5_err, float((got - want).abs().max()))
            preds.append(got.cpu().numpy() * fed.sd + fed.mean)
            ys.append(p.test_y_raw)
        require(all_metrics(np.concatenate(ys), np.concatenate(preds)) == metrics,
                f"Fig 5: scenario {g}'s metrics are not its forecasts'")
    require(fig5_err <= TOL, f"Fig 5: sampled forecasts vs the plain twin: {fig5_err}")
    errs.append(fig5_err)
    emit("fig5", dataset=fed.name, nodes=fed.num_nodes, hidden=FIG_SCALE["hidden"],
         batch=FIG_SCALE["batch_size"],
         scenarios=g5, rounds=FIG5_ROUNDS, launches=fig5_counts, patients_evaluated=tested,
         seconds=fig5_s, seconds_eval=sum(eval_s), seconds_train=fig5_s - sum(eval_s),
         eval_ms_per_launch=sum(eval_s) * 1e3 / fig5_counts["lstm_forward"],
         rmse=fig5, sampled=list(FIG5_SAMPLE), max_abs_err_vs_plain=fig5_err, tol=TOL,
         nvidia_smi=card)

    # (c) the paper driver at --quick -----------------------------------------
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        results = driver.drive(["--quick", "--device", DEV])
    driver_s = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    csv = [ln.split(",") for ln in lines[lines.index("name,us_per_call,derived") + 1:]
           if "," in ln and not ln.startswith(("[", " ", "-", "#"))]
    names = [c[0] for c in csv if c[0] in DRIVER_LINES]
    require(names == DRIVER_LINES, f"the driver's lines: {names}")
    require(finite_leaves(results), "the driver: a non-finite metric")
    emit("driver", argv=["--quick"], seconds=driver_s,
         lines={c[0]: c[1:] for c in csv if c[0] in DRIVER_LINES}, nvidia_smi=card)

    # (d) the four examples at their own sizes ----------------------------------
    examples = {}
    for name, mod in (("quickstart", quickstart), ("topology_async_ablation",
                                                    topology_async_ablation),
                      ("cross_patient", cross_patient)):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            got = mod.run([*EXAMPLES[name], "--device", DEV])
        examples[name] = dict(seconds=time.perf_counter() - t0, result=got)
        require(finite_leaves(got), f"example {name}: a non-finite metric: {got}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = serve_arch.main([*EXAMPLES["serve_arch"], "--device", DEV])
    require(rc == 0, f"example serve_arch exited {rc}")
    examples["serve_arch"] = dict(seconds=time.perf_counter() - t0, exit=rc)
    ablation = examples["topology_async_ablation"]["result"]
    ablation["val_rmse"] = {f"{t}@{r}": v for (t, r), v in ablation["val_rmse"].items()}
    emit("examples", argv=EXAMPLES, **examples, nvidia_smi=card)
    return dict(launches_fig4=fig4_counts["lstm_forward"],
                launches_fig5=fig5_counts["lstm_forward"])


def sharded_phase(feds, card: str) -> dict:
    """Phase 22, the sharded mixer over a one-rank NCCL group and the
    CLI's multi-process flags; returns the ``lstm_forward`` row's
    launches on the phase's paths."""
    import socket
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.config import FLConfig
    from repro_torch.core import GluADFL
    from repro_torch.launch.train import run as train_run
    from repro_torch.launch.train import val_windows
    from repro_torch.models import LSTMModel
    from repro_torch.optim import get_optimizer

    fed = feds["replace-bg"]
    n = fed.num_nodes
    val = val_windows(fed)

    def trainer(mixer, impl, repr_, sigma):
        return GluADFL(LSTMModel(hidden=128).as_model(), get_optimizer("adam", 1e-3),
                       FLConfig(num_nodes=n, topology="random", inactive_ratio=0.3),
                       mixer=mixer, gossip_impl=impl, gossip_repr=repr_, dp_noise_sigma=sigma)

    def train(t, state=None, rounds=SHARDED_ROUNDS, evals=True):
        out = t.train(torch.Generator(device="cuda").manual_seed(22), fed.x, fed.y, fed.counts,
                      batch_size=64, rounds=rounds, chunk=rounds,
                      eval_every=SHARDED_EVAL if evals else 0, val_data=val if evals else None,
                      state=state)
        torch.cuda.synchronize()
        return out

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
                            timeout=timedelta(seconds=300))
    try:
        require(dist.get_backend() == "nccl", f"the group's backend is {dist.get_backend()}")
        trees = {(r, s): train(trainer("tree", "allgather", r, s))
                 for r, s in {(r, s) for _, r, s in SHARDED_RUNS}}
        runs, peaks, lstm_launches, checks = {}, {}, 0, {}
        for impl, repr_, sigma in SHARDED_RUNS:
            key = f"{impl}-{repr_}" + (f"-dp{sigma}" if sigma else "")
            t = trainer("sharded", impl, repr_, sigma)
            require(t.mesh.group is not None and t.mesh.width == 1 and t.mesh.rows == slice(0, n),
                    f"{key}: the trainer's mesh {t.mesh}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            reset_launches()
            pop, hist, state = train(t)
            counts = launches()
            peaks[key] = dict(peak=torch.cuda.max_memory_allocated() / 1e9,
                              added=(torch.cuda.max_memory_allocated() - start) / 1e9)
            require(counts["lstm_forward"] == SHARDED_ROUNDS // SHARDED_EVAL and
                    others(counts) == counts["lstm_forward"],
                    f"{key}: launches {counts}, want the evals' lstm_forward alone")
            hand_steps(counts, key, SHARDED_ROUNDS)
            lstm_launches += counts["lstm_forward"]
            tpop, thist, tstate = trees[(repr_, sigma)]
            require(torch.equal(state.params, tstate.params) and
                    all(torch.equal(state.opt_state[k], tstate.opt_state[k])
                        for k in state.opt_state if state.opt_state[k] is not None),
                    f"{key}: the node params after {SHARDED_ROUNDS} rounds are not bitwise "
                    f"the tree mixer's")
            diffs = dict(population=rel_diff(torch.cat([pop[k].reshape(-1) for k in sorted(pop)]),
                                             torch.cat([tpop[k].reshape(-1) for k in sorted(tpop)])),
                         losses=rel_diff([h["loss"] for h in hist], [h["loss"] for h in thist]),
                         val_rmse=rel_diff([h["val_rmse"] for h in hist if "val_rmse" in h],
                                           [h["val_rmse"] for h in thist if "val_rmse" in h]))
            require(len(hist) == SHARDED_ROUNDS and np.isfinite([h["loss"] for h in hist]).all(),
                    f"{key}: losses")
            require(max(diffs.values()) <= SHARDED_TOL, f"{key} against the tree mixer: {diffs}")
            checks[key] = dict(backend=t.plan.backend, bitwise_params_opt_state=True,
                               rel_diff_vs_tree=diffs, launches=counts)
            runs[key] = (t, hist, state)
        _, ha, a = runs["allgather-sparse"]
        _, hm, m = runs["masked-sparse"]
        require(ha == hm and torch.equal(a.params, m.params), "masked is not bitwise allgather")

        # rounds/s in turns (forward, then back), each from its run's state, no eval
        timed = {"tree-sparse": (trainer("tree", "allgather", "sparse", 0.0),
                                 trees[("sparse", 0.0)][2]),
                 "kernel-sparse": (trainer("kernel", "allgather", "sparse", 0.0),
                                   trees[("sparse", 0.0)][2]),
                 **{k: (t, st) for k, (t, _, st) in runs.items()}}
        rates = {k: [] for k in timed}
        for k in list(timed) + list(reversed(timed)):
            t, st = timed[k]
            t0 = time.perf_counter()
            train(t, st, evals=False)
            rates[k].append(SHARDED_ROUNDS / (time.perf_counter() - t0))

        # a profiled chunk: the gossip span's device time and the kernels in it
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        profiles = {}
        for impl, repr_, sigma in SHARDED_PROFILED:
            t, _, st = runs[f"{impl}-{repr_}"]
            t0 = time.perf_counter()
            with torch.profiler.profile(activities=activities) as prof:
                train(t, st, rounds=SHARDED_PROFILED_ROUNDS, evals=False)
            wall_ms = (time.perf_counter() - t0) * 1e3
            by_span, _, busy_ms, _ = span_breakdown(prof)
            items = span_items(prof, "round.gossip")
            require(by_span["round.gossip"] > 0, f"{impl}-{repr_}: no device work in round.gossip")
            anywhere = {e.name for e in prof.events() if "nccl" in e.name.lower()}
            profiles[f"{impl}-{repr_}"] = dict(
                gossip_device_ms_per_round=by_span["round.gossip"] / SHARDED_PROFILED_ROUNDS,
                gossip_items_ms=items,
                nccl_kernels=sorted(k for k in items if "nccl" in k.lower()),
                nccl_events_anywhere=sorted(anywhere),
                device_ms_by_span=by_span, device_busy_ms=busy_ms, wall_ms=wall_ms,
                device_busy_share=busy_ms / wall_ms)
    finally:
        dist.destroy_process_group()

    # the CLI, one process: the sharded mixer on the one-process mesh
    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        run = train_run(["--dataset", "replace-bg", "--fast-data", "--topology", "random",
                         "--rounds", str(SHARDED_CLI_ROUNDS), "--hidden", "128",
                         "--inactive-ratio", "0.3", "--mixer", "sharded", "--gossip-impl", "gather",
                         "--num-processes", "1", "--out", str(ROOT / "build" / "chip_smoke")])
    torch.cuda.synchronize()
    cli_counts = launches()
    require(run.trainer.plan.backend == "sharded_gather_tables" and run.trainer.mesh.width == 1
            and run.trainer.mesh.group is None, f"the CLI's plan {run.trainer.plan.backend}")
    require(cli_counts["lstm_forward"] == n and others(cli_counts) == n,
            f"the CLI's launches {cli_counts}, want {n} lstm_forward (the test forecasts)")
    hand_steps(cli_counts, "the sharded CLI", SHARDED_CLI_ROUNDS)
    require(len(run.history) == SHARDED_CLI_ROUNDS and
            np.isfinite([h["loss"] for h in run.history]).all() and run.checkpoint.exists(),
            "the CLI's history or checkpoint")
    emit("sharded", dataset="replace-bg", nodes=n, hidden=128, dim=runs["allgather-sparse"][0]
         .layout.dim, rounds=SHARDED_ROUNDS, eval_every=SHARDED_EVAL, world_size=1,
         backend="nccl", runs=checks, masked_bitwise_allgather=True,
         rounds_per_s=rates, peak_memory_gb=peaks, profiles=profiles,
         cli=dict(rounds=SHARDED_CLI_ROUNDS, seconds=run.seconds, launches=cli_counts,
                  gossip_repr=run.trainer.plan.gossip_repr, final_loss=run.history[-1]["loss"],
                  printed_lines=len(printed.getvalue().splitlines())),
         nvidia_smi=card)
    return dict(launches_sharded=lstm_launches, launches_sharded_cli=cli_counts["lstm_forward"])


def swept_phase(feds, card: str) -> dict:
    """Phase 24, the swept-sharded engine (``train_sweep`` with
    ``mixer="sharded"``) on the (1, 1) sweep mesh of a one-rank NCCL
    group, and the sweep CLI with ``--mixer sharded``; returns the
    ``lstm_forward`` row's launches on the phase's paths."""
    import socket
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.config import FLConfig, SweepConfig
    from repro_torch.core import GluADFL, SweepGrid
    from repro_torch.launch.mesh import make_sweep_mesh
    from repro_torch.launch.train import run as train_run
    from repro_torch.launch.train import val_windows
    from repro_torch.models import LSTMModel
    from repro_torch.models import lstm as lstm_model
    from repro_torch.optim import get_optimizer

    fed = feds[SWEPT_DATASET]
    n = fed.num_nodes
    val = val_windows(fed)
    fig5 = SweepConfig()
    grids = {sigma: SweepGrid.build(fig5.topologies, fig5.inactive_ratios, fig5.seed_list(),
                                    num_nodes=n, dp_sigmas=(sigma,) if sigma else None)
             for sigma in {s for _, _, s in SWEPT_RUNS}}
    g = grids[0.0].size

    def sync():
        if DEV == "cuda":
            torch.cuda.synchronize()

    def trainer(mixer, impl, repr_, mesh=None):
        return GluADFL(LSTMModel(hidden=SWEPT_HIDDEN).as_model(), get_optimizer("adam", 1e-3),
                       FLConfig(num_nodes=n, topology="random"), mixer=mixer, gossip_impl=impl,
                       gossip_repr=repr_, mesh=mesh, device=DEV)

    def sweep(t, sigma, states=None, rounds=SWEPT_ROUNDS, evals=True):
        out = t.train_sweep(fed.x, fed.y, fed.counts, grid=grids[sigma], batch_size=64,
                            rounds=rounds, chunk=rounds, eval_every=SWEPT_EVAL if evals else 0,
                            val_data=val if evals else None, states=states)
        sync()
        return out

    # the groups of each lstm_forward launch on the counted runs
    groups: list[int] = []
    plain_forward = lstm_model.lstm_forward

    def recording(x, wx, *rest):
        groups.append(int(wx.shape[0]))
        return plain_forward(x, wx, *rest)

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    backend = "nccl" if DEV == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
                            timeout=timedelta(seconds=300))
    try:
        require(dist.get_backend() == backend, f"the group's backend is {dist.get_backend()}")
        mesh = make_sweep_mesh(g, n, device=DEV)
        require(mesh.shape == {"grid": 1, "node": 1} and mesh.node.group is not None and
                mesh.grid_group is not None, f"the sweep mesh {mesh}")
        trees = {(r, s): sweep(trainer("tree", "allgather", r), s)
                 for r, s in {(r, s) for _, r, s in SWEPT_RUNS}}
        runs, peaks, checks, lstm_launches = {}, {}, {}, 0
        for impl, repr_, sigma in SWEPT_RUNS:
            key = f"{impl}-{repr_}" + (f"-dp{sigma}" if sigma else "")
            t = trainer("sharded", impl, repr_, mesh)
            if DEV == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                start = torch.cuda.memory_allocated()
            groups.clear()
            lstm_model.lstm_forward = recording
            reset_launches()
            try:
                pops, hists, states = sweep(t, sigma)
            finally:
                lstm_model.lstm_forward = plain_forward
            counts = launches()
            if DEV == "cuda":
                peak = torch.cuda.max_memory_allocated()
                peaks[key] = dict(peak=peak / 1e9, added=(peak - start) / 1e9)
            evals = SWEPT_ROUNDS // SWEPT_EVAL
            hand_steps(counts, key, SWEPT_ROUNDS)
            require(counts["lstm_forward"] == evals and others(counts) == evals
                    and groups == [g] * evals,
                    f"{key}: launches {counts}, groups {groups}: want {evals} lstm_forward "
                    f"launches of {g} groups and no gossip kernel")
            lstm_launches += counts["lstm_forward"]
            tpops, thists, tstates = trees[(repr_, sigma)]
            require(torch.equal(states.params, tstates.params) and
                    all(torch.equal(states.opt_state[k], tstates.opt_state[k])
                        for k in states.opt_state if states.opt_state[k] is not None),
                    f"{key}: the node params after {SWEPT_ROUNDS} rounds are not bitwise the "
                    f"tree sweep's")
            losses = np.array([[h["loss"] for h in hist] for hist in hists])
            require(losses.shape == (g, SWEPT_ROUNDS) and np.isfinite(losses).all(),
                    f"{key}: losses")
            diffs = dict(
                populations=rel_diff(torch.cat([pops[k].reshape(g, -1) for k in sorted(pops)], 1),
                                     torch.cat([tpops[k].reshape(g, -1) for k in sorted(tpops)],
                                               1)),
                losses=rel_diff(losses, [[h["loss"] for h in hist] for hist in thists]),
                val_rmse=rel_diff([h["val_rmse"] for hist in hists for h in hist
                                   if "val_rmse" in h],
                                  [h["val_rmse"] for hist in thists for h in hist
                                   if "val_rmse" in h]))
            require(max(diffs.values()) <= SHARDED_TOL, f"{key} against the tree sweep: {diffs}")
            checks[key] = dict(backend=t.plan.backend, bitwise_params_opt_state=True,
                               rel_diff_vs_tree=diffs, launches=counts, groups=groups[:])
            runs[key] = (t, hists, states, sigma)
        _, ha, a, _ = runs["allgather-sparse"]
        _, hm, m, _ = runs["masked-sparse"]
        require(ha == hm and torch.equal(a.params, m.params), "masked is not bitwise allgather")

        # scenario-rounds/s in turns (forward, then back), each from its
        # run's states, no eval
        timed = {"tree-sparse": (trainer("tree", "allgather", "sparse"), 0.0,
                                 trees[("sparse", 0.0)][2]),
                 "tree-dense": (trainer("tree", "allgather", "dense"), 0.0,
                                trees[("dense", 0.0)][2]),
                 **{k: (t, sigma, st) for k, (t, _, st, sigma) in runs.items()}}
        rates = {k: [] for k in timed}
        for k in list(timed) + list(reversed(timed)):
            t, sigma, st = timed[k]
            t0 = time.perf_counter()
            sweep(t, sigma, st, evals=False)
            rates[k].append(g * SWEPT_ROUNDS / (time.perf_counter() - t0))

        # a profiled chunk: the gossip span's device time and the kernels in it
        activities = [torch.profiler.ProfilerActivity.CPU]
        if DEV == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiles = {}
        for impl, repr_, sigma in SWEPT_PROFILED:
            t, _, st, _ = runs[f"{impl}-{repr_}"]
            t0 = time.perf_counter()
            with torch.profiler.profile(activities=activities) as prof:
                sweep(t, sigma, st, rounds=SWEPT_PROFILED_ROUNDS, evals=False)
            wall_ms = (time.perf_counter() - t0) * 1e3
            by_span, _, busy_ms, _ = span_breakdown(prof)
            items = span_items(prof, "round.gossip")
            require(by_span["round.gossip"] > 0, f"{impl}-{repr_}: no device work in round.gossip")
            profiles[f"{impl}-{repr_}"] = dict(
                gossip_device_ms_per_round=by_span["round.gossip"] / SWEPT_PROFILED_ROUNDS,
                gossip_items_ms=items,
                nccl_kernels=sorted(k for k in items if "nccl" in k.lower()),
                device_ms_by_span=by_span, device_busy_ms=busy_ms, wall_ms=wall_ms,
                device_busy_share=busy_ms / wall_ms)
    finally:
        dist.destroy_process_group()

    # the CLI, one process: the (1, 1) sweep mesh without a group, against
    # the tree sweep's CLI run
    out = ROOT / "build" / "chip_smoke"
    cli = {}
    for mixer in ("tree", "sharded"):
        extra = ["--mixer", mixer] + (["--num-processes", "1"] if mixer == "sharded" else [])
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            cli[mixer] = train_run(["--dataset", SWEPT_DATASET, *SWEPT_CLI, "--hidden",
                                    str(SWEPT_HIDDEN), "--device", DEV, "--out", str(out / mixer),
                                    *extra])
        sync()
        cli[mixer + "_launches"] = launches()
        cli[mixer + "_printed"] = printed.getvalue()
    run, cli_counts = cli["sharded"], cli["sharded_launches"]
    require(run.trainer.plan.backend == "sharded" and run.trainer.mesh.shape ==
            {"grid": 1, "node": 1} and run.trainer.mesh.node.group is None,
            f"the CLI's plan {run.trainer.plan.backend} on {run.trainer.mesh}")
    require(cli_counts["lstm_forward"] == n and others(cli_counts) == n,
            f"the CLI's launches {cli_counts}, want {n} lstm_forward (the test forecasts)")
    for mixer in ("tree", "sharded"):
        hand_steps(cli[mixer + "_launches"], f"the swept {mixer} CLI",
                   int(SWEPT_CLI[SWEPT_CLI.index("--rounds") + 1]))
    require(len(run.summary) == 6 and all(np.isfinite(r["final_loss"]) and np.isfinite(r["rmse"])
                                          for r in run.summary), "the CLI's summary")
    require(run.history == cli["tree"].history and run.summary == cli["tree"].summary,
            "the CLI's sharded sweep is not the tree sweep's")
    emit("swept", dataset=SWEPT_DATASET, nodes=n, hidden=SWEPT_HIDDEN, scenarios=g,
         dim=runs["allgather-sparse"][0].layout.dim, rounds=SWEPT_ROUNDS, eval_every=SWEPT_EVAL,
         world_size=1, backend=backend, mesh=mesh.shape, runs=checks,
         masked_bitwise_allgather=True, scenario_rounds_per_s=rates, peak_memory_gb=peaks,
         profiles=profiles,
         cli=dict(rounds=len(run.history[0]), scenarios=len(run.summary), seconds=run.seconds,
                  tree_seconds=cli["tree"].seconds, launches=cli_counts,
                  gossip_repr=run.trainer.plan.gossip_repr, bitwise_tree_cli=True,
                  printed_lines=len(cli["sharded_printed"].splitlines())),
         nvidia_smi=card)
    return dict(launches_swept=lstm_launches, launches_swept_cli=cli_counts["lstm_forward"])


def hybrid_split(prof) -> tuple[dict[str, float], dict[str, float], int, int]:
    """Device time (ms) of a profiled prefill split into the GEMMs
    (``GEMM_NAMES``), ``swa_attention``, the RG-LRU scan (items whose start
    lies in an ``rglru.scan`` span on the device timeline, the rule of
    :func:`span_breakdown`) and the rest; the ten largest items by name;
    the number of items and of scan spans seen."""
    from torch.autograd import DeviceType

    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = [(e.time_range.start, e.time_range.end) for e in on_device
              if e.name == HYBRID_SCAN_SPAN]
    split = dict.fromkeys(("gemm", "swa_attention", "rglru_scan", "other"), 0.0)
    top: dict[str, float] = {}
    work = [e for e in on_device if e.name != HYBRID_SCAN_SPAN]
    for e in work:
        name, start = e.name.lower(), e.time_range.start
        kind = ("swa_attention" if "swa_attention_kernel" in name
                else "gemm" if any(g in name for g in GEMM_NAMES)
                else "rglru_scan" if any(lo <= start < hi for lo, hi in ranges) else "other")
        ms = (e.time_range.end - start) / 1e3
        split[kind] += ms
        top[e.name[:90]] = top.get(e.name[:90], 0.0) + ms
    return split, dict(sorted(top.items(), key=lambda kv: -kv[1])[:10]), len(work), len(ranges)


def cpu_tree(tree):
    """A copy on the CPU of nested dicts and lists of tensors."""
    if isinstance(tree, dict):
        return {k: cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cpu_tree(v) for v in tree]
    return tree.cpu()


def logits_run(arch, params, tokens, steps: int, vocab: int, *, state=None, feed=None,
               extra=None) -> dict:
    """A prefill of ``tokens`` (B, S) (with the batch's ``extra`` entries,
    such as enc-dec frames), then ``steps`` decode steps: from the
    prefill's state at positions S, S + 1, ..., or, given ``state``, from
    it at 0, 1, ... with tokens[:, :1] first.  Each step decodes the
    token of ``feed`` (on the CPU), or the greedy token of the step before.
    Returns the logits of the prefill and of each step on the CPU, the
    tokens decoded, and the prefill's and the last step's states."""
    dev = tokens.device
    logits, prefilled = arch.prefill_fn(params, {"tokens": tokens, **(extra or {})})
    out = {"logits": [logits.cpu()], "fed": [], "prefilled": prefilled}
    pos0, last = (tokens.shape[1], prefilled) if state is None else (0, state)
    for t in range(steps):
        if feed is not None:
            tok = feed[t]
        elif state is not None and t == 0:
            tok = tokens[:, :1].cpu()
        else:
            tok = torch.argmax(logits[:, -1, :vocab], dim=-1)[:, None].to(torch.int32).cpu()
        out["fed"].append(tok)
        logits, last = arch.decode_fn(params, last, {"token": tok.to(dev), "pos": pos0 + t})
        out["logits"].append(logits.cpu())
    out["last"] = last
    return out


def card_vs_cpu(card_run, cpu_run, tol: float, what: str) -> tuple[list[float], dict, dict]:
    """``card_run()`` and then ``cpu_run(fed)`` (:func:`logits_run` on
    each side, the CPU fed the card's tokens), and the largest |logits
    difference| of the prefill and of each step.  Above ``tol`` the check
    fails, having run both sides once more, so that the message says
    which side gives the same logits twice and how the card's fp32
    matmuls were set."""
    card = card_run()
    cpu = cpu_run(card["fed"])
    errs = [float((g - c).abs().max()) for g, c in zip(card["logits"], cpu["logits"])]
    if max(errs) > tol:
        again = {"card": card_run()["logits"], "cpu": cpu_run(card["fed"])["logits"]}
        repeats = {side: all(torch.equal(a, b) for a, b in zip(first["logits"], again[side]))
                   for side, first in (("card", card), ("cpu", cpu))}
        matmul = {"float32_matmul_precision": torch.get_float32_matmul_precision(),
                  "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                  "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
        require(False, f"{what}, card vs CPU logits: {errs} > {tol}; bitwise the same when run "
                       f"again: {repeats}; {matmul}")
    return errs, card, cpu


def hybrid_phase(card: str) -> dict:
    """Phase 23: RecurrentGemma-9B at full width and depth through
    ``build_arch`` (the module docstring).  Returns the phase's row for
    the kernels line."""
    import dataclasses

    from repro_torch.arch import build_arch, hybrid_lm, lm
    from repro_torch.config import get_arch_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as swa_kernel
    from repro_torch.launch.arch_demo import leaf_count
    from repro_torch.nn import attention as attn
    from repro_torch.nn.layers import rms_norm

    t_phase = time.perf_counter()
    cfg = get_arch_config(HYBRID_ARCH)
    nsb, window = hybrid_lm.num_super_blocks(cfg), cfg.local_attn_window
    arch = build_arch(cfg)
    t0 = time.perf_counter()
    params = arch.init_params(torch.Generator(device="cuda").manual_seed(23))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = leaf_count(params)
    tokens = torch.randint(0, cfg.vocab_size, (1, HYBRID_SEQ), dtype=torch.int32, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(24))
    prompt = {"tokens": tokens}

    # the main path: two prefills, counted
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    branches_before = dict(attn.BRANCHES)
    t0 = time.perf_counter()
    logits, none = arch.prefill_fn(params, prompt)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    MEASURED_RISE["hybrid_prefill"] = {"rise": torch.cuda.max_memory_allocated() - base,
                                       "baseline": base}
    first = launches()
    again, _ = arch.prefill_fn(params, prompt)
    torch.cuda.synchronize()
    counts, builds = launches(), dict(swa_kernel.BUILD_LAUNCHES)
    taken = {name: attn.BRANCHES[name] - branches_before[name] for name in attn.BRANCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(none is None, "the hybrid's prefill returned a state")
    require(first["swa_attention"] == nsb and counts["swa_attention"] == 2 * nsb,
            f"swa_attention launches {first['swa_attention']}, {counts['swa_attention']} "
            f"in two {nsb}-attention-layer prefills")
    require(sum(counts.values()) == 2 * nsb, f"another kernel ran in the prefill: {counts}")
    require(builds == {"wgmma-bf16-hd256": 2 * nsb}, f"swa_attention builds launched: {builds}")
    require(taken == {"plain": 0, "flash": 0, "banded": 2 * nsb, "banded_grad": 0},
            f"attention branches {taken}")
    vocab_padded = params["lm_head"].shape[1]
    require(tuple(logits.shape) == (1, 1, vocab_padded) and bool(torch.isfinite(logits).all()),
            f"prefill logits {tuple(logits.shape)} or non-finite")
    require(torch.equal(logits, again), "two prefills of the same prompt differ")

    # decode from init_state: the ring holds the window
    state = arch.init_decode_state(params, 1, HYBRID_SEQ)
    require(tuple(state["kv2"].k.shape) == (nsb, 1, window, cfg.num_kv_heads, cfg.head_dim),
            f"decode ring {tuple(state['kv2'].k.shape)}")
    tok, decoded, step_walls = tokens[:, :1], [], []
    for t in range(HYBRID_DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_logits, state = arch.decode_fn(params, state, {"token": tok, "pos": t})
        torch.cuda.synchronize()
        step_walls.append(time.perf_counter() - t0)
        require(bool(torch.isfinite(step_logits).all()), f"decode step {t}: non-finite logits")
        tok = torch.argmax(step_logits[:, -1, :cfg.vocab_size], dim=-1)[:, None].to(torch.int32)
        decoded.append(int(tok))
    require(launches()["swa_attention"] == 2 * nsb, "decode launched swa_attention")
    require(bool((state["kv2"].pos == HYBRID_DECODE_STEPS).all()), "decode ring positions")

    # the prefill timed (host clock around a synced call) and profiled
    walls = []
    for _ in range(HYBRID_TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arch.prefill_fn(params, prompt)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        arch.prefill_fn(params, prompt)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    split, top, items, scan_spans = hybrid_split(prof)
    require(split["swa_attention"] > 0 and split["gemm"] > 0,
            f"the profiler saw no swa_attention or GEMM kernel: {split}")
    del prof

    # one attention layer at full width against the plain twin (bf16 bound)
    mix = {name: t[0] for name, t in params["blocks"][2]["mix"].items()}
    x = torch.randn((1, HYBRID_SEQ, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(26)).bfloat16()
    h = rms_norm(x, params["blocks"][2]["ln1_scale"][0], cfg.norm_eps)
    q, k, v = (t.contiguous() for t in lm.qkv(h, mix, cfg, torch.arange(HYBRID_SEQ,
                                                                                device="cuda")))
    out = swa_kernel.swa_attention(q, k, v, window=window)
    o32 = ref.swa_attention_plain(q.float(), k.float(), v.float(), window=window)
    diff = (out.float() - o32).abs()
    del o32
    layer = {"max_abs_err": float(diff.max()),
             "max_err_over_bound": float((diff / ref.swa_bf16_bound(q, k, v, window=window)).max())}
    require(layer["max_err_over_bound"] <= 1.0,
            f"one attention layer at full width vs swa_attention_plain: {layer}")
    del params, logits, again, state, x, h, q, k, v, out, diff
    torch.cuda.empty_cache()

    # the model at one super-block, full width, fp32: card against CPU
    one = dataclasses.replace(cfg, num_layers=len(hybrid_lm._pattern(cfg)), dtype="float32")
    one_arch = build_arch(one)
    gpu_params = one_arch.init_params(torch.Generator(device="cuda").manual_seed(27))
    cpu_params = cpu_tree(gpu_params)
    toks = tokens[:, :HYBRID_SLICE_SEQ]
    before = dict(attn.BRANCHES)

    def one_run(params, toks):
        return lambda feed=None: logits_run(
            one_arch, params, toks, 2, one.vocab_size, feed=feed,
            state=one_arch.init_decode_state(params, 1, HYBRID_SLICE_SEQ))

    slice_err, _, _ = card_vs_cpu(one_run(gpu_params, toks), one_run(cpu_params, toks.cpu()),
                                  LM_SLICE_TOL["logits"], "one super-block at full width")
    require(attn.BRANCHES["banded"] - before["banded"] == 2, "the one-super-block slice missed "
                                                             "the banded branch")
    del gpu_params, cpu_params
    torch.cuda.empty_cache()

    prefill_s = statistics.median(walls)
    busy_ms = sum(split.values())
    emit("hybrid", arch=HYBRID_ARCH, d_model=cfg.d_model, lru_width=cfg.lru_width,
         heads=cfg.num_heads, kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, window=window, super_blocks=nsb, layers=nsb * 3,
         params=n_params, dtype=cfg.dtype, reduced={},
         prompt=HYBRID_SEQ, batch=1, init_s=init_s, first_prefill_s=first_s,
         launches_per_prefill=first, launches_two_prefills=counts, builds_two_prefills=builds,
         branches_two_prefills=taken, prefill_bitwise_repeat=True, peak_memory_gb=peak_gb,
         logits_shape=[1, 1, vocab_padded], decode_steps=HYBRID_DECODE_STEPS,
         decoded_tokens=decoded, decode_step_ms_median=statistics.median(step_walls) * 1e3,
         decode_step_ms=[w * 1e3 for w in step_walls], prefill_walls_s=walls,
         prefill_wall_s=prefill_s, prefill_tokens_per_s=HYBRID_SEQ / prefill_s,
         prefill_device_ms=split, prefill_top_device_ms=top, prefill_device_items=items,
         scan_spans=scan_spans,
         profiled_prefill_wall_s=profiled_s, prefill_device_busy_share=busy_ms / (profiled_s * 1e3),
         attention_layer_vs_plain=layer, one_super_block_fp32_seq=HYBRID_SLICE_SEQ,
         one_super_block_card_vs_cpu_logits=slice_err, tol=LM_SLICE_TOL["logits"],
         seconds=time.perf_counter() - t_phase, nvidia_smi=card)
    return {"launches_phase23": counts["swa_attention"], "builds_phase23": builds,
            "launches_per_prefill_phase23": first["swa_attention"]}


def zoo_split(prof) -> tuple[dict[str, float], dict[str, float], int]:
    """Device time (ms) of a profiled prefill split into ``swa_attention``,
    the GEMMs and the other items of each ``ZOO_SPANS`` span (an item
    whose start lies in the span's range on the device timeline, the rule
    of :func:`span_breakdown`), and the GEMMs (``GEMM_NAMES``) and other
    items outside them; the ten largest items by name; the item count."""
    from torch.autograd import DeviceType

    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = {span: [(e.time_range.start, e.time_range.end) for e in on_device if e.name == span]
              for span in ZOO_SPANS}
    split = dict.fromkeys(("swa_attention", "gemm", "other")
                          + sum(ZOO_SPANS.values(), ()), 0.0)
    top: dict[str, float] = {}
    work = [e for e in on_device if e.name not in ZOO_SPANS]
    for e in work:
        name, start = e.name.lower(), e.time_range.start
        gemm_key, other_key = next((keys for span, keys in ZOO_SPANS.items()
                                    if any(lo <= start < hi for lo, hi in ranges[span])),
                                   ("gemm", "other"))
        kind = ("swa_attention" if "swa_attention_kernel" in name
                else gemm_key if any(g in name for g in GEMM_NAMES) else other_key)
        ms = (e.time_range.end - start) / 1e3
        split[kind] += ms
        top[e.name[:90]] = top.get(e.name[:90], 0.0) + ms
    return split, dict(sorted(top.items(), key=lambda kv: -kv[1])[:10]), len(work)


def mixtral_attention_layer(params, cfg, gen: torch.Generator) -> dict:
    """Layer 0's ``swa_attention`` of the Mixtral prefill on a normed
    random input at ``MIXTRAL_LAYER_SEQ`` tokens, against
    ``ref.swa_attention_plain`` one KV head's group at a time (the twin
    holds (S, S) scores), elementwise within ``swa_bf16_bound``."""
    from repro_torch.arch import lm
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as swa_kernel
    from repro_torch.nn.layers import rms_norm

    seq, window, rep = MIXTRAL_LAYER_SEQ, cfg.sliding_window, cfg.q_per_kv
    lp = {name: t[0] for name, t in params["layers"].items() if not isinstance(t, dict)}
    x = torch.randn((1, seq, cfg.d_model), device="cuda", generator=gen).bfloat16()
    h = rms_norm(x, lp["ln1_scale"], cfg.norm_eps)
    q, k, v = (t.contiguous() for t in lm.qkv(h, lp, cfg, torch.arange(seq, device="cuda")))
    out = swa_kernel.swa_attention(q, k, v, window=window)
    err, over = 0.0, 0.0
    for g in range(cfg.num_kv_heads):
        qg, kg, vg = q[:, :, g * rep:(g + 1) * rep], k[:, :, g:g + 1], v[:, :, g:g + 1]
        o32 = ref.swa_attention_plain(qg.float(), kg.float(), vg.float(), window=window)
        diff = (out[:, :, g * rep:(g + 1) * rep].float() - o32).abs()
        del o32
        err = max(err, float(diff.max()))
        over = max(over, float((diff / ref.swa_bf16_bound(qg, kg, vg, window=window)).max()))
        del diff
    return {"seq": seq, "max_abs_err": err, "max_err_over_bound": over}


def zoo_phase(card: str) -> dict:
    """Phase 25: the MoE, SSM and enc-dec families through ``build_arch``
    at full width (the module docstring).  Returns the phase's part of
    the ``swa_attention`` row of the kernels line."""
    import dataclasses

    from repro_torch.arch import build_arch, encdec
    from repro_torch.config import get_arch_config
    from repro_torch.kernels import swa_attention as swa_kernel
    from repro_torch.launch import arch_demo
    from repro_torch.launch.arch_demo import leaf_count
    from repro_torch.nn import attention as attn

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    row: dict = {}
    for seed, (name, layers, seq, want_branches, slice_seq) in enumerate(ZOO):
        t_cfg = time.perf_counter()
        full = get_arch_config(name)
        cfg = dataclasses.replace(full, num_layers=layers) if layers else full
        is_mixtral, is_encdec = cfg.sliding_window > 0, cfg.family == "encdec"
        arch = build_arch(cfg)
        gen = torch.Generator(device="cuda").manual_seed(2500 + 10 * seed)
        t0 = time.perf_counter()
        params = arch.init_params(gen)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = leaf_count(params)
        tokens = torch.randint(0, cfg.vocab_size, (1, seq), dtype=torch.int32, device="cuda",
                               generator=gen)
        prompt = {"tokens": tokens}
        if is_encdec:
            spec = arch.input_specs("prefill_32k", override_batch=1, override_seq=seq)["frames"]
            prompt["frames"] = torch.randn(tuple(spec.shape), device="cuda",
                                           generator=gen).to(spec.dtype)

        # the main path: two prefills, counted
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches()
        branches_before = dict(attn.BRANCHES)
        t0 = time.perf_counter()
        logits, state = arch.prefill_fn(params, prompt)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        if is_mixtral:
            MEASURED_RISE["mixtral_prefill"] = {"rise": torch.cuda.max_memory_allocated() - base,
                                                "baseline": base}
        first = launches()
        again, _ = arch.prefill_fn(params, prompt)
        torch.cuda.synchronize()
        counts, builds = launches(), dict(swa_kernel.BUILD_LAUNCHES)
        taken = {kind: attn.BRANCHES[kind] - branches_before[kind] for kind in attn.BRANCHES}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_swa = cfg.num_layers if is_mixtral else 0
        require(first["swa_attention"] == n_swa and counts["swa_attention"] == 2 * n_swa
                and sum(counts.values()) == 2 * n_swa,
                f"{name}: kernel launches {first} in one prefill, {counts} in two")
        require(builds == ({"wgmma-bf16-hd128": 2 * n_swa} if n_swa else {}),
                f"{name}: swa_attention builds launched {builds}")
        require(taken == {kind: 2 * n for kind, n in want_branches.items()},
                f"{name}: attention branches {taken} in two prefills")
        vocab_padded = params["embed"].shape[0]
        require(tuple(logits.shape) == (1, 1, vocab_padded) and bool(torch.isfinite(logits).all()),
                f"{name}: prefill logits {tuple(logits.shape)} or non-finite")
        require(torch.equal(logits, again), f"{name}: two prefills of the same prompt differ")
        del again

        # 16 greedy decode steps: from the prefill's state, or (enc-dec)
        # from init_state with the frames, the serving path
        if is_encdec:
            state = encdec.init_state(params, cfg, 1, seq + ZOO_DECODE_STEPS,
                                      frames=prompt["frames"])
        pos0 = 0 if is_encdec else seq
        tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)[:, None].to(torch.int32)
        decoded, step_walls = [], []
        for t in range(ZOO_DECODE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_logits, state = arch.decode_fn(params, state, {"token": tok, "pos": pos0 + t})
            torch.cuda.synchronize()
            step_walls.append(time.perf_counter() - t0)
            require(bool(torch.isfinite(step_logits).all()), f"{name}: decode step {t} non-finite")
            tok = torch.argmax(step_logits[:, -1, :cfg.vocab_size], dim=-1)[:, None].to(torch.int32)
            decoded.append(int(tok))
        require(launches() == counts, f"{name}: decode launched a kernel: {launches()}")
        extra = {}
        if is_encdec:  # Arch.init_decode_state: the zero encoder output (ROADMAP Queue 3)
            blind = arch.init_decode_state(params, 1, seq + ZOO_DECODE_STEPS)
            require(not bool(blind["cross"]["k"].any()), f"{name}: init_decode_state's cross K")
            first_step = {"token": torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)[:, None]
                          .to(torch.int32), "pos": 0}
            blind_logits, _ = arch.decode_fn(params, blind, first_step)
            heard, _ = arch.decode_fn(params, encdec.init_state(params, cfg, 1, 8,
                                                                frames=prompt["frames"]),
                                      first_step)
            require(bool(torch.isfinite(blind_logits).all()), f"{name}: init_decode_state path")
            extra["init_decode_state_vs_frames_max_abs_diff"] = float(
                (blind_logits.float() - heard.float()).abs().max())
            del blind, heard
        del state

        # the prefill timed (host clock around a synced call) and profiled
        walls = []
        for _ in range(ZOO_TIMED_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            arch.prefill_fn(params, prompt)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            arch.prefill_fn(params, prompt)
            torch.cuda.synchronize()
            profiled_s = time.perf_counter() - t0
        split, top, items = zoo_split(prof)
        del prof
        require(split["gemm"] + split["moe_gemm"] + split["ssd_gemm"] > 0,
                f"{name}: the profiler saw no GEMM: {split}")
        require((split["swa_attention"] > 0) == is_mixtral, f"{name}: swa_attention time {split}")

        if is_mixtral:  # the kernel at this path's shapes, against its twin and timed
            extra["attention_layer_vs_plain"] = mixtral_attention_layer(params, cfg, gen)
            require(extra["attention_layer_vs_plain"]["max_err_over_bound"] <= 1.0,
                    f"{name}: one attention layer vs swa_attention_plain: "
                    f"{extra['attention_layer_vs_plain']}")
            q, k, v = swa_inputs(gen, 1, seq, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                 torch.bfloat16)
            timing = swa_timing(q, k, v, cfg.sliding_window, BF16_OPS_PER_S)
            del q, k, v
            row = {"launches_phase25": counts["swa_attention"], "builds_phase25": builds,
                   "launches_per_prefill_phase25": first["swa_attention"],
                   "mixtral_shape": dict(B=1, S=seq, H=cfg.num_heads, K=cfg.num_kv_heads,
                                         hd=cfg.head_dim, window=cfg.sliding_window),
                   "mixtral": {**timing, **extra["attention_layer_vs_plain"]}}
            extra["swa_attention"] = timing
        del params, logits, prompt
        torch.cuda.empty_cache()

        # one layer (enc-dec: one of each) at full width, fp32: card against CPU
        one = dataclasses.replace(full, num_layers=1, dtype="float32",
                                  encoder_layers=1 if is_encdec else full.encoder_layers)
        one_arch = build_arch(one)
        one_gen = torch.Generator(device="cuda").manual_seed(2501 + 10 * seed)
        gpu_params = one_arch.init_params(one_gen)
        cpu_params = cpu_tree(gpu_params)
        toks = tokens[:, :slice_seq]
        frames = torch.randn((1, one.encoder_seq, one.d_model), device="cuda",
                             generator=gen) if is_encdec else None

        def one_run(p, toks, frames):
            def run(feed=None):
                if not is_encdec:
                    return logits_run(one_arch, p, toks, 2, one.vocab_size, feed=feed)
                state = encdec.init_state(p, one, 1, slice_seq + 2, frames=frames)
                return logits_run(one_arch, p, toks, 2, one.vocab_size, feed=feed, state=state,
                                  extra={"frames": frames})
            return run

        slice_err, _, _ = card_vs_cpu(
            one_run(gpu_params, toks, frames),
            one_run(cpu_params, toks.cpu(), None if frames is None else frames.cpu()),
            LM_SLICE_TOL["logits"], f"{name}: one layer at full width")
        del gpu_params, cpu_params, frames
        torch.cuda.empty_cache()

        with contextlib.redirect_stdout(io.StringIO()) as demo_out:
            rc = arch_demo.main(["--arch", name, "--tokens", "4"])
        require(rc == 0, f"arch_demo --arch {name} exited {rc}")

        prefill_s = statistics.median(walls)
        emit("zoo", arch=name, family=cfg.family, citation=cfg.citation, d_model=cfg.d_model,
             layers=cfg.num_layers, encoder_layers=cfg.encoder_layers, heads=cfg.num_heads,
             kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
             experts=cfg.num_experts, top_k=cfg.experts_per_token, window=cfg.sliding_window,
             ssm_state=cfg.ssm_state, vocab=cfg.vocab_size, params=n_params, dtype=cfg.dtype,
             reduced=({"num_layers": f"{full.num_layers}->{layers}", "batch": "32->1"} if layers
                      else {"batch": "32->1"}),
             prompt=seq, batch=1, init_s=init_s, first_prefill_s=first_s,
             launches_per_prefill=first, launches_two_prefills=counts, builds_two_prefills=builds,
             branches_two_prefills=taken, prefill_bitwise_repeat=True, peak_memory_gb=peak_gb,
             decode_steps=ZOO_DECODE_STEPS, decode_from=("init_state(frames)" if is_encdec
                                                         else "prefill"),
             decoded_tokens=decoded, decode_step_ms_median=statistics.median(step_walls) * 1e3,
             decode_step_ms=[w * 1e3 for w in step_walls], prefill_walls_s=walls,
             prefill_wall_s=prefill_s, prefill_tokens_per_s=seq / prefill_s,
             prefill_device_ms=split, prefill_top_device_ms=top, prefill_device_items=items,
             profiled_prefill_wall_s=profiled_s,
             prefill_device_busy_share=sum(split.values()) / (profiled_s * 1e3),
             one_layer_fp32_seq=slice_seq, one_layer_card_vs_cpu_logits=slice_err,
             tol=LM_SLICE_TOL["logits"], arch_demo=demo_out.getvalue().strip().splitlines()[-2:],
             seconds=time.perf_counter() - t_cfg, nvidia_smi=card, **extra)
    return row


def train_slice_vs_cpu(name: str, seed: int) -> dict:
    """One train step (M=2) of ``name``'s reduced config on the card and
    on the CPU from the same fp32 params and batch, held to the CPU
    tests' tolerances (``TRAIN_SLICE_TOL``).  A failure runs both sides
    once more and says which side repeats itself bitwise and how the
    card's fp32 matmuls were set."""
    from repro_torch.arch import build_arch
    from repro_torch.arch.common import init_train_state, make_train_step
    from repro_torch.config import get_arch_config
    from repro_torch.utils.pytree import tree_leaves, tree_map

    cfg = get_arch_config(name).reduced()
    arch = build_arch(cfg)
    gen = torch.Generator().manual_seed(seed)
    params = arch.init_params(gen, torch.float32)
    batch = {k: (torch.randint(0, cfg.vocab_size, tuple(v.shape), generator=gen,
                               dtype=torch.int32) if v.dtype == torch.int32
                 else torch.randn(tuple(v.shape), generator=gen))
             for k, v in arch.input_specs("train_4k", override_batch=TRAIN_SLICE_BATCH,
                                          override_seq=TRAIN_SLICE_SEQ).items()}
    step = make_train_step(arch.loss_fn, num_microbatches=TRAIN_MICRO, lr=TRAIN_SLICE_LR)

    def run(device):
        state = init_train_state(tree_map(lambda t: t.to(device), params))
        new, metrics = step(state, {k: v.to(device) for k, v in batch.items()})
        return {"loss": metrics["loss"].cpu(), "m": [t.cpu() for t in tree_leaves(new.m)],
                "params": [t.detach().cpu() for t in tree_leaves(new.params)]}

    def errors(card, cpu):
        loss = float((card["loss"] - cpu["loss"]).abs() / cpu["loss"].abs())
        moment = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                     for a, b in zip(card["m"], cpu["m"]))
        signal = noise = 0.0
        for a, b, m in zip(card["params"], cpu["params"], cpu["m"]):
            err, g = (a - b).abs(), m / 0.1  # m = (1 - b1) g after the first step
            big = g.abs() > TRAIN_SLICE_TOL["g_noise"]
            signal = max(signal, float(err[big].max()) if bool(big.any()) else 0.0)
            noise = max(noise, float(err.max()))
        return {"loss_rel": loss, "m_rel": moment, "param_signal_max": signal,
                "param_max": noise}

    card, cpu = run("cuda"), run("cpu")
    errs = errors(card, cpu)
    ok = (errs["loss_rel"] <= TRAIN_SLICE_TOL["loss"] and errs["m_rel"] <= TRAIN_SLICE_TOL["moment"]
          and errs["param_signal_max"] <= TRAIN_SLICE_LR * TRAIN_SLICE_TOL["param"]
          and errs["param_max"] <= 2 * TRAIN_SLICE_LR)
    if not ok:
        again = {"card": run("cuda"), "cpu": run("cpu")}
        repeats = {side: all(torch.equal(x, y) for key in ("m", "params")
                             for x, y in zip(first[key], again[side][key]))
                   for side, first in (("card", card), ("cpu", cpu))}
        matmul = {"float32_matmul_precision": torch.get_float32_matmul_precision(),
                  "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
        require(False, f"{name}: one train step, card vs CPU: {errs} against {TRAIN_SLICE_TOL} "
                       f"(lr {TRAIN_SLICE_LR}); bitwise the same when run again: {repeats}; "
                       f"{matmul}")
    return errs


def lstm_gates_bytes(n: int, bsz: int, isz: int, hsz: int) -> dict[str, float]:
    """Bytes one step of each gate kernel moves, each operand once: the
    forward reads G_t (4H), c_{t-1} and x and writes the activated gates
    (4H), c_t and h_t, a row; the backward reads the gates, c_{t-1}, c_t,
    dh and dc and writes dG (4H) and dc, a row, and reads and writes db
    and dwx; both read b and wx once a row of the federation."""
    rows, params = n * bsz, n * (isz + 1) * 4 * hsz
    return {"fwd": 4 * (rows * (11 * hsz + isz) + params),
            "bwd": 4 * (rows * (13 * hsz + isz) + 2 * params)}


def lstm_train_phase(card: str) -> dict:
    """Phase 28: the trainer's gate kernels and its hand-written
    backpropagation through time at the benchmark's two cells' shapes
    (the module docstring).  Returns the rows of the two kernels for the
    kernels line."""
    import dataclasses

    from repro_torch.core.gluadfl import mse_value_and_grad
    from repro_torch.kernels import lstm_train
    from repro_torch.kernels import ref as kref
    from repro_torch.models import LSTMModel
    from repro_torch.utils.pytree import ParamLayout

    rows = {"lstm_gates_fwd": {}, "lstm_gates_bwd": {}}
    for cell, (n, bsz, steps, isz, hsz) in LSTM_TRAIN_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(2800 + hsz)

        def normal(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * scale

        model = LSTMModel(history_len=steps, hidden=hsz, input_size=isz)
        layout = ParamLayout.of(model.init(torch.Generator().manual_seed(0)))
        stacked = {"wx": normal(n, isz, 4 * hsz, scale=isz ** -0.5),
                   "wh": normal(n, hsz, 4 * hsz, scale=hsz ** -0.5),
                   "b": normal(n, 4 * hsz, scale=0.5), "w_out": normal(n, hsz, 1, scale=hsz ** -0.5),
                   "b_out": normal(n, 1, scale=0.5)}
        flat = layout.flatten(stacked)
        del stacked
        p = layout.views(flat)
        bx, by = normal(n, bsz, steps), normal(n, bsz)

        # one step of each kernel against its twin, then timed (in place, on
        # the same buffers: the bytes do not depend on the values)
        state = {"gates": normal(n, bsz, 4 * hsz), "x": bx[:, :, 1:2], "c_prev": normal(n, bsz, hsz),
                 "c": torch.empty(n, bsz, hsz, device="cuda"),
                 "h": torch.empty(n, bsz, hsz, device="cuda"), "dh": normal(n, bsz, hsz),
                 "dc": normal(n, bsz, hsz), "db": torch.zeros_like(p["b"]),
                 "dwx": torch.zeros_like(p["wx"])}
        twin = {k: v.clone() for k, v in state.items()}

        def fwd(fn, v):
            return lambda: fn(v["gates"], v["x"], p["wx"], p["b"], v["c_prev"], v["c"], v["h"])

        def bwd(fn, v):
            return lambda: fn(v["gates"], v["c_prev"], v["c"], v["dh"], v["dc"], v["x"], v["db"],
                              v["dwx"], True)

        fwd(lstm_train.lstm_gates_fwd, state)()
        fwd(kref.lstm_gates_fwd_plain, twin)()
        fwd_err = max(float((state[k] - twin[k]).abs().max()) for k in ("gates", "c", "h"))
        fwd_bitwise = all(torch.equal(state[k], twin[k]) for k in ("gates", "c", "h"))
        bwd(lstm_train.lstm_gates_bwd, state)()
        bwd(kref.lstm_gates_bwd_plain, twin)()
        bwd_err = max(float((state[k] - twin[k]).abs().max()) for k in ("gates", "dc"))
        sums_err = max(float((state[k] - twin[k]).abs().max() / twin[k].abs().max())
                       for k in ("db", "dwx"))
        require(fwd_err <= LSTM_GATES_ATOL and bwd_err <= LSTM_GATES_ATOL
                and sums_err <= LSTM_GATE_SUMS_RTOL,
                f"{cell}: gate kernels vs twins {fwd_err}, {bwd_err}, sums {sums_err}")
        nbytes = lstm_gates_bytes(n, bsz, isz, hsz)
        for name, make in (("lstm_gates_fwd", fwd), ("lstm_gates_bwd", bwd)):
            kernel = make(getattr(lstm_train, name), state)
            plain = make(getattr(kref, name + "_plain"), twin)
            bound_ms = nbytes[name[-3:]] / HBM_BYTES_PER_S * 1e3
            ms = time_ms(kernel, runs=100)
            rows[name][cell] = {
                "shape": {"N": n, "B": bsz, "I": isz, "H": hsz}, "ms": ms,
                "bound_ms": bound_ms, "bound": "bytes", "bound_share": bound_ms / ms,
                "plain_ms": time_ms(plain, runs=20),
                "max_abs_err": fwd_err if name.endswith("fwd") else bwd_err}
        rows["lstm_gates_fwd"][cell]["bitwise_twin"] = fwd_bitwise
        rows["lstm_gates_bwd"][cell]["sums_max_rel_err"] = sums_err
        del state, twin

        # the whole loss and gradient: the hand-written path against autograd
        # through apply_nodes (the path it replaces), in turns
        hand_model = model.as_model()
        auto_model = dataclasses.replace(hand_model, forward_for_grad=None)

        def hand():
            return mse_value_and_grad(hand_model, layout, flat, bx, by)

        def auto():
            return mse_value_and_grad(auto_model, layout, flat, bx, by)

        before = dict(lstm_train.LAUNCHES)
        losses, grads = hand()
        torch.cuda.synchronize()
        require(lstm_train.LAUNCHES == {k: v + steps for k, v in before.items()},
                f"{cell}: gate launches a local step {before} -> {lstm_train.LAUNCHES}")
        want_l, want_g = auto()
        loss_rel = float(((losses - want_l).abs() / want_l.abs()).max())
        got, want = layout.views(grads), layout.views(want_g)
        leaf_rel = {k: float((got[k] - want[k]).abs().max() / want[k].abs().max())
                    for k in layout.names}
        require(loss_rel <= 1e-6 and max(leaf_rel.values()) <= LSTM_VG_RTOL,
                f"{cell}: hand vs autograd loss {loss_rel}, leaves {leaf_rel}")
        del losses, grads, want_l, want_g, got, want
        peaks = {}
        for name, fn in (("hand", hand), ("autograd", auto)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn()
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() - base
            del out
        times = {"autograd": [], "hand": []}
        for name in ("autograd", "hand", "hand", "autograd"):
            times[name].append(time_ms(hand if name == "hand" else auto, runs=10, warmup=2))
        ops = 3 * n * bsz * (steps * 2 * (isz + hsz) * 4 * hsz + 2 * hsz)
        hand_ms, auto_ms = statistics.median(times["hand"]), statistics.median(times["autograd"])
        vg = {"ms": hand_ms, "autograd_ms": auto_ms, "runs_ms": times,
              "speedup": auto_ms / hand_ms, "bound_ms": ops / FP32_OPS_PER_S * 1e3,
              "bound": "operations", "bound_share": ops / FP32_OPS_PER_S * 1e3 / hand_ms,
              "peak_bytes": peaks["hand"], "autograd_peak_bytes": peaks["autograd"],
              "loss_max_rel_err": loss_rel, "leaf_max_rel_err": leaf_rel}
        rows["lstm_gates_bwd"][cell]["value_and_grad"] = vg
        emit("lstmtrain", cell=cell, card=card, fwd=rows["lstm_gates_fwd"][cell],
             bwd=rows["lstm_gates_bwd"][cell])
        del flat, p, bx, by
        torch.cuda.empty_cache()
    return rows


def train_phase(card: str) -> dict:
    """Phase 26: the LM zoo's train step (the module docstring).  Returns
    the phase's part of the ``swa_attention`` row of the kernels line."""
    import socket
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.arch import build_arch
    from repro_torch.arch.common import init_train_state, make_train_step
    from repro_torch.config import get_arch_config
    from repro_torch.core.gossip_dp import GossipDPSchedule, gossip_mix_params, ring_mix_params
    from repro_torch.launch.arch_demo import leaf_count
    from repro_torch.launch.mesh import make_gossip_dp_mesh
    from repro_torch.kernels import swa_attention as swa_kernel
    from repro_torch.nn import attention as attn
    from repro_torch.utils.pytree import tree_leaves

    t_phase = time.perf_counter()
    cfg = get_arch_config(TRAIN_ARCH)
    arch = build_arch(cfg)
    gen = torch.Generator(device="cuda").manual_seed(2600)
    params = arch.init_params(gen, torch.float32)
    n_params = leaf_count(params)
    require({leaf.dtype for leaf in tree_leaves(params)} == {torch.float32}, "fp32 masters")
    initial = [leaf.cpu() for leaf in tree_leaves(params)]
    batch = {k: torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32,
                              device="cuda", generator=gen) for k in ("tokens", "labels")}
    step = make_train_step(arch.loss_fn, num_microbatches=TRAIN_MICRO)
    state = init_train_state(params)
    del params

    # (1) the main path: TRAIN_STEPS steps on one fixed batch, counted
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # the state and the batch: the step's arguments
    reset_launches()
    branches_before = dict(attn.BRANCHES)
    losses, norms, walls = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            MEASURED_RISE["train"] = {"rise": torch.cuda.max_memory_allocated() - base,
                                      "baseline": base}
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    counts, builds = launches(), dict(swa_kernel.BUILD_LAUNCHES)
    taken = {kind: attn.BRANCHES[kind] - branches_before[kind] for kind in attn.BRANCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(sum(counts.values()) == 0, f"the train step launched a kernel of ours: {counts}")
    # forward and its rematerialisation, a layer a microbatch a step
    flash = 2 * cfg.num_layers * TRAIN_MICRO * TRAIN_STEPS
    require(taken == {"plain": 0, "flash": flash, "banded": 0, "banded_grad": 0},
            f"attention branches {taken} in {TRAIN_STEPS} steps")
    require(all(math.isfinite(x) for x in losses + norms) and min(norms) > 0,
            f"losses {losses}, grad norms {norms}")
    require(losses[-1] < losses[0], f"the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    require(int(state.step) == TRAIN_STEPS and state.step.dtype == torch.int32,
            f"step {state.step}")
    moved = [not torch.equal(leaf.detach().cpu(), first)
             for leaf, first in zip(tree_leaves(state.params), initial)]
    require(all(moved), f"{moved.count(False)} of {len(moved)} leaves did not move")
    require(all(bool(torch.isfinite(t).all()) for t in tree_leaves(state.m) + tree_leaves(state.v)),
            "non-finite Adam moments")
    del initial

    # remat recomputes each layer in the backward pass, which must give the
    # first forward's values: the MoE's combine is scatter_add_ (atomics), one
    # an expert over distinct positions of a row, so two forwards are bitwise equal
    from repro_torch.arch import lm

    micro = {key: t[:TRAIN_BATCH // TRAIN_MICRO] for key, t in batch.items()}
    with torch.no_grad():
        first_logits, first_aux = lm.forward(state.params, cfg, micro)
        again_logits, again_aux = lm.forward(state.params, cfg, micro)
    require(torch.equal(first_logits, again_logits) and torch.equal(first_aux, again_aux),
            "two forwards of one microbatch differ: the recomputed forward would not be the first")
    del first_logits, again_logits, first_aux, again_aux

    # one more step under the profiler: the card's busy share
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    split, top, items = zoo_split(prof)
    del prof
    require(math.isfinite(float(metrics["loss"])), "the profiled step's loss")
    step_s = statistics.median(walls[1:])

    # (2) one reduced config a family: card against CPU at one step
    slices = {name: train_slice_vs_cpu(name, 2610 + i) for i, name in enumerate(TRAIN_SLICES)}

    # (3) the banded shape under grad: the plain banded path, bitwise;
    # without grad one kernel launch
    sh = TRAIN_BANDED
    q, k, v = swa_inputs(gen, 1, sh["s"], sh["h"], sh["kh"], sh["hd"], torch.bfloat16)
    reset_launches()
    before = dict(attn.BRANCHES)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attn.gqa_attention(*leaves, causal=True, window=sh["window"])
    grad_launches = launches()["swa_attention"]
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = attn.banded_flash_attention(*ref_leaves, window=sh["window"])
    cot = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    grads = torch.autograd.grad(out, leaves, cot)
    ref_grads = torch.autograd.grad(ref, ref_leaves, cot)
    require(torch.equal(out, ref) and all(torch.equal(a, b) for a, b in zip(grads, ref_grads)),
            "banded_grad is not banded_flash_attention bitwise (output or q/k/v gradients)")
    with torch.no_grad():
        attn.gqa_attention(q, k, v, causal=True, window=sh["window"])
    banded_taken = {kind: attn.BRANCHES[kind] - before[kind] for kind in attn.BRANCHES}
    require(grad_launches == 0 and launches()["swa_attention"] == 1
            and banded_taken == {"plain": 0, "flash": 0, "banded": 1, "banded_grad": 1},
            f"banded shape: {grad_launches} launches under grad, {launches()} in all, "
            f"branches {banded_taken}")
    del q, k, v, leaves, ref_leaves, out, ref, grads, ref_grads, cot

    # (4) gossip-DP on a one-rank NCCL group over the trained params
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
                            timeout=timedelta(seconds=300))
    gossip = {}
    try:
        mesh = make_gossip_dp_mesh(nodes=1, data=1, model=1, device="cuda")
        require(mesh.node_group(("node",)) is not None, "no node subgroup on the NCCL group")
        mix = torch.ones((1, 1), device="cuda")
        params = state.params
        for impl in ("allgather", "masked", "psum"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mixed = gossip_mix_params(params, mix, mesh, ("node",), impl=impl)
            torch.cuda.synchronize()
            gossip[f"{impl}_s"] = time.perf_counter() - t0
            require(all(torch.equal(a, b) for a, b in zip(tree_leaves(mixed), tree_leaves(params))),
                    f"gossip_mix_params {impl} at W=1 is not the identity")
            del mixed
        ring = ring_mix_params(params, mesh, ("node",))
        require(all(torch.equal(a, b) for a, b in zip(tree_leaves(ring), tree_leaves(params))),
                "ring_mix_params at W=1 is not the identity")
        for schedule in ("bernoulli", "markov"):
            sched = GossipDPSchedule("random", GOSSIP_DP_NODES, inactive_ratio=0.3, seed=26,
                                     schedule=schedule, device="cuda")
            mixes = [sched.next_mix() for _ in range(GOSSIP_DP_MIXES)]
            rows = max(float((m.sum(dim=1) - 1).abs().max()) for m in mixes)
            require(all(m.device.type == "cuda" and tuple(m.shape) == (GOSSIP_DP_NODES,) * 2
                        and bool((m >= 0).all()) for m in mixes) and rows <= 1e-6,
                    f"{schedule} mixes: rows off 1 by {rows}")
            gossip[schedule] = {"rows_max_abs_off_one": rows,
                                "active_at_last_mix": int(sched.prev_active.sum()),
                                "distinct": len({m.cpu().numpy().tobytes() for m in mixes})}
    finally:
        dist.destroy_process_group()
    del state, params, ring
    torch.cuda.empty_cache()

    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit("train", arch=TRAIN_ARCH, family=cfg.family, citation=cfg.citation, d_model=cfg.d_model,
         layers=cfg.num_layers, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
         head_dim=cfg.head_dim, d_ff=cfg.d_ff, experts=cfg.num_experts,
         top_k=cfg.experts_per_token, vocab=cfg.vocab_size, params=n_params,
         masters="float32", compute_dtype=cfg.dtype, seq=TRAIN_SEQ, global_batch=TRAIN_BATCH,
         num_microbatches=TRAIN_MICRO, reduced={"global_batch": f"256->{TRAIN_BATCH}"},
         steps=TRAIN_STEPS, losses=losses, grad_norms=norms, step_walls_s=walls,
         forward_bitwise_repeat=True,
         step_ms_median_2_to_4=step_s * 1e3, tokens_per_s=tokens / step_s,
         peak_memory_gb=peak_gb, launches=counts, branches=taken,
         swa_attention_launches=counts["swa_attention"], profiled_step_s=profiled_s,
         step_device_ms=split, step_top_device_ms=top, step_device_items=items,
         step_device_busy_share=sum(split.values()) / (profiled_s * 1e3),
         card_vs_cpu_one_step=slices, card_vs_cpu_tol=TRAIN_SLICE_TOL, lr_slices=TRAIN_SLICE_LR,
         banded_grad={**TRAIN_BANDED, "bitwise_banded_flash_attention": True,
                      "launches_under_grad": grad_launches, "launches_without_grad": 1},
         gossip_dp=gossip, seconds=time.perf_counter() - t_phase, nvidia_smi=card)
    return {"launches_phase26": counts["swa_attention"], "builds_phase26": builds}


def start_dryruns() -> list:
    """Phase 27's two CPU processes, which trace side by side: this
    script's ``--dryrun-predictions`` mode and the dry run's CLI on the
    production mesh.  They see no card (``CUDA_VISIBLE_DEVICES``
    empty)."""
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    cli = ("import sys, json\n"
           "from repro_torch.launch import dryrun\n"
           f"dryrun.main({DRYRUN_CLI + ['--out-dir', str(DRYRUN_OUT / 'cli')]!r})\n"
           "print(json.dumps({'jax_imported': 'jax' in sys.modules or 'repro' in sys.modules}))\n")
    commands = {"predictions": [sys.executable, str(Path(__file__).resolve()),
                                "--dryrun-predictions", str(DRYRUN_OUT / "predictions.json")],
                "cli": [sys.executable, "-c", cli]}
    procs: list = []
    atexit.register(stop_dryruns, procs)  # whatever phase fails, nothing is left running
    for name, command in commands.items():
        log = open(DRYRUN_OUT / f"{name}.log", "w")
        procs.append((name, log, subprocess.Popen(
            command, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)))
    return procs


def stop_dryruns(procs: list) -> None:
    for _, log, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def dryrun_predictions(out: Path) -> None:
    """The dry run's ``build_step`` and tracker on a (1, 1) fake mesh at
    three steps the card runs: phase 26's train step, phase 23's and
    phase 25's Mixtral prefill.  Writes each one's memory to ``out``."""
    import dataclasses

    sys.path.insert(0, str(ROOT / "src"))
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.arch import build_arch
    from repro_torch.arch.sharding import activation_policy, data_axes
    from repro_torch.config import get_arch_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_test_mesh

    torch.set_num_threads(2)
    mixtral, layers, seq = ZOO[0][:3]
    steps = {"train": (TRAIN_ARCH, 0, "train_4k", dict(
                 num_microbatches=TRAIN_MICRO, override_batch=TRAIN_BATCH, override_seq=TRAIN_SEQ)),
             "hybrid_prefill": (HYBRID_ARCH, 0, "prefill_32k",
                                dict(override_batch=1, override_seq=HYBRID_SEQ)),
             "mixtral_prefill": (mixtral, layers, "prefill_32k",
                                 dict(override_batch=1, override_seq=seq))}
    results = {}
    for key, (name, depth, shape, kw) in steps.items():
        cfg = get_arch_config(name)
        arch = build_arch(dataclasses.replace(cfg, num_layers=depth) if depth else cfg)
        t0 = time.perf_counter()
        with fake_world(1):
            mesh = make_test_mesh(1)
            with FakeTensorMode(), activation_policy(data_axes(mesh)):
                fn, args = dryrun.build_step(arch, shape, mesh, **kw)
                traced = dryrun.trace_step(fn, args)
        results[key] = {"arch": name, "layers": depth or cfg.num_layers, "shape": shape, **kw,
                        **traced["memory"], "flops": traced["flops"],
                        "seconds": time.perf_counter() - t0}
        print(json.dumps({key: results[key]}), flush=True)
    out.write_text(json.dumps(results, indent=2))


def dryrun_phase(card: str, procs: list) -> None:
    """Phase 27 (the module docstring): wait for the two dry-run
    processes, hold the predicted train step against the allocator, and
    print the production mesh's combinations."""
    t_phase = time.perf_counter()
    deadline = time.monotonic() + DRYRUN_WAIT_S
    try:
        for name, log, proc in procs:
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            log.close()
            require(rc == 0, f"the dry run's {name} process exited {rc}: "
                             f"{(DRYRUN_OUT / f'{name}.log').read_text()[-3000:]}")
    finally:
        stop_dryruns(procs)
    waited_s = time.perf_counter() - t_phase
    total = torch.cuda.get_device_properties(0).total_memory

    # (a) the fit: predicted rise (peak less the arguments) against the card's
    preds = json.loads((DRYRUN_OUT / "predictions.json").read_text())
    fit = {}
    for key, pred in preds.items():
        measured = MEASURED_RISE[key]
        predicted = pred["total_per_device_bytes"] - pred["argument_bytes"]
        fit[key] = {"predicted_rise_bytes": predicted, "measured_rise_bytes": measured["rise"],
                    "relative_error": predicted / measured["rise"] - 1,
                    "predicted_peak_bytes": pred["total_per_device_bytes"],
                    "argument_bytes": pred["argument_bytes"],
                    "card_baseline_bytes": measured["baseline"], "trace_s": pred["seconds"]}
        print(f"dryrun fit {key}: predicted rise {predicted / 1e9:.3f} GB, measured "
              f"{measured['rise'] / 1e9:.3f} GB (max_memory_allocated above the pre-step "
              f"baseline), {100 * fit[key]['relative_error']:+.1f}%", flush=True)
    err = abs(fit["train"]["relative_error"])
    require(err <= DRYRUN_FIT_TOL, f"the dry run's train-step peak is {100 * err:.1f}% off the "
                                   f"card's (bound {100 * DRYRUN_FIT_TOL:.0f}%): {fit['train']}")

    # (b) the production mesh, full width and depth, without JAX
    log = (DRYRUN_OUT / "cli.log").read_text()
    require("ALL DRY-RUNS OK" in log, f"the dry run's CLI: {log[-3000:]}")
    require(json.loads(log.strip().splitlines()[-1]) == {"jax_imported": False},
            "the dry run imported JAX or the JAX package")
    combos = {}
    for path in sorted((DRYRUN_OUT / "cli").glob("*.json")):
        rec = json.loads(path.read_text())
        mem = rec.get("memory", {})
        combos[f"{rec['arch']}/{rec['shape']}/{rec['mesh']}"] = row = {
            "status": rec["status"], "devices": rec.get("devices"),
            "argument_bytes": mem.get("argument_bytes"),
            "peak_bytes": mem.get("total_per_device_bytes"),
            "peak_share_of_card": mem["total_per_device_bytes"] / total if mem else None,
            "collectives": {k: v["count"] for k, v in rec.get("collectives", {}).items()
                            if isinstance(v, dict)},
            "seconds": rec.get("lower_s", 0) + rec.get("compile_s", 0)}
        print(f"dryrun {path.stem}: {row}", flush=True)
    for shape in DRYRUN_REQUIRED:
        key = f"mistral-large-123b/{shape}/pod16x16"
        require(combos.get(key, {}).get("status") == "ok", f"{key}: {combos.get(key)}")
    emit("dryrun", fit=fit, fit_tol=DRYRUN_FIT_TOL, card_total_memory=total,
         production=combos, waited_s=waited_s, seconds=time.perf_counter() - t_phase,
         nvidia_smi=card)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data import load_federated_dataset
    from repro_torch.kernels import _build, lstm_cell
    from repro_torch.kernels.ref import lstm_forward_plain
    from repro_torch.launch.serve import build_request_stream, selfcheck
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import LSTMModel
    from repro_torch.serve import GlucoseServable, MicroBatcher, replay
    from repro_torch.utils.pytree import tree_to_vector

    # fp32 matmuls in IEEE fp32, by the flags and by the precision setting
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # 1. card ------------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    emit("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    compiled = _build.build()
    seconds = time.perf_counter() - t0
    libraries = ("gossip_mix", "lstm_forward", "lstm_train", "swa_attention")
    require(all(_build.library_path(name).exists() for name in libraries),
            f"a kernel library is missing after the build (compiled {compiled})")
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in libraries}
    spills = [ln for ln in ptxas["lstm_forward"] if "spill" in ln]
    require(spills and all("0 bytes spill stores, 0 bytes spill loads" in ln for ln in spills),
            f"an lstm_forward kernel spills: {spills}")
    gates_ptxas = ptxas_report(_build.build_log("lstm_train"), "lstm_gates_")
    require(sum(k != "warnings" for k in gates_ptxas) == 4 and spill_free(gates_ptxas),
            f"a gate kernel spills or is missing: {gates_ptxas}")
    staged_ptxas = ptxas_report(_build.build_log("gossip_mix"), "gossip_mix_staged_kernel")
    require(sum(k != "warnings" for k in staged_ptxas) == 3 and spill_free(staged_ptxas),
            f"a staged gossip kernel spills or is missing: {staged_ptxas}")
    emit("build", seconds=seconds, compiled=compiled, ptxas=ptxas)

    # 3. kernel vs plain -------------------------------------------------
    gen = torch.Generator().manual_seed(1234)
    errs = []
    for case in CASES:
        inputs = random_inputs(gen, *case)
        y = lstm_cell.lstm_forward(*inputs)
        ref = lstm_forward_plain(*inputs)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        require(y.shape == ref.shape == case[:2] and bool(torch.isfinite(y).all()),
                f"shape or finiteness at {case}")
        require(err <= TOL, f"kernel vs plain at {case}: {err}")
        errs.append(err)
        bitwise = None
        if case[0] == 64:
            row5 = lstm_cell.lstm_forward(*(t[5:6] for t in inputs))
            bitwise = bool(torch.equal(row5[0], y[5]))
            require(bitwise, f"row 5 at G=64 differs from its G=1 launch: {case}")
        group = None
        if case == SWEEP_EVAL:
            g = SWEEP_EVAL_GROUP
            one = lstm_cell.lstm_forward(*(t[g:g + 1] for t in inputs))
            require(torch.equal(one[0], y[g]), f"group {g} of the {case} launch differs from "
                                               f"its G=1 launch")
            group = g
        tiles = None
        if case == (1, 2034, 12, 1, 128):
            for r in TILE_ROWS:
                one = lstm_cell.lstm_forward(inputs[0][:, r:r + 1].contiguous(), *inputs[1:])
                require(torch.equal(one[0, 0], y[0, r]),
                        f"row {r} of the {case} launch differs from its R=1 launch")
            tiles = list(TILE_ROWS)
        emit("kernel", case=dict(zip("GRLIH", case)), plan=lstm_cell._plan(*case)._asdict(),
             max_abs_err=err, row5_bitwise_vs_g1=bitwise, rows_bitwise_vs_r1=tiles,
             group_bitwise_vs_g1=group)

    # 4. full-width serve (the main path) --------------------------------
    fed = load_federated_dataset("replace-bg", fast=True)
    lstm = LSTMModel(hidden=128)
    sv = GlucoseServable(lstm.as_model(), lstm.init(torch.Generator().manual_seed(0)),
                         buckets=(1, 4, 16, 64))

    class CountingBatcher(MicroBatcher):
        def complete(self, batch):
            batches.append(len(batch))
            super().complete(batch)

    batches: list[int] = []
    batcher = CountingBatcher(sv.buckets)
    reqs = build_request_stream(fed, sv, 4096, seed=0)
    reset_launches()
    t0 = time.perf_counter()
    sv.warmup(history_len=fed.x.shape[-1])
    preds = replay(sv, batcher, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_serve = lstm_cell.LAUNCHES
    require(launches_serve >= len(batches) > 0,
            f"{launches_serve} launches for {len(batches)} batches")
    require(sorted(preds) == list(range(len(reqs))), "a request went unanswered")
    served = torch.tensor([preds[r.rid] for r in reqs])
    require(bool(torch.isfinite(served).all()), "non-finite forecast")
    bad = selfcheck(sv, reqs, preds)
    require(bad == 0, f"{bad} served forecasts differ from the direct apply")
    plain_err = served_vs_plain(sv, reqs, preds)
    require(plain_err <= TOL, f"served vs plain twin: {plain_err}")
    errs.append(plain_err)
    stats = batcher.stats()
    emit("serve", dataset=fed.name, patients=fed.num_nodes, hidden=128,
         requests=len(reqs), batches=len(batches), full_batches=batches.count(64),
         launches=launches_serve, selfcheck_bitwise=len(reqs) - bad,
         max_abs_err_vs_plain=plain_err, wall_s=wall,
         p50_latency_ms=stats["p50_latency_ms"], p99_latency_ms=stats["p99_latency_ms"],
         forecasts_per_sec=stats["forecasts_per_sec"])

    # 5. narrow serve through the CLI ------------------------------------
    before = lstm_cell.LAUNCHES
    rc = serve_main(["--checkpoint", str(CKPT), "--requests", "256", "--selfcheck",
                     "--device", "cuda"])
    require(rc == 0, f"launch.serve --selfcheck exited {rc}")
    emit("narrow", checkpoint=str(CKPT.relative_to(ROOT)), requests=256,
         launches=lstm_cell.LAUNCHES - before, selfcheck="bitwise")

    # 6. timings at one serving batch: G=64, H=128, L=12 -----------------
    batch = reqs[:64]
    params = sv.params_rows([r.patient for r in batch])
    x = torch.tensor(np.stack([r.window for r in batch]), device="cuda")[:, None, :, None].contiguous()
    inputs = (x, params["wx"], params["wh"], params["b"], params["w_out"], params["b_out"])
    pop = sv.population
    flush = torch.zeros(64 * 2**20 // 4, device="cuda")  # 64 MB > the 50 MB L2
    shapes = {}
    for shape in LSTM_TIMED:
        if shape == LSTM_TIMED[0]:  # the batch's rows all hold the population
            args, weights, xs = inputs, [pop[k] for k in ("wx", "wh", "b", "w_out", "b_out")], x[:, 0]
        else:
            args = random_inputs(gen, *shape)
            weights, xs = [t[0] for t in args[1:]], args[0][0]
        library = cudnn_lstm(*weights)
        library_err = float((library(xs) - lstm_cell.lstm_forward(*args).reshape(-1)).abs().max())
        nbytes, ops = lstm_forward_cost(*args)
        bound_ms, bound_by = bound(nbytes, ops)
        ms = time_ms(lambda: lstm_cell.lstm_forward(*args), 200)
        shapes[shape] = dict(
            ms=ms, ms_l2_flushed=time_ms(lambda: lstm_cell.lstm_forward(*args), 200, flush),
            bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms,
            plain_ms=time_ms(lambda: lstm_forward_plain(*args), 50 if shape == LSTM_TIMED[0] else 20),
            library_ms=time_ms(lambda: library(xs), 200),
            library="torch.nn.LSTM (cuDNN) + nn.Linear", library_max_abs_err=library_err,
            bytes=nbytes, ops=ops, plan=lstm_cell._plan(*shape)._asdict())
        emit("timing", shape=dict(zip("GRLIH", shape)), **shapes[shape])
    serving, evaluation, split = (shapes[shape] for shape in LSTM_TIMED)
    lstm_row = dict(ms=serving["ms"], plain_ms=serving["plain_ms"], bound_ms=serving["bound_ms"],
                    bound_by=serving["bound_by"], library_ms=serving["library_ms"],
                    bound_share=serving["bound_share"], eval_ms=evaluation["ms"],
                    eval_bound_ms=evaluation["bound_ms"],
                    eval_bound_share=evaluation["bound_share"],
                    eval_library_ms=evaluation["library_ms"], test_split_ms=split["ms"],
                    test_split_bound_ms=split["bound_ms"], test_split_library_ms=split["library_ms"])

    # 7. where a served batch's time goes --------------------------------
    window = reqs[:1024]
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        replay(sv, MicroBatcher(sv.buckets), window)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        replay(sv, MicroBatcher(sv.buckets), window)
        torch.cuda.synchronize()
    device = {}  # device-side kernels and copies: no host time of their own
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if e.self_cpu_time_total == 0 and us > 0:
            device[e.key] = (e.count, us)
    kernel = [v for k, v in device.items() if "lstm_forward_cluster_kernel" in k]
    require(kernel, "the profiler saw no lstm_forward kernel in the serving loop")
    busy_ms = sum(us for _, us in device.values()) / 1e3
    wall_ms = statistics.median(walls) * 1e3
    top = sorted(device.items(), key=lambda kv: -kv[1][1])[:6]
    emit("profile", requests=len(window), wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms,
         lstm_forward_us_per_launch=kernel[0][1] / kernel[0][0], launches=kernel[0][0],
         top_device=[{"name": k[:80], "count": n, "us": us} for k, (n, us) in top])

    # 8. gossip kernels vs plain -----------------------------------------
    from repro_torch.config import FLConfig
    from repro_torch.core import GluADFL
    from repro_torch.launch.train import run as train_run
    from repro_torch.launch.train import val_windows
    from repro_torch.optim import get_optimizer
    from repro_torch.serve import load_population

    from repro_torch.kernels import gossip_mix as gk

    gen = torch.Generator(device="cuda").manual_seed(4321)
    gossip_err: dict[str, float] = {}
    n_cases = 0
    designs: dict[str, list[str]] = {}  # each staged kernel's plan at each case

    def gossip_case(n, d, active_share, only=None) -> None:
        """Each kernel (or only the one named) at one case: within
        GOSSIP_TOL of its twin, two launches and inactive rows bitwise,
        a staged kernel bitwise its row-wise parent."""
        nonlocal n_cases
        w, z, act, mix, idx, wgt = gossip_inputs(gen, n, d, 1.0 - active_share)
        inactive = act == 0
        parents = rowwise_calls(w, z, act, mix, idx, wgt)
        for name, kernel, plain, args in gossip_calls(w, z, act, mix, idx, wgt):
            if only not in (None, name):
                continue
            out, again, want = kernel(*args), kernel(*args), plain(*args)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            where = f"{name} at N={n} D={d} active={active_share}"
            require(out.shape == w.shape, f"shape of {where}")
            require(err <= GOSSIP_TOL, f"{where} vs plain: {err}")
            require(torch.equal(out, again), f"{where}: two launches differ")
            require(torch.equal(out[inactive], w[inactive]), f"{where}: inactive rows")
            if name in parents:
                rowwise, parent_args = parents[name]
                parent = rowwise(*parent_args)
                require(torch.equal(out.view(torch.int32), parent.view(torch.int32)),
                        f"{where}: not bitwise the row-wise kernel")
                plan = gk._plan(name, n, idx.shape[1] if "sparse" in name else 0, d)
                designs.setdefault(name, []).append(f"{plan.design}/{plan.tile}")
            gossip_err[name] = max(gossip_err.get(name, 0.0), err)
        n_cases += 1

    for n in GOSSIP_NODES:
        for d in GOSSIP_COLS:
            for active_share in GOSSIP_RATIOS:
                gossip_case(n, d, active_share)
    # each staged kernel at the largest N it stages and the next (row-wise)
    limits = {}
    for name in gk.STAGED:
        slots = COMM_BATCH + 1 if "sparse" in name else 0
        limits[name] = staged_limit(name, slots)
        for n, design in ((limits[name], "staged"), (limits[name] + 1, "rowwise")):
            require(gk._plan(name, n, slots, 513).design == design, f"{name} at N={n}: plan")
            gossip_case(n, 513, 0.7, only=name)
    w, z, act, mix, idx, wgt = gossip_inputs(gen, 37, 513, 0.3)
    inactive = act == 0
    require(bool(inactive.any()) and bool((~inactive).any()), "NaN case needs both kinds of rows")
    w[int(torch.nonzero(~inactive)[0]), 5] = float("nan")
    for name, kernel, _, args in gossip_calls(w, z, act, mix, idx, wgt):
        out = kernel(*args)
        require(torch.equal(out[inactive], w[inactive]), f"{name}: NaN reached an inactive row")
    emit("gossip", cases=n_cases, kernels=4, max_abs_err=gossip_err, tol=GOSSIP_TOL,
         inactive_bitwise=True, nan_inactive_bitwise=True, repeat_bitwise=True,
         staged_bitwise_rowwise=True, staged_plans=designs, staged_limits=limits)

    # 9. training at full width, sparse then dense (the main path) -------
    out_dir = ROOT / "build" / "chip_smoke"
    feds, trained = {}, {}
    for dataset, repr_, name in (("replace-bg", "sparse", "gossip_mix_sparse"),
                                 ("ohiot1dm", "dense", "gossip_mix")):
        argv = ["--dataset", dataset, "--mixer", "kernel", "--hidden", "128",
                "--inactive-ratio", "0.3", "--rounds", str(TRAIN_ROUNDS),
                "--eval-every", str(EVAL_EVERY), "--fast-data", "--out", str(out_dir)]
        log = io.StringIO()
        reset_launches()
        with contextlib.redirect_stdout(log):
            run = train_run(argv)
        counts = launches()
        text = log.getvalue()
        n_nodes = run.trainer.cfg.num_nodes
        evals = TRAIN_ROUNDS // EVAL_EVERY
        require(f"gossip-repr auto -> {repr_}" in text, f"{dataset}: gossip-repr auto did not pick {repr_}")
        require(counts[name] == TRAIN_ROUNDS, f"{dataset}: {counts[name]} {name} launches in {TRAIN_ROUNDS} rounds")
        require(all(v == 0 for k, v in counts.items()
                    if k not in (name, "lstm_forward", *GATE_KERNELS)),
                f"{dataset}: another gossip kernel ran: {counts}")
        hand_steps(counts, f"the {dataset} CLI", TRAIN_ROUNDS)
        require(counts["lstm_forward"] == evals + n_nodes,
                f"{dataset}: {counts['lstm_forward']} lstm_forward launches, want {evals} evals + {n_nodes} patients")
        losses = [h["loss"] for h in run.history]
        vals = [h["val_rmse"] for h in run.history if "val_rmse" in h]
        require(len(losses) == TRAIN_ROUNDS and np.isfinite(losses).all(), f"{dataset}: losses")
        require(len(vals) == evals and np.isfinite(vals).all(), f"{dataset}: val RMSE records")
        first, last = float(np.mean(losses[:16])), float(np.mean(losses[-16:]))
        require(last < first, f"{dataset}: loss did not fall ({first} -> {last})")
        require(bool(torch.isfinite(tree_to_vector(run.population)).all()), f"{dataset}: population")
        fed = feds[dataset] = load_federated_dataset(dataset, fast=True)
        # the path's population forwards against the plain twin: the last
        # eval record is the trained population's, and the test forecasts
        # are one G=1 launch per patient
        pop_rows = {k: v[None] for k, v in run.population.items()}

        def plain(x):
            xs = torch.as_tensor(x, dtype=torch.float32, device="cuda")[None, :, :, None]
            return lstm_forward_plain(xs, pop_rows["wx"], pop_rows["wh"], pop_rows["b"],
                                      pop_rows["w_out"], pop_rows["b_out"])[0]

        vx, vy = val_windows(fed)
        val_plain = float(torch.sqrt(torch.mean(torch.square(
            plain(vx) - torch.as_tensor(vy, device="cuda")))))
        val_err = abs(val_plain - vals[-1])
        require(val_err <= TOL, f"{dataset}: val RMSE {vals[-1]} vs plain twin {val_plain}")
        test_err = 0.0
        for p in fed.patients:
            with torch.no_grad():
                got = run.trainer.model.apply(
                    run.population, torch.as_tensor(p.test_x, dtype=torch.float32, device="cuda"))
            test_err = max(test_err, float((got - plain(p.test_x)).abs().max()))
        require(test_err <= TOL, f"{dataset}: test forecasts vs plain twin: {test_err}")
        errs += [val_err, test_err]
        model, pop = load_population(run.checkpoint)
        served = GlucoseServable(model, pop, buckets=(1, 4, 16, 64))
        reqs = build_request_stream(fed, served, 256, seed=1)
        preds = replay(served, MicroBatcher(served.buckets), reqs)
        bad = selfcheck(served, reqs, preds)
        require(bad == 0 and all(math.isfinite(v) for v in preds.values()),
                f"{dataset}: {bad} forecasts from the checkpoint differ from a direct apply")
        # steady state: one 32-round chunk from a fresh state
        trainer = run.trainer
        chunk_gen = torch.Generator(device="cuda").manual_seed(1)
        state = trainer.init(chunk_gen)
        trainer.train(chunk_gen, fed.x, fed.y, fed.counts, batch_size=64, rounds=2, state=state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(chunk_gen, fed.x, fed.y, fed.counts, batch_size=64, rounds=32, chunk=32,
                      state=state)
        torch.cuda.synchronize()
        chunk_s = time.perf_counter() - t0
        trained[dataset] = (run, counts)
        emit("train", dataset=dataset, nodes=n_nodes, hidden=128, gossip_repr=repr_,
             rounds=TRAIN_ROUNDS, launches=counts, loss_first16=first, loss_last16=last,
             val_rmse=vals, val_windows=len(vx), val_rmse_vs_plain_abs_err=val_err,
             test_forecasts_vs_plain_max_abs_err=test_err, rounds_per_s_whole_run=TRAIN_ROUNDS / run.seconds,
             rounds_per_s_32_round_chunk=32 / chunk_s, served_from_checkpoint=len(reqs),
             selfcheck="bitwise")

    # 10. the local-DP training path ---------------------------------------
    def trainer_for(dataset, repr_, mixer, sigma):
        return GluADFL(LSTMModel(hidden=128).as_model(), get_optimizer("adam", 1e-3),
                       FLConfig(num_nodes=feds[dataset].num_nodes, inactive_ratio=0.3),
                       mixer=mixer, gossip_repr=repr_, dp_noise_sigma=sigma)

    dp_counts = {}
    for dataset, repr_, name in (("replace-bg", "sparse", "gossip_mix_sparse_dp"),
                                 ("ohiot1dm", "dense", "gossip_mix_dp")):
        fed = feds[dataset]
        trainer = trainer_for(dataset, repr_, "kernel", 0.01)
        dp_gen = torch.Generator(device="cuda").manual_seed(2)
        reset_launches()
        _, hist, state = trainer.train(dp_gen, fed.x, fed.y, fed.counts, batch_size=64, rounds=8)
        torch.cuda.synchronize()
        counts = launches()
        require(counts[name] == 8 and others(counts) == 8,
                f"DP {dataset}: launches {counts}, want 8 of {name}")
        hand_steps(counts, f"DP {dataset}", 8)
        require(all(math.isfinite(h["loss"]) for h in hist) and bool(torch.isfinite(state.params).all()),
                f"DP {dataset}: non-finite training")
        dp_counts[name] = counts[name]
        emit("dp", dataset=dataset, gossip_repr=repr_, sigma=0.01, rounds=8, launches=counts,
             losses=[h["loss"] for h in hist])

    # 11. one state, one round's draws, two mixers -----------------------
    for dataset, repr_ in (("replace-bg", "sparse"), ("ohiot1dm", "dense")):
        fed = feds[dataset]
        for sigma in (0.0, 0.01):
            tk = trainer_for(dataset, repr_, "kernel", sigma)
            tt = trainer_for(dataset, repr_, "tree", sigma)
            mix_gen = torch.Generator(device="cuda").manual_seed(3)
            state = tk.init(mix_gen)
            data = tk.to_device(fed.x, fed.y, fed.counts)
            draws = tk.draw(mix_gen, data, 64)
            after_k, loss_k = tk.round(state, data, draws)
            after_t, loss_t = tt.round(state, data, draws)
            active, operand, _ = tk.mixing_operator(state, draws)
            noise = sigma * draws.dp_noise if sigma else None
            mixed_err = float((tk.plan.gossip(state.params, operand, active, noise)
                               - tt.plan.gossip(state.params, operand, active, noise)).abs().max())
            require(mixed_err <= GOSSIP_TOL, f"{dataset} sigma={sigma}: kernel vs tree mix {mixed_err}")
            inactive = active == 0
            require(torch.equal(after_k.params[inactive], state.params[inactive]),
                    f"{dataset} sigma={sigma}: inactive rows moved")
            emit("mixers", dataset=dataset, gossip_repr=repr_, sigma=sigma,
                 mixed_max_abs_diff=mixed_err,
                 params_after_round_max_abs_diff=float((after_k.params - after_t.params).abs().max()),
                 loss_kernel=float(loss_k), loss_tree=float(loss_t))

    # 12. gossip kernel timings at the main-path shapes -------------------
    timing_gen = torch.Generator(device="cuda").manual_seed(5)
    d_main = trained["replace-bg"][0].trainer.layout.dim
    main_inputs = {"sparse": gossip_inputs(timing_gen, 226, d_main, 0.3),
                   "dense": gossip_inputs(timing_gen, 12, d_main, 0.3)}
    gossip_rows = {}
    for name in ("gossip_mix", "gossip_mix_sparse", "gossip_mix_dp", "gossip_mix_sparse_dp"):
        w, z, act, mix, idx, wgt = main_inputs["sparse" if "sparse" in name else "dense"]
        _, kernel, plain, args = next(c for c in gossip_calls(w, z, act, mix, idx, wgt) if c[0] == name)
        library = gossip_library(name, w, z, act, mix, idx, wgt)
        library_err = float((library() - kernel(*args)).abs().max())
        nbytes, ops = gossip_cost(name, w, act, idx)
        row = dict(ms=time_ms(lambda: kernel(*args), 200),
                   plain_ms=time_ms(lambda: plain(*args), 20),
                   library_ms=time_ms(library, 100))
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        extra = dict(ms_l2_flushed=time_ms(lambda: kernel(*args), 100, flush))
        parents = rowwise_calls(w, z, act, mix, idx, wgt)
        if name in parents:  # in turns with the row-wise parent: parent, kernel, kernel, parent
            rowwise, parent_args = parents[name]
            turns, flushed = [], []
            for fn in (lambda: rowwise(*parent_args), lambda: kernel(*args),
                       lambda: kernel(*args), lambda: rowwise(*parent_args)):
                turns.append(time_ms(fn, 200))
                flushed.append(time_ms(fn, 100, flush))
            row["parent_ms"] = statistics.median([turns[0], turns[3]])
            row["parent_ms_l2_flushed"] = statistics.median([flushed[0], flushed[3]])
            extra["parent_device_us"] = device_us(lambda: rowwise(*parent_args))
            slots = idx.shape[1] if "sparse" in name else 0
            extra.update(turns_ms=turns, turns_ms_l2_flushed=flushed,
                         plan=gk._plan(name, w.shape[0], slots, w.shape[1])._asdict())
        extra["device_us"] = device_us(lambda: kernel(*args))
        if name == "gossip_mix_sparse_dp":  # the same bytes as one contiguous stream
            extra["contiguous_stream_ms"] = time_ms(lambda: torch.add(w, z), 100)
        if name == "gossip_mix_dp":
            extra["tiles"] = dp_tile_sweep(w, z, act, mix, kernel(*args))
        gossip_rows[name] = row
        emit("gtiming", kernel=name, nodes=w.shape[0], cols=w.shape[1], slots=idx.shape[1],
             active=int(act.sum()), library_max_abs_err=library_err, bytes=nbytes, ops=ops,
             **extra, **row)

    # 13. where a training round's time goes (sparse, N=226, H=128) ------
    run, _ = trained["replace-bg"]
    trainer, fed = run.trainer, feds["replace-bg"]
    prof_gen = torch.Generator(device="cuda").manual_seed(6)
    state = trainer.init(prof_gen)
    chunk_walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, state = trainer.train(prof_gen, fed.x, fed.y, fed.counts, batch_size=64,
                                    rounds=8, chunk=8, state=state)
        torch.cuda.synchronize()
        chunk_walls.append(time.perf_counter() - t0)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        trainer.train(prof_gen, fed.x, fed.y, fed.counts, batch_size=64, rounds=8, chunk=8,
                      state=state)
        torch.cuda.synchronize()
    by_span, gemm_by_span, busy_ms, device_items = span_breakdown(prof)
    # an estimate, not a count: the local step's matmul operations a
    # round, h @ wh and x @ wx for each of L steps over N nodes x B
    # windows, once forward and taken as twice that backward (the
    # elementwise work and the head are not counted)
    hsz, steps = 128, fed.x.shape[-1]
    local_ops = 3 * 2 * fed.num_nodes * 64 * steps * (hsz + 1) * 4 * hsz
    local_gemm_ms = gemm_by_span["round.local_step"]
    require(by_span["round.gossip"] > 0 and by_span["round.local_step"] > 0,
            f"the profile saw no gossip or local-step work: {by_span}")
    wall_ms = statistics.median(chunk_walls) * 1e3
    emit("tprofile", dataset="replace-bg", nodes=fed.num_nodes, hidden=128, rounds=8,
         wall_ms=wall_ms, rounds_per_s=8e3 / wall_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms, host_ms=wall_ms - busy_ms, device_ms_by_span=by_span,
         device_items_per_round=device_items / 8, gemm_device_ms_by_span=gemm_by_span,
         local_step_est_matmul_ops_per_round=local_ops,
         local_step_est_tflop_per_s_over_span=local_ops * 8 / (by_span["round.local_step"] * 1e-3) / 1e12,
         local_step_est_tflop_per_s_over_gemm=(local_ops * 8 / (local_gemm_ms * 1e-3) / 1e12
                                               if local_gemm_ms else None))

    # 14. swa_attention against its twin ----------------------------------
    import dataclasses

    from repro_torch.arch import build_arch
    from repro_torch.config import get_arch_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as swa_kernel
    from repro_torch.nn import attention as attn

    swa_log = _build.build_log("swa_attention")
    swa_ptxas = ptxas_report(swa_log, "wgmma")
    # the bf16 builds: hd 64, 128 and 256, and the band's two passes
    # above; none spills, and ptxas serializes the products of none
    require(sum(k != "warnings" for k in swa_ptxas) == 5 and spill_free(swa_ptxas)
            and "warnings" not in swa_ptxas,
            f"a wgmma swa_attention kernel spills, is serialized or is missing: {swa_ptxas}")
    # the band builds' four kernels (two passes in each dtype)
    band_ptxas = ptxas_report(swa_log, "swa_band")
    require(sum(k != "warnings" for k in band_ptxas) == 4 and spill_free(band_ptxas)
            and "warnings" not in band_ptxas,
            f"a band swa_attention kernel spills, is serialized or is missing: {band_ptxas}")
    # the fp32 one-block builds at hd 64, 128 and 256 (TMA-staged); and
    # the chunked scalar builds, bf16 and fp32 at hd 256 (the code the band
    # builds replaced, kept for comparison)
    bulk_ptxas = ptxas_report(swa_log, "kernel_bulk")
    require(sum(k != "warnings" for k in bulk_ptxas) == 3 and spill_free(bulk_ptxas),
            f"an fp32 one-block swa_attention kernel spills or is missing: {bulk_ptxas}")
    scalar_ptxas = ptxas_report(swa_log, "swa_attention_kernelI")
    require(sum(k != "warnings" for k in scalar_ptxas) == 2 and spill_free(scalar_ptxas),
            f"a chunked scalar swa_attention kernel spills or is missing: {scalar_ptxas}")
    for name, lines in {**swa_ptxas, **bulk_ptxas, **scalar_ptxas, **band_ptxas}.items():
        print(f"ptxas {name}: " + " | ".join(lines), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(77)
    swa_err = {str(dtype): 0.0 for dtype in SWA_TOL}
    bf16_over_bound = 0.0  # the sweep's largest |bf16 - fp32 twin| / swa_bf16_bound
    n_swa = 0

    def swa_case(b, s, h, kh, hd, window, dtype):
        """One case against the twin: within SWA_TOL, two launches bitwise
        equal, bf16 elementwise within swa_bf16_bound."""
        nonlocal bf16_over_bound, n_swa
        q, k, v = swa_inputs(gen, b, s, h, kh, hd, dtype)
        out = swa_kernel.swa_attention(q, k, v, window=window)
        again = swa_kernel.swa_attention(q, k, v, window=window)
        want = ref.swa_attention_plain(q, k, v, window=window)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        where = f"swa_attention B={b} S={s} H={h} K={kh} hd={hd} w={window} {dtype}"
        require(out.shape == q.shape and out.dtype == dtype, f"shape of {where}")
        require(err <= SWA_TOL[dtype], f"{where} vs plain: {err}")
        require(torch.equal(out, again), f"{where}: two launches differ")
        if dtype == torch.bfloat16:
            o32 = ref.swa_attention_plain(q.float(), k.float(), v.float(), window=window)
            ratio = float(((out.float() - o32).abs()
                           / ref.swa_bf16_bound(q, k, v, window=window)).max())
            require(ratio <= 1.0, f"{where} vs swa_bf16_bound: {ratio}")
            bf16_over_bound = max(bf16_over_bound, ratio)
        swa_err[str(dtype)] = max(swa_err[str(dtype)], err)
        n_swa += 1

    for s in SWA_SEQS:
        for window in SWA_WINDOWS:
            for hd in (64, 128):
                for h, kh in ((4, 4), (12, 1)):
                    for b in (1, 2):
                        for dtype in SWA_TOL:
                            swa_case(b, s, h, kh, hd, window, dtype)
    n_narrow = n_swa
    for s in SWA_WIDE["seqs"]:
        for window in SWA_WIDE["windows"]:
            for hd in SWA_WIDE["hds"]:
                for h, kh in ((4, 4), (12, 1)):
                    for dtype in SWA_TOL:
                        swa_case(1, s, h, kh, hd, window, dtype)
    # RecurrentGemma-9B's local attention at full width, at its hd 256 and
    # at wider ones on the band builds (288 padded to 512; 512, 768,
    # 2,048, 2,304 and 4,096), against the fp32 banded path: the fp32
    # kernel within the fp32 bound, bf16 elementwise within swa_bf16_bound
    # (given the banded path), each launch's build by name; timed at
    # HYBRID_TIMED, each build above hd 256 required faster than the
    # banded path and no slower than SDPA, the band builds at HYBRID_BAND
    # beside the chunked build they replaced and split by pass
    rg_cfg = get_arch_config(HYBRID_ARCH)
    rg_window = rg_cfg.local_attn_window
    rg_shape = dict(B=1, S=HYBRID_SEQ, H=rg_cfg.num_heads, K=rg_cfg.num_kv_heads,
                    hd=rg_cfg.head_dim, window=rg_window)
    hybrid = {}
    for hd, (fp32_want, bf16_want) in HYBRID_BUILDS.items():
        q, k, v = swa_inputs(gen, 1, HYBRID_SEQ, rg_cfg.num_heads, rg_cfg.num_kv_heads, hd,
                             torch.float32)
        banded = attn.banded_flash_attention(q, k, v, window=rg_window)
        builds_before = dict(swa_kernel.BUILD_LAUNCHES)
        rg_out = swa_kernel.swa_attention(q, k, v, window=rg_window)
        rg_err = {"fp32_max_abs_err": float((rg_out - banded).abs().max()),
                  "fp32_build": launched_build(builds_before)}
        del rg_out
        if hd == 256:  # the one-block code it replaced, held as the build is
            rg_err["fp32_replaced_max_abs_err"] = float(
                (swa_chunked(q, k, v, rg_window) - banded).abs().max())
            require(rg_err["fp32_replaced_max_abs_err"] <= SWA_TOL[torch.float32],
                    f"the replaced fp32 code at {HYBRID_ARCH}'s shape vs the banded path: {rg_err}")
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        builds_before = dict(swa_kernel.BUILD_LAUNCHES)
        rg_out = swa_kernel.swa_attention(qb, kb, vb, window=rg_window)
        rg_err["bf16_build"] = launched_build(builds_before)
        require(rg_err["fp32_build"] == fp32_want and rg_err["bf16_build"] == bf16_want,
                f"swa_attention at hd {hd} ran the builds {rg_err}, want {fp32_want}, {bf16_want}")
        del banded
        banded = attn.banded_flash_attention(qb.float(), kb.float(), vb.float(), window=rg_window)
        limit = ref.swa_bf16_bound(qb, kb, vb, window=rg_window,
                                   attention=attn.banded_flash_attention)
        rg_err["bf16_max_abs_err"] = float((rg_out.float() - banded).abs().max())
        rg_err["bf16_max_err_over_bound"] = float(((rg_out.float() - banded).abs() / limit).max())
        del rg_out, banded, limit
        require(rg_err["fp32_max_abs_err"] <= SWA_TOL[torch.float32],
                f"swa_attention (fp32) at {HYBRID_ARCH}'s shape, hd {hd}, vs the banded path: "
                f"{rg_err}")
        require(rg_err["bf16_max_err_over_bound"] <= 1.0,
                f"swa_attention (bf16) at {HYBRID_ARCH}'s shape, hd {hd}, vs the banded path: "
                f"{rg_err}")
        if hd in HYBRID_TIMED:
            runs = 20 if hd <= 512 else 10
            rg_err["fp32"] = swa_timing(q, k, v, rg_window, FP32_OPS_PER_S, runs)
            if hd == 256:  # beside the one-block code it replaced, in the same run
                rg_err["fp32"]["replaced_ms"] = time_ms(
                    lambda: swa_chunked(q, k, v, rg_window), 20)
            rg_err["bf16"] = swa_timing(qb, kb, vb, rg_window, BF16_OPS_PER_S, runs)
            if hd <= 512:
                rg_err["bf16"]["ms_l2_flushed"] = time_ms(
                    lambda: swa_kernel.swa_attention(qb, kb, vb, window=rg_window), 20, flush)
            if hd > 256:  # the band builds: no slower than SDPA, faster than the plain path
                for dt in ("fp32", "bf16"):
                    require(rg_err[dt]["ms"] <= rg_err[dt]["library_ms"]
                            and rg_err[dt]["ms"] < rg_err[dt]["plain_ms"],
                            f"swa_attention ({dt}) at hd {hd} is slower than the library call "
                            f"or the plain path: {rg_err[dt]}")
        if hd in HYBRID_BAND:  # beside the chunked build they replaced, and by pass
            for dt, x in (("fp32", (q, k, v)), ("bf16", (qb, kb, vb))):
                # the scores alone, and both passes, in turns: P V is the difference
                both, scores = [], []
                for _ in range(2):
                    both.append(time_ms(lambda x=x: swa_band(*x, rg_window), 5))
                    scores.append(time_ms(lambda x=x: swa_band(*x, rg_window, passes=1), 5))
                rg_err[dt]["ms_by_pass"] = {
                    "scores": statistics.median(scores),
                    "pv": statistics.median(both) - statistics.median(scores)}
                rg_err[dt]["replaced_ms"] = time_ms(lambda x=x: swa_chunked(*x, rg_window),
                                                    SWA_CHUNKED_RUNS, warmup=1)
                require(rg_err[dt]["ms"] < rg_err[dt]["replaced_ms"],
                        f"the band build ({dt}) at hd {hd} is slower than the chunked build: "
                        f"{rg_err[dt]}")
        hybrid[str(hd)] = rg_err
        print(json.dumps({"hybrid_hd": hd, **rg_err}), flush=True)
        del q, k, v, qb, kb, vb
    lm_cfg = get_arch_config(LM_ARCH)
    heads, kv_heads, head_dim, window = (lm_cfg.num_heads, lm_cfg.num_kv_heads, lm_cfg.head_dim,
                                         lm_cfg.sliding_window)
    seq = 32_768  # SHAPES["prefill_32k"]
    q, k, v = swa_inputs(gen, 1, seq, heads, kv_heads, head_dim, torch.bfloat16)
    out = swa_kernel.swa_attention(q, k, v, window=window)
    again = swa_kernel.swa_attention(q, k, v, window=window)
    require(bool(torch.isfinite(out).all()), "swa_attention at the prefill's shape: non-finite")
    require(torch.equal(out, again), "swa_attention at the prefill's shape: two launches differ")
    # the plain banded path in fp32 on the same inputs: the kernel's fp32
    # build within the fp32 bound, its bf16 build elementwise within
    # swa_bf16_bound (the rounding of P and of the output); then the banded
    # path as JAX runs it in bf16 (scores and probabilities rounded to
    # bf16), at JAX's bf16 bound
    q32, k32, v32 = q.float(), k.float(), v.float()
    banded = attn.banded_flash_attention(q32, k32, v32, window=window)
    builds_before = dict(swa_kernel.BUILD_LAUNCHES)
    out32 = swa_kernel.swa_attention(q32, k32, v32, window=window)
    fp32_build = launched_build(builds_before)
    require(fp32_build == "scalar-fp32-hd128", f"fp32 at the prefill's shape ran {fp32_build}")
    fp32_err = float((out32 - banded).abs().max())
    del out32
    # the fp32 build at the same shape, timed beside the plain path and
    # SDPA in fp32
    fp32_timing = {"build": fp32_build, **swa_timing(q32, k32, v32, window, FP32_OPS_PER_S)}
    del q32, k32, v32
    # hd 64 at that shape (synthetic: every reduced config runs hd 64 in
    # fp32, none at this size), its build checked by name
    q64, k64, v64 = swa_inputs(gen, 1, seq, heads, kv_heads, 64, torch.float32)
    builds_before = dict(swa_kernel.BUILD_LAUNCHES)
    swa_kernel.swa_attention(q64, k64, v64, window=window)
    fp32_hd64_timing = {"build": launched_build(builds_before),
                        **swa_timing(q64, k64, v64, window, FP32_OPS_PER_S)}
    require(fp32_hd64_timing["build"] == "scalar-fp32-hd64",
            f"fp32 at hd 64 ran {fp32_hd64_timing['build']}")
    del q64, k64, v64
    diff = (out.float() - banded).abs()
    path_err = {"fp32_max_abs_err": fp32_err, "bf16_max_abs_err": float(diff.max()),
                "ref_mean_abs": float(banded.abs().mean())}
    del banded
    limit = ref.swa_bf16_bound(q, k, v, window=window, attention=attn.banded_flash_attention)
    path_err["bf16_max_err_over_bound"] = float((diff / limit).max())
    del diff, limit
    require(fp32_err <= SWA_TOL[torch.float32],
            f"swa_attention (fp32) at the prefill's shape vs the fp32 banded path: {fp32_err}")
    require(path_err["bf16_max_err_over_bound"] <= 1.0,
            f"swa_attention (bf16) at the prefill's shape vs the fp32 banded path: {path_err}")
    banded = attn.banded_flash_attention(q, k, v, window=window)
    path_err["bf16_vs_bf16_banded_max_abs_err"] = float((out.float() - banded.float()).abs().max())
    del banded, out, again
    require(path_err["bf16_vs_bf16_banded_max_abs_err"] <= SWA_TOL[torch.bfloat16],
            f"swa_attention at the prefill's shape vs the bf16 banded path: {path_err}")
    emit("swa", ptxas=swa_ptxas, ptxas_fp32=bulk_ptxas, ptxas_scalar=scalar_ptxas,
         ptxas_band=band_ptxas, cases=n_swa,
         path_fp32=fp32_timing,
         path_fp32_hd64_synthetic=fp32_hd64_timing,
         cases_wide_hd=n_swa - n_narrow, wide_hds=SWA_WIDE["hds"], max_abs_err=swa_err,
         tol={str(d): t for d, t in SWA_TOL.items()}, sweep_bf16_max_err_over_bound=bf16_over_bound,
         repeat_bitwise=True, path_shape=dict(B=1, S=seq, H=heads, K=kv_heads, hd=head_dim,
                                               window=window),
         path_vs_fp32_banded=path_err, hybrid_arch=HYBRID_ARCH, hybrid_shape=rg_shape,
         hybrid_vs_fp32_banded=hybrid,
         bf16_bound="swa_bf16_bound: 2^-8 (|o32| + (P|v|)/l) + 3e-5")

    # 15. the LM prefill and decode at full width (the main path) ----------
    cfg = dataclasses.replace(lm_cfg, num_layers=LM_LAYERS)
    arch = build_arch(cfg)
    t0 = time.perf_counter()
    params = arch.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for v in params.values()
                   for t in (v.values() if isinstance(v, dict) else [v]))
    spec = arch.input_specs("prefill_32k", override_batch=1)["tokens"]
    tokens = torch.randint(0, cfg.vocab_size, tuple(spec.shape), dtype=spec.dtype, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    prompt = {"tokens": tokens}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    branches_before = dict(attn.BRANCHES)
    t0 = time.perf_counter()
    logits, caches = arch.prefill_fn(params, prompt)
    torch.cuda.synchronize()
    prefill_first_s = time.perf_counter() - t0
    lm_counts, lm_builds = launches(), dict(swa_kernel.BUILD_LAUNCHES)
    taken = {name: attn.BRANCHES[name] - branches_before[name] for name in attn.BRANCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(lm_counts["swa_attention"] == LM_LAYERS,
            f"{lm_counts['swa_attention']} swa_attention launches in a {LM_LAYERS}-layer prefill")
    require(sum(lm_counts.values()) == LM_LAYERS, f"another kernel ran in the prefill: {lm_counts}")
    require(taken == {"plain": 0, "flash": 0, "banded": LM_LAYERS, "banded_grad": 0},
            f"attention branches {taken}")
    vocab_padded = params["lm_head"].shape[1]
    require(tuple(logits.shape) == (1, 1, vocab_padded) and bool(torch.isfinite(logits).all()),
            f"prefill logits {tuple(logits.shape)} or non-finite")
    cache_shape = (LM_LAYERS, 1, window, kv_heads, head_dim)
    require(tuple(caches.k.shape) == cache_shape and tuple(caches.v.shape) == cache_shape,
            f"caches {tuple(caches.k.shape)}, want {cache_shape}")
    require(bool((caches.pos == seq).all()), f"cache positions {caches.pos.tolist()}")
    decoded = []
    state = caches
    step_logits = logits
    for t in range(LM_DECODE_STEPS):
        tok = torch.argmax(step_logits[:, -1, :cfg.vocab_size], dim=-1)[:, None].to(torch.int32)
        decoded.append(int(tok))
        step_logits, state = arch.decode_fn(params, state, {"token": tok, "pos": seq + t})
        require(bool(torch.isfinite(step_logits).all()), f"decode step {t}: non-finite logits")
    torch.cuda.synchronize()
    require(launches()["swa_attention"] == LM_LAYERS, "decode launched swa_attention")

    # the slice held as a whole: card (kernel) against CPU (twin), fp32
    small = dataclasses.replace(lm_cfg.reduced(), sliding_window=1024)
    small_arch = build_arch(small)
    cpu_params = small_arch.init_params(torch.Generator().manual_seed(2))
    gpu_params = {key: ({n: t.cuda() for n, t in val.items()} if isinstance(val, dict) else val.cuda())
                  for key, val in cpu_params.items()}
    small_tokens = torch.randint(0, small.vocab_size, (1, 3072), dtype=torch.int32,
                                 generator=torch.Generator().manual_seed(3))
    before, builds_before = swa_kernel.LAUNCHES, dict(swa_kernel.BUILD_LAUNCHES)
    steps_err, on_card, on_cpu = card_vs_cpu(  # both sides fed the card's greedy tokens
        lambda feed=None: logits_run(small_arch, gpu_params, small_tokens.cuda(), 4,
                                     small.vocab_size, feed=feed),
        lambda feed=None: logits_run(small_arch, cpu_params, small_tokens, 4, small.vocab_size,
                                     feed=feed),
        LM_SLICE_TOL["logits"], "reduced slice")
    require(swa_kernel.LAUNCHES - before == small.num_layers, "the reduced prefill missed the kernel")
    slice_builds = {name: n - builds_before.get(name, 0)
                    for name, n in swa_kernel.BUILD_LAUNCHES.items()
                    if n != builds_before.get(name, 0)}
    require(slice_builds == {"scalar-fp32-hd64": small.num_layers},
            f"the reduced slice ran the builds {slice_builds}")
    slice_err = {"logits": max(steps_err),
                 "caches": max(float((getattr(on_card[at], kv).cpu()
                                      - getattr(on_cpu[at], kv)).abs().max())
                               for at in ("prefilled", "last") for kv in ("k", "v"))}
    require(slice_err["caches"] <= LM_SLICE_TOL["caches"],
            f"reduced slice, card vs CPU caches: {slice_err['caches']}")
    del on_card, on_cpu
    demo = subprocess.run([sys.executable, "-m", "repro_torch.launch.arch_demo", "--arch", LM_ARCH,
                           "--tokens", "8"], capture_output=True, text=True, cwd=ROOT, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    require(demo.returncode == 0, f"arch_demo exited {demo.returncode}: {demo.stderr[-2000:]}")
    emit("lmprefill", arch=LM_ARCH, d_model=cfg.d_model, heads=heads, kv_heads=kv_heads,
         d_ff=cfg.d_ff, vocab=cfg.vocab_size, window=window, layers=LM_LAYERS, params=n_params,
         dtype=cfg.dtype, reduced={"num_layers": f"88->{LM_LAYERS}", "batch": "32->1"},
         prompt=seq, launches=lm_counts, branches=taken, logits_shape=list(logits.shape),
         cache_shape=list(cache_shape), init_s=init_s, first_prefill_s=prefill_first_s,
         peak_memory_gb=peak_gb, decode_steps=LM_DECODE_STEPS, decoded_tokens=decoded,
         slice_card_vs_cpu=slice_err, slice_card_vs_cpu_logits_steps=steps_err,
         slice_tol=LM_SLICE_TOL, slice_builds=slice_builds,
         arch_demo=demo.stdout.strip().splitlines()[-2:])

    # 16. the kernel and the prefill timed at the path's shape --------------
    swa_call = lambda: swa_kernel.swa_attention(q, k, v, window=window)  # noqa: E731
    library = band_sdpa(q, k, v, window)
    library_err = float((library().transpose(1, 2).float() - swa_call().float()).abs().max())
    swa_ms = time_ms(swa_call, 20)
    swa_plain_ms = time_ms(lambda: attn.banded_flash_attention(q, k, v, window=window), 5, warmup=1)
    swa_library_ms = time_ms(library, 10, warmup=2)
    nbytes, ops = swa_cost(q, k, window)
    swa_bound_ms, swa_bound_by = bound(nbytes, ops, BF16_OPS_PER_S)
    swa_row = dict(ms=swa_ms, plain_ms=swa_plain_ms, bound_ms=swa_bound_ms, bound_by=swa_bound_by,
                   library_ms=swa_library_ms, tflop_per_s=ops / (swa_ms * 1e-3) / 1e12,
                   bound_share=swa_bound_ms / swa_ms)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arch.prefill_fn(params, prompt)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        arch.prefill_fn(params, prompt)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    split = {"swa_attention": 0.0, "gemm": 0.0, "other": 0.0}
    top: dict[str, float] = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if e.self_cpu_time_total != 0 or us <= 0:
            continue
        name = e.key.lower()
        kind = ("swa_attention" if "swa_attention_kernel" in name
                else "gemm" if any(g in name for g in GEMM_NAMES) else "other")
        split[kind] += us / 1e3
        top[e.key[:80]] = us / 1e3
    require(split["swa_attention"] > 0, f"the profiler saw no swa_attention kernel: {split}")
    decode_walls = []
    state = caches
    tok = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    for t in range(LM_DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state = arch.decode_fn(params, state, {"token": tok, "pos": seq + t})
        torch.cuda.synchronize()
        decode_walls.append(time.perf_counter() - t0)
    prefill_s = statistics.median(walls)
    busy_ms = sum(split.values())
    emit("lmtiming", kernel="swa_attention", shape=dict(B=1, S=seq, H=heads, K=kv_heads, hd=head_dim,
                                                         window=window, dtype="bfloat16"),
         bytes=nbytes, ops=ops, bound_bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
         bound_bf16_ops_ms=ops / BF16_OPS_PER_S * 1e3, bound_fp32_ops_ms=ops / FP32_OPS_PER_S * 1e3,
         library="scaled_dot_product_attention, band mask, per 1024-row query block, KV repeated",
         library_max_abs_err=library_err, **swa_row,
         prefill_wall_s=prefill_s, prefill_walls_s=walls, prefill_tokens_per_s=seq / prefill_s,
         prefill_device_ms=split, profiled_prefill_wall_s=profiled_s,
         prefill_device_busy_share=busy_ms / (profiled_s * 1e3),
         prefill_top_device_ms=dict(sorted(top.items(), key=lambda kv: -kv[1])[:8]),
         decode_step_ms_median=statistics.median(decode_walls) * 1e3,
         decode_steps_per_s=1 / statistics.median(decode_walls), nvidia_smi=card)

    # 17. cold-start personalization, then serving (the main path) ---------
    from repro_torch.core import personalize, personalize_loop
    from repro_torch.launch.serve import personalize_cohort
    from repro_torch.utils.rng import draw_personalize

    fed = feds["replace-bg"]
    lstm = LSTMModel(hidden=128)
    sv = GlucoseServable(lstm.as_model(), lstm.init(torch.Generator().manual_seed(0)),
                         buckets=(1, 4, 16, 64))
    steps, m = sv.personalize_steps, PERSONALIZE_WINDOWS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cohort = personalize_cohort(sv, fed, PERSONALIZE_COHORT, m, seed=0)  # ends in a sync
    tune_s = time.perf_counter() - t0
    # the same call again on a fresh store, profiled: where a step's time goes
    again = GlucoseServable(sv.model, sv.population, buckets=sv.buckets)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            personalize_cohort(again, fed, PERSONALIZE_COHORT, m, seed=0)
        tune_profiled_s = time.perf_counter() - t0
    require(torch.equal(again.personalize_losses, sv.personalize_losses),
            "two fine-tunes of one cohort from one seed differ")
    tune_busy, tune_gemm, tune_items = 0.0, 0.0, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if e.self_cpu_time_total == 0 and us > 0:
            tune_busy += us / 1e3
            tune_items += e.count
            if any(g in e.key.lower() for g in GEMM_NAMES):
                tune_gemm += us / 1e3
    losses = sv.personalize_losses.cpu()
    require(tuple(losses.shape) == (PERSONALIZE_COHORT, steps) and bool(torch.isfinite(losses).all()),
            f"fine-tune losses {tuple(losses.shape)} or non-finite")
    first10, last10 = losses[:, :10].mean(dim=1), losses[:, -10:].mean(dim=1)
    require(bool((last10 < first10).all()),
            f"a patient's loss did not fall: {(last10 >= first10).nonzero()[:, 0].tolist()}")
    require(sv.num_rows == 1 + PERSONALIZE_COHORT and
            [sv.row_of(pi) for pi in cohort] == list(range(1, 1 + PERSONALIZE_COHORT)),
            "the cohort's store rows")
    # the engines, for the cohort's first patient: the draws the servable's
    # call made (the same seeded generator), its batched row, personalize
    # and personalize_loop
    counts = [min(m, len(fed.patients[pi].train_x)) for pi in cohort]
    batch_idx = draw_personalize(torch.Generator(device="cuda").manual_seed(0), counts, m, steps,
                                 sv.personalize_batch_size)
    patient = fed.patients[cohort[0]]
    px = np.zeros((m, fed.x.shape[-1]), np.float32)
    py = np.zeros((m,), np.float32)
    px[:counts[0]], py[:counts[0]] = patient.train_x[:counts[0]], patient.train_y[:counts[0]]
    one = personalize(sv.model, sv.optimizer, sv.population, batch_idx[0], px, py)
    loop = personalize_loop(sv.model, sv.optimizer, sv.population, batch_idx[0], px, py)
    require(all(torch.equal(one[k], loop[k]) for k in one), "personalize != personalize_loop")
    batched = sv.params_rows([1])
    row_diff = max(float((batched[k][0] - one[k]).abs().max()) for k in one)
    row_bitwise = all(torch.equal(batched[k][0], one[k]) for k in one)
    require(row_diff <= PERSONALIZE_ROW_TOL, f"personalize vs its batched row: {row_diff}")
    batches = []
    batcher = CountingBatcher(sv.buckets)
    reqs = build_request_stream(fed, sv, 4096, seed=2)
    personalized_reqs = sum(r.patient > 0 for r in reqs)
    require(personalized_reqs > 0, "no request reached a personalized row")
    reset_launches()
    sv.warmup(history_len=fed.x.shape[-1])
    preds = replay(sv, batcher, reqs)
    torch.cuda.synchronize()
    launches_personalize = launches()
    require(launches_personalize["lstm_forward"] >= len(batches) > 0 and
            sum(launches_personalize.values()) == launches_personalize["lstm_forward"],
            f"{launches_personalize} launches for {len(batches)} batches")
    require(sorted(preds) == list(range(len(reqs))), "a request went unanswered")
    bad = selfcheck(sv, reqs, preds)
    require(bad == 0, f"{bad} served forecasts differ from the direct apply")
    plain_err = served_vs_plain(sv, reqs, preds)
    require(plain_err <= TOL, f"served (personalized) vs plain twin: {plain_err}")
    errs.append(plain_err)
    stats = batcher.stats()
    with contextlib.redirect_stdout(io.StringIO()) as cli_log:
        rc = serve_main(["--checkpoint", str(CKPT), "--personalize", "4", "--requests", "256",
                         "--selfcheck", "--device", "cuda"])
    require(rc == 0, f"launch.serve --personalize 4 --selfcheck exited {rc}")
    cli_lines = [ln for ln in cli_log.getvalue().splitlines()
                 if ln.startswith(("personalized", "selfcheck"))]
    emit("personalize", dataset=fed.name, patients=fed.num_nodes, hidden=128,
         cohort=PERSONALIZE_COHORT, history_windows=m, steps=steps,
         batch=min(sv.personalize_batch_size, m), optimizer="adam 5e-4",
         fine_tune_s=tune_s, fine_tune_ms_per_step=tune_s * 1e3 / steps,
         fine_tune_patients_per_s=PERSONALIZE_COHORT / tune_s,
         profiled_fine_tune_s=tune_profiled_s, fine_tune_device_busy_ms=tune_busy,
         fine_tune_device_busy_share=tune_busy / (tune_profiled_s * 1e3),
         fine_tune_gemm_device_ms=tune_gemm, fine_tune_device_items_per_step=tune_items / steps,
         loss_first10_mean=float(first10.mean()), loss_last10_mean=float(last10.mean()),
         loss_fell_every_patient=True, personalize_vs_loop="bitwise",
         personalize_vs_batched_row_bitwise=row_bitwise,
         personalize_vs_batched_row_max_abs_diff=row_diff, requests=len(reqs),
         personalized_requests=personalized_reqs, batches=len(batches),
         launches=launches_personalize, selfcheck_bitwise=len(reqs) - bad,
         max_abs_err_vs_plain=plain_err, p50_latency_ms=stats["p50_latency_ms"],
         p99_latency_ms=stats["p99_latency_ms"], forecasts_per_sec=stats["forecasts_per_sec"],
         cli=cli_lines, nvidia_smi=card)

    # 18. masked training at full width (the main path) -----------------
    from repro_torch.core.gossip import gossip_mix_sparse_tree
    from repro_torch.core.secure_agg import edge_mask_source, simulate_wires

    masked_counts: dict[str, int] = {}
    for dataset, repr_ in (("replace-bg", "sparse"), ("ohiot1dm", "dense")):
        fed = feds[dataset]
        for sigma in (0.0, 0.01):
            name = {("sparse", False): "gossip_mix_sparse", ("dense", False): "gossip_mix",
                    ("sparse", True): "gossip_mix_sparse_dp", ("dense", True): "gossip_mix_dp"}[
                        (repr_, sigma > 0)]
            runs = {}
            for impl in ("allgather", "masked"):
                trainer = GluADFL(LSTMModel(hidden=128).as_model(), get_optimizer("adam", 1e-3),
                                  FLConfig(num_nodes=fed.num_nodes, inactive_ratio=0.3),
                                  mixer="kernel", gossip_impl=impl, gossip_repr=repr_,
                                  dp_noise_sigma=sigma)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                _, hist, state = trainer.train(torch.Generator(device="cuda").manual_seed(8),
                                               fed.x, fed.y, fed.counts, batch_size=64,
                                               rounds=MASKED_ROUNDS, chunk=MASKED_ROUNDS)
                torch.cuda.synchronize()
                counts = launches()
                require(counts[name] == MASKED_ROUNDS and others(counts) == MASKED_ROUNDS,
                        f"{impl} {dataset} sigma={sigma}: launches {counts}, want "
                        f"{MASKED_ROUNDS} of {name}")
                hand_steps(counts, f"{impl} {dataset} sigma={sigma}", MASKED_ROUNDS)
                require(all(math.isfinite(h["loss"]) for h in hist), f"{impl} {dataset}: losses")
                runs[impl] = (trainer, hist, state, counts,
                              torch.cuda.max_memory_allocated() / 1e9)
            (ta, ha, a, _, peak_a), (tb, hb, b, counts, peak_b) = runs["allgather"], runs["masked"]
            require(ha == hb and torch.equal(a.params, b.params) and
                    all(torch.equal(a.opt_state[k], b.opt_state[k]) for k in a.opt_state),
                    f"{dataset} sigma={sigma}: masked training is not bitwise unmasked")
            masked_counts[name] = counts[name]
            # steady state, in turns (unmasked, masked, masked, unmasked), from each
            # run's state, with the round generator carried on
            walls = {"allgather": [], "masked": []}
            for impl in ("allgather", "masked", "masked", "allgather"):
                trainer, _, state, _, _ = runs[impl]
                gen = torch.Generator(device="cuda").manual_seed(9)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train(gen, fed.x, fed.y, fed.counts, batch_size=64, rounds=MASKED_ROUNDS,
                              chunk=MASKED_ROUNDS, state=state)
                torch.cuda.synchronize()
                walls[impl].append(time.perf_counter() - t0)
            with torch.profiler.profile(activities=activities) as prof:
                tb.train(torch.Generator(device="cuda").manual_seed(9), fed.x, fed.y, fed.counts,
                         batch_size=64, rounds=MASKED_ROUNDS, chunk=MASKED_ROUNDS, state=b)
                torch.cuda.synchronize()
            mask_busy, _, busy_ms, _ = span_breakdown(prof, MASK_SPANS)
            require(mask_busy["round.secure_mask"] > 0, "the profile saw no secure_mask work")
            emit("masked", dataset=dataset, nodes=fed.num_nodes, hidden=128, gossip_repr=repr_,
                 sigma=sigma, rounds=MASKED_ROUNDS, kernel=name, launches=counts,
                 bitwise_params_opt_state_history=True,
                 pairs=math.comb(ta.cfg.comm_batch + 1, 2),
                 rounds_per_s_unmasked=[MASKED_ROUNDS / w for w in walls["allgather"]],
                 rounds_per_s_masked=[MASKED_ROUNDS / w for w in walls["masked"]],
                 secure_mask_device_ms_per_round=mask_busy["round.secure_mask"] / MASKED_ROUNDS,
                 device_busy_ms_per_round_masked=busy_ms / MASKED_ROUNDS,
                 peak_memory_gb_unmasked=peak_a, peak_memory_gb_masked=peak_b, nvidia_smi=card)
    # the wires at N=37: no valid slot of a row with >= 2 of them sends its raw
    # row, and the books balance against the sparse mix
    wire_gen = torch.Generator(device="cuda").manual_seed(10)
    w, _, act, _, idx, wgt = gossip_inputs(wire_gen, WIRES_NODES, d_main, 0.3)
    masks = edge_mask_source(wire_gen, d_main)(idx, wgt)
    wires = simulate_wires(w, idx, wgt, masks)
    valid = wgt > 0
    raw = (wires == w[idx.long()]).all(dim=-1)
    guarded = valid & (valid.sum(dim=1, keepdim=True) >= 2)
    require(bool(guarded.any()) and not bool((raw & guarded).any()), "a wire carries a raw row")
    books = float((torch.einsum("nb,nbd->nd", wgt, wires)
                   - gossip_mix_sparse_tree(w, idx, wgt)).abs().max())
    require(books <= WIRES_TOL, f"the wires' books vs the sparse mix: {books}")
    emit("wires", nodes=WIRES_NODES, cols=d_main, active=int(act.sum()),
         masked_slots=int(guarded.sum()), raw_on_wire=0, books_max_abs_err=books, tol=WIRES_TOL)

    # 19. the scenario-sweep engine ----------------------------------------
    sweep_row = sweep_phase(feds, card, flush, errs)
    gate_launches = sweep_row.pop("gate_launches_sweep")

    # 20. the paper's baselines ----------------------------------------------
    baselines_row = baselines_phase(feds, card, flush, errs)

    # 21. Figs 4 and 5, the paper driver and the examples ----------------------
    figures_row = figures_phase(feds, card, errs)

    # 22. the sharded mixer over a one-rank NCCL group, and its CLI ------------
    sharded_row = sharded_phase(feds, card)

    # 23. RecurrentGemma-9B at full width and depth (hd 256 on wgmma) --------
    del params, caches, state, q, k, v
    torch.cuda.empty_cache()
    hybrid_row = hybrid_phase(card)

    # 24. the swept-sharded engine over a one-rank NCCL group, and its CLI -----
    torch.cuda.empty_cache()
    swept_row = swept_phase(feds, card)

    # 25. the MoE, SSM and enc-dec families at full width ----------------------
    torch.cuda.empty_cache()
    zoo_row = zoo_phase(card)

    # 26. the LM zoo's train step (Granite-MoE-1B-A400M) and gossip-DP ---------
    torch.cuda.empty_cache()
    train_row = train_phase(card)

    # 28. the trainer's gate kernels and its hand-written gradient ------------
    torch.cuda.empty_cache()
    gate_rows = lstm_train_phase(card)

    # 27. the multi-pod dry run: its memory fit, and the production mesh -------
    dryrun_phase(card, start_dryruns())

    phase_builds = {"15": lm_builds, "23": hybrid_row["builds_phase23"],
                    "25": zoo_row["builds_phase25"], "26": train_row["builds_phase26"]}
    sources = "src/repro_torch/kernels/csrc/"
    rows = [{
        "name": "lstm_forward", "route": "cuda",
        "source": sources + "lstm_forward.cu",
        "replaces": "src/repro/kernels/lstm_cell.py:51",
        "launches": launches_serve, "launches_personalize": launches_personalize["lstm_forward"],
        "max_abs_err": max(errs), **lstm_row, **sweep_row, **baselines_row, **figures_row,
        **sharded_row, **swept_row,
    }]
    path_launches = {"gossip_mix": trained["ohiot1dm"][1]["gossip_mix"],
                     "gossip_mix_sparse": trained["replace-bg"][1]["gossip_mix_sparse"],
                     **dp_counts}
    replaces = {"gossip_mix": 62, "gossip_mix_sparse": 102, "gossip_mix_dp": 201,
                "gossip_mix_sparse_dp": 150}
    for name, line in replaces.items():
        rows.append({"name": name, "route": "cuda", "source": sources + "gossip_mix.cu",
                     "replaces": f"src/repro/kernels/gossip_mix.py:{line}",
                     "launches": path_launches[name], "launches_masked": masked_counts[name],
                     "max_abs_err": gossip_err[name],
                     **gossip_rows[name]})
    rows.append({"name": "swa_attention", "route": "cuda", "source": sources + "swa_attention.cu",
                 "replaces": "src/repro/kernels/swa_attention.py:82",
                 "launches": lm_counts["swa_attention"], "max_abs_err": path_err["bf16_max_abs_err"],
                 "max_abs_err_sweep": swa_err, **swa_row,
                 "bound_fp32_ms": ops / FP32_OPS_PER_S * 1e3,
                 "hybrid_shape": rg_shape, "hybrid": hybrid,
                 "hd256_bf16": {**hybrid["256"]["bf16"], **hybrid_row,
                                "ptxas": next(lines for name, lines in swa_ptxas.items()
                                              if "wgmma_hd256" in name)},
                 # every build timed at RecurrentGemma-9B's shape, with its
                 # launches in each counted main-path run (phases 15, 23,
                 # 25 and 26, each counted from 0)
                 "builds": [{"build": hybrid[str(hd)][f"{dt}_build"], "hd": hd, "dtype": dt,
                             "launches_by_phase": {
                                 phase: builds.get(hybrid[str(hd)][f"{dt}_build"], 0)
                                 for phase, builds in phase_builds.items()},
                             **hybrid[str(hd)][dt]}
                            for hd in HYBRID_TIMED for dt in ("bf16", "fp32")],
                 "builds_phase15": lm_builds, "builds_phase15_slice": slice_builds,
                 "prefill_shape_fp32": fp32_timing,
                 "prefill_shape_fp32_hd64_synthetic": fp32_hd64_timing,
                 **zoo_row, **train_row})
    # the gate kernels' launches in the main-path sweep (phase 19), L of
    # each in each of its SWEEP_ROUNDS local steps
    for name, cells in gate_rows.items():
        rows.append({"name": name, "route": "cuda", "source": sources + "lstm_train.cu",
                     "replaces": None, "launches": gate_launches[name],
                     "launches_local_steps": SWEEP_ROUNDS, **cells})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-predictions"]:
        dryrun_predictions(Path(sys.argv[2]))
        sys.exit(0)
    sys.exit(main())
