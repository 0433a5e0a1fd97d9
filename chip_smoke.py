#!/usr/bin/env python3
"""Drive the PyTorch port's serving (both batch paths), training, ``pio``
lifecycle, the pod storage layout, batch-predict, evaluation, streaming
fold-in, e-commerce, similar-product, sequential and classification
template paths, the release lifecycle, the console, the telemetry, the
serving caches, checkpoint resume, the split layout, the deploy of a
JAX-written model blob, a fleet of replicas behind the query router,
the fleet aggregator and the autoscaler, and sharded and replicated
serving once on the CUDA card and check them.

    python3 chip_smoke.py [--seed N]

Phases, each printing one line of numbers, any failure exits non-zero:

1. card   — CUDA must be present; prints ``nvidia-smi``'s name and power
            limit.
2. build  — compiles every ``predictionio_tpu_torch/csrc/*.cu`` with nvcc
            (one process per source, all started together) into
            ``build/torch_kernels/``.
3. kernel — ``fused_topk`` on the f32, bf16 and int8 wires at ML-20M width
            (138,493 users x 26,744 items, rank 64), B in {1, 8, 37, 64,
            2048}, k in {16, 128}, the same tables cut to rank 10 (rows that
            are no multiple of 16 bytes: the element-wise staging branch),
            one ``base != 0`` case and an integer-valued tie case, each held
            against the plain version on the card. Each line names the
            catalogue splits, the queries a block takes and the staging
            branch the launch chose, the event-timed call (``ms``: what a
            caller waits, host launch work included), the device time with
            the launch queue kept full (``queued_ms``) and, from a
            ``torch.profiler`` trace, the device time of the scoring pass
            and of the merge pass (``scan_ms``, ``merge_ms``). Scores
            agree within |d| <= rtol * (1 + |plain|), rtol 1e-5 on f32 and
            1e-4 on bf16/int8; every returned id's own score, recomputed in
            float64, agrees with the score returned beside it at the same
            tolerance (so an id differs from the plain version's only
            inside a near-tie); ids are exact in the tie case.
4. slice  — an ML-20M-width model made from ``--seed`` is deployed through
            ``server.engineserver.deploy_models`` on the card with int8 serving
            tables and batching, on a free port. 64 single queries go over
            HTTP; then a burst of 2,048 queries on 32 connections from
            another process (standard library HTTP only), three
            times on servers of their own over the same bound tables: the
            staged pipeline, the serial drainers, the staged pipeline
            again, then once more staged with this process's interpreter
            switch interval cut from 5 ms to 0.5 ms (how much of a batch's
            time under load is waiting for the interpreter lock). Every
            answer is checked against the plain version on
            the same tables (each burst also splits the wall time of the
            batch's launch call, ``batch_predict_async``, into its
            thread's CPU time and the rest); one ``recommend_batch`` of
            2,048 users runs
            beside them. The kernel launch count is zeroed just before and
            read just after, and must be positive, as each burst's own
            launches. Each burst prints its qps, p50 and p99, launches and
            mean batch, ``/status.json``'s ``pipeline`` block (``depth``,
            ``deadlineExceeded``, which must be 0, ``overlappedDispatches``,
            which must be positive for a staged run, ``deviceIdleFraction``,
            ``overlapFraction``) and the server's phase and stage times a
            batch. Then the dispatch half of ``recommend_batch_async`` runs
            under ``torch.cuda.set_sync_debug_mode("error")`` (it must not
            wait on the card), and the readback of a launch with a second
            queued behind it is timed both ways: copies queued at dispatch
            (the port's) and copies made when resolving.
4b. telemetry — phase 4's tables behind a server with the JAX package's
            telemetry defaults (tracing, hot keys 128) and the NaN/Inf
            sentinel armed (``debug_numerics``): a burst of 2,048 queries
            on 32 connections, every other one with a ``traceparent``,
            every answer held to the plain top-k as in phase 4. Then
            ``/metrics`` in text and OpenMetrics must parse line by line;
            ``pio_query_latency_seconds_count`` and
            ``pio_batch_occupancy_sum`` equal the answers; the burst's
            ``pio_numerics_checks_total{entry="serve_topk"}`` equals its
            ``fused_topk`` launches, with no nonfinite;
            ``pio_device_hbm_bytes{stat="used"}`` is at least the bound
            tables' bytes and within 64 MiB of
            ``torch.cuda.memory_allocated()`` read beside it, ``limit`` the
            card's total memory; every exemplar's trace resolves on
            ``/trace.json?id=`` (or the ring evicted it); each query sent
            with a ``traceparent`` kept its trace id; the slowest retained
            queries' traces hold ``dispatch``, ``device_wait`` and
            ``readback`` under their ``batch``. ``POST /profile``
            (``durationMs`` 2000; a second one answers 409) during a second
            burst: its ``trace.json`` must name the ``fused_topk`` scan and
            merge kernels with device time. The first burst again, in
            turns on that server and one with tracing, hot keys and the
            sentinel off (on, off, on, off): the qps, p50 and p99 of each
            run. Last, ``cli eventserver --stats`` as a
            process: a segment.io webhook and a block of events counted by
            ``/stats.json`` and by route on ``/metrics``, the process's pid
            absent from ``nvidia-smi --query-compute-apps=pid`` after the
            scrape and the count of listed contexts unchanged, exit 0 on
            SIGINT. The launch counts are zeroed before
            the first burst and read after the second.
4c. cache — the serving caches and the pinned hot-user tier over phase
            4's tables: a burst of 2,048 queries (num 10) on 32
            connections whose users are drawn Zipf(1.5) over the 138,493
            users (the JAX package's load generator's skew; a few hundred
            distinct users, all inside the hot tier's capacity of 512),
            sent in turns to (a) a server with the cache off on the
            per-query path, (b) ``serving_cache=True`` on the per-query
            path (query tier, singleflight, hot tier at 512 entities,
            re-pinned every 256 serves) twice: from a cold cache, then
            after a refresh of the hot tier and with the query tier
            emptied, and (c) ``serving_cache=True`` behind the staged
            pipeline. Every answer is held to the plain top-k of the
            bound int8 tables as in phase 4. Each burst prints its qps,
            p50 and p99, each tier's hits, misses, hit ratio, entries and
            bytes, the coalesced followers, the pinned serves, the hot
            tier's refreshes, ``pinnedStale`` and ``refreshErrors`` (0,
            or the phase fails), and the ``fused_topk`` launches split
            into pinned serves, the pin's k-ladder and the full table
            (``CacheLaunches``: the three sum to the wrapper's count). In
            (b)'s second burst every query-tier miss must find its user
            pinned, the pinned serves (positive) must equal those misses
            less the coalesced followers, and the pinned launches the
            pinned serves. Then on (b): one ``rate`` event for each of 8
            cached hot users through an in-process event server grows the
            query tier's invalidations by 8 and makes each one's next
            answer a miss; ``apply_stream_delta`` with new rows for 4
            pinned users (``apply_row_updates``) drops their handles and
            starts a re-pin whose rows are the folded rows bit for bit,
            and their next answers (and an untouched pinned user's) are
            pinned serves held to the folded tables; ``POST
            /cache/flush`` and a rebind (a candidate promoted) each empty
            every tier. No thread is left after ``close()``. Last,
            ``fused_topk`` at the pinned shapes on the f32, bf16 and int8
            wires: a ``[512, 64]`` table from ``pin_user_rows`` (its rows
            the source rows bit for bit), B = 1, k in {8, ..., 128} at
            four slots, held to the plain version as phase 3 holds it and
            to the full-table launch for the same user bit for bit, and
            the pinned and full-table B = 1 launches event-timed in turns.
5. train-kernel — the MovieLens-20M surrogate
            (``benchmarks/ml20m_surrogate.py``, 20,000,263 ratings from
            ``--seed``) is packed as training packs it; ``fused_gram`` runs
            on every row block of one iteration (both sides, f32 and bf16
            wires) from the initial factors, each held against the plain
            version: |dA| <= 1e-5 * sum_l |wa| * max|f|^2 and |db| <=
            1e-5 * sum_l |wb| * max|f| per row (only the summation order
            differs). The named blocks print their L-split count and
            staging branch; two runs on the item side's L = 131,072 block
            must be bit-identical (the split sum has a fixed order); the
            named blocks run again over rank-10 tables (the shipped
            ``engine.json``'s rank: 40-byte rows, the element-wise
            branch). ``chol_solve`` solves those 138,493 user systems at
            r = 64 in one launch, the item systems in one launch, the same
            systems as training launches them (30 launches, one a row
            block, at their own n: their sum, slowest and fastest), and
            synthetic SPD systems at r in {10, 96, 128}, each line with its
            launch plan (``ops/solve.py::solve_plan``), ``ms`` (one
            event-timed call) and ``queued_ms`` (device time with the launch
            queue kept full): the relative
            residual ||Ax - b|| / (||A||_F ||x|| + ||b||) <= 1e-5 and ||x -
            x_plain|| <= 1e-3 ||x_plain|| per system (f32 Cholesky with
            another order of sums); r = 136 must take the library route
            (``cholesky_ex`` + ``cholesky_solve``) and launch nothing, its
            time printed beside the library call's and the plain loop's.
            The lower-triangle case: the item systems and
            the r = 10 and 128 systems with random finite values written
            above the diagonal must give the symmetric systems' x bit for
            bit.
6. train  — ``Engine.train`` of the recommendation template on the card
            through a data source over the surrogate: rank 64, 10
            iterations, default ``ALSParams``, launch counts zeroed just
            before and read just after (both must be positive). The
            training RMSE must be finite and lower than after 1 iteration;
            one iteration of the kernel path and of the same half-steps
            with the plain ``fused_gram`` and solve, from the same initial
            factors, agree within rtol 2e-3, atol 2e-4. The model goes
            through the model file, is deployed with int8 tables and
            batching, and its answers are checked as in phase 4. Prints
            the ``Engine.train`` window (read, pack and 10 iterations,
            synchronized) per iteration beside the median of isolated,
            synchronized iterations from the initial factors.
6a. implicit — one implicit ALS iteration (``implicit_prefs=True``,
            alpha 1.0, the surrogate's stars as counts) at ML-20M width and
            rank 64 on the card, launch counts zeroed just before and read
            just after (both positive), held against the same half-steps
            with the plain ``fused_gram`` and solve to phase 6's limits;
            then one iteration profiled: ``fused_gram``, ``chol_solve``,
            the fixed side's Gramian G (the library's matrix product),
            other kernels and device idle.
6b. sequential — the shipped sequential variant
            (``examples/sequential/engine.json``: dim 64, 2 heads, 2
            blocks, window 50, batch 256, 64 negatives) at ML-20M width:
            every surrogate user's ratings ordered by their timestamps
            into 138,493 windows over 26,744 items
            (``sequences_from_ratings``, timed: a host loop a user), then
            ``train_seqrec`` on the card for 2 epochs (20 shipped), the
            launch counts zeroed just before and read just after (no TPU
            kernel is on this path: all read 0). Epoch 2's loss must be
            below epoch 1's; one step of the trained model on the card
            against the same step in float64 on the host (same weights,
            batch and negatives): the loss within 1e-5 relative, each
            gradient within 5e-3 normwise, the Adam update within 1e-6
            (2 * lr where |g64| < 1e-5). One step profiled (device busy
            and idle share; forward, backward and Adam by CUDA events);
            ``recommend_next_batch`` p50/p99 at B = 1 and 256, and every
            served list of 256 histories held to its float64
            recomputation (ids equal outside near-ties, scores within
            1e-4 * (1 + |s|)). Prints steps/s and sequences/s. Then
            data-parallel ``train_seqrec(mesh=)`` over 4 positions on the
            one card (``PTPU_TORCH_FORCE_DEVICE_COUNT=4``): 64 steps
            (16,384 windows, one epoch) against the one card's 64 on the
            same windows, initial weights and negatives. The first step
            (same weights, batch and negatives) under the sign rule of
            ``tests/test_torch_sequential.py`` (within 1e-5 where the one
            card's |g| >= 1e-5, else 2 * lr); after 64 steps the epoch's
            loss within rtol 1e-4, the weights whose one-card gradient
            stayed >= 1e-5 at every step within 5e-4, and at least 0.995
            of all weights within 1e-4; steps/s of each, launches 0.
6c. stream-kernel — ``models.als.fold_in_rows`` on the card against phase
            6's trained item table (f32, and its int8 serving table), B in
            {64, 2048} touched rows with histories of L = 512 from
            ``--seed``, explicit and implicit (with a cached
            ``fixed_gramian``), each held against the same call on CPU
            copies (the plain versions): |x - x_cpu| <= 1e-4 + 1e-3
            |x_cpu|. Prints the event-timed call, the device time of
            ``fused_gram`` and ``chol_solve`` from a ``torch.profiler``
            trace beside their bounds, and each kernel's launches
            (checked positive).
6d. ring  — ``ring_attention`` over 4 positions on the one card against
            its one-card path (``mesh=None``) on the card, at the shipped
            sequential variant's heads and head width (2 x 32), B = 4, S =
            16,384, causal, left-padded ``key_valid`` (one row padded past
            most of its window: rows that see no key give 0): f32 within
            rtol 1e-5, atol 1e-6, bf16 within one bf16 step (2**-7 * (1 +
            |x|)). Prints each path's ms (median of 3) and
            ``max_memory_allocated``.
7. gram-table — ``gram_table`` (no path of the system launches it) held
            against its plain version with phase 5's tolerance on both
            wires: a 512 x 64 table from ``--seed``, B = 8,192, L = 512,
            forced to each path (1, the table in shared memory; 2, rows
            gathered through L2) and automatic; 512 x 10 and 512 x 128;
            the ML-20M width, the 26,744 x 64 initial item table with
            the user side's L = 512 bucket (8,192 rows), the block phase
            5 reports for ``fused_gram``; B = 8,191, L = 500 with indices
            outside the table; a split launch (40 rows of 2,048) run
            twice, bit for bit. Each launch takes its plan's path, and A
            is exactly symmetric.
8. pio    — the lifecycle in a temporary ``PIO_HOME`` (SQLite): ``app
            new`` through the CLI, the event server on a free port, every
            rating of every 10th surrogate user (2,010,817 at seed 0) sent
            over HTTP (a few hundred through ``/events.json`` and
            ``/batch/events.json``, the rest as npz column blocks), one
            user read back through ``GET /events.json``, the store read
            back as exactly the sent (user, item, rating) multiset, ``cli
            train`` on the card with ``examples/recommendation/
            engine.json``'s factory at rank 64 x 10 iterations (the
            ``fused_gram`` and ``chol_solve`` counts zeroed just before and
            read just after, both positive; the instance COMPLETED; RMSE
            finite and below one iteration's), then the storage-backed
            ``deploy`` with batching and 64 ``/queries.json`` answers
            checked against the plain top-k (``fused_topk`` count
            positive). The cold ``find_columnar`` of a process with
            threads must encode in-process (never forked). Then the
            feedback loop: the stored model deployed again with
            ``feedback=True`` into an app of its own and ``log_url`` on a
            collector here; 63 queries on it alone (``fused_topk``
            counted, positive), then in turns with the deploy without
            feedback (client p50 / p99 of each, the access log's
            ``feedbackMs``): each of the 126 answers' ``prId`` names one
            ``pio_pr``/``predict`` event whose ``prediction`` is the
            answer without it, every answer held to float64; one 5xx
            forced through ``serving.dispatch`` ships exactly one message
            (prefixed, naming the instance) and ``close()`` leaves no
            thread; the ratings app's event count unchanged. Last, an
            instance of the same variant whose stored model is None: its
            deploy retrains on the card before it binds (``fused_gram``
            and ``chol_solve`` counted from zero to the bind, positive)
            and 16 answers are held to the float64 top-k of the retrained
            factors. The whole phase runs under ``torch.profiler``,
            which gives the device's busy and idle share.
8a. storage — the pod storage layout over phase 8's events, in
            directories of its own. The ``pio`` app's 2,010,817 events
            written as JSON lines in ``cli export``'s format from the
            arrays phase 8 ingested (``cli export`` of the store is cut:
            phase 14 times it on its app); ``cli import`` of the file
            into a new SEGMENTFS store through the native codec's bulk
            lane (the import's events/s, the lanes' block counts: any
            Python-lane block fails the phase) and its cold columnar
            sidecar encode split into parse, hash, timestamps,
            dictionaries and write; ``find_columnar`` from a fresh
            client and warm; the data source's ``RatingsCOO`` equal to
            the SQLite store's (id maps and triples). ``cli
            storageserver --secret`` as a process in front of the
            SEGMENTFS store and a ``FakeObjectStoreServer`` bucket in
            this one; metadata and events through a REMOTE source, models
            through an S3 source. ``cli train`` of phase 8's variant in a
            fresh process over that storage (stages, its ``.npz`` pull;
            ``fused_gram`` and ``chol_solve`` launches positive), its
            factors against phase 8's model (exact when the ratings come
            in the same order), the bucket's blob byte for byte
            ``ModelsDAO.get``'s; a second REMOTE ``find_columnar`` must
            be a 304 with no bytes re-sent (the server's ``/metrics``).
            ``cli deploy`` from that storage in a fresh process: deploy
            to ``servingWarm`` and to the first answer, 64 answers held to
            the float64 top-k of the model read back from the bucket,
            ``fused_topk`` launches positive. ``cli train`` of a copy of
            the SQLite file without its sidecar in a fresh process, whose
            single thread forks the first encode (its ``read_s``). A
            process with a second thread alive reads another copy of that
            file cold and must encode in-process (never forked), beside
            the SEGMENTFS steps. LOCALFS,
            every 80th user (cut), in a process beside the SEGMENTFS steps
            and the SQLite copy: the cut of the exported lines, ``cli
            import`` and ``find_columnar`` giving the cut's triples, and
            how long the phase waited for it after those steps. Last the
            server stops on SIGINT with exit 0, and no thread the phase
            started is left.
8a'. train-mesh — ALS over a mesh and across processes, after phase 8a
            (``PTPU_TORCH_FORCE_DEVICE_COUNT`` set for its own meshes
            only). (a) ``train_als(mesh=make_mesh(data=4))``: 4 shards
            on the one card, the surrogate at rank 64, 10 iterations
            from phase 6's initial tables: the explicit factors must be
            phase 6's bit for bit (each piece of a position is planned
            as the one card's block it was cut from); the same pieces
            planned as their own rows, timed in turns with the block
            plan and trained 10 iterations by hand, their factors'
            distance from phase 6's printed (a finding), with each
            plan's launches that ``fused_gram`` splits into partial
            sums; launches counted, one iteration timed
            against the one card's, the all-gather's kernels from a
            ``torch.profiler`` trace; 1 implicit iteration (alpha 1.0)
            within |d| <= 1e-5 (1 + |one card's|). (b) Two ranks on the
            one card over gloo (fresh processes), each a
            ``ShardedColumnarRatingsSource`` over its half of the
            surrogate's columnar batch (it must materialise 0.4–0.6 of
            the triples before the shuffle) through
            ``pack_ratings_multihost``, checkpointing every iteration
            through the ``DistributedCheckpointer``, 4 iterations: both
            exit 0, both launch both kernels, both count the device
            collectives gloo staged through the host
            (``multihost.HOST_STAGED``, printed with their bytes), the
            factors within |d| <= 1e-5 + 1e-4 |in-process| of the
            in-process 2 shards'; a
            second launch of 6 iterations resumes from step 4, launches
            for 2 iterations only and holds to the in-process 6. (c) One
            rank over NCCL trains the JAX multihost test's problem
            through the process-group code path: bitwise the in-process
            one shard's. (d) ``cli storageserver`` over phase 8's store
            and two ``cli train`` ranks (``PIO_COORDINATOR``,
            ``PIO_NUM_PROCESSES=2``, ``PIO_DIST_BACKEND=gloo``) over
            REMOTE with shard pushdown: both exit 0, each pulls 0.4–0.6
            of phase 8a's single ``.npz`` pull, one COMPLETED instance
            and one blob, its factors within the (b) tolerance of phase
            8a's REMOTE model, no thread or process left; the instance
            and its blob are then removed from phase 8's store.
8b. batchpredict — ``cli batchpredict`` on the card from phase 8's store:
            one query line ``{"user", "num": 10}`` for each of its 13,850
            users (seed 0), the ``fused_topk`` count zeroed just before and
            read just after (positive: flushes of 1,024). Every output line
            must carry its own query and 10 items whose scores agree with
            the plain top-k on the trained f32 tables within 1e-5 *
            (1 + |plain|), each item scoring what was returned beside it
            (float64). Prints the rows per second of the command.
8c. eval  — ``cli eval chip_smoke:EVALUATION chip_smoke:GRID`` on the
            card from phase 8's store (the CLI loads both from this file:
            the shipped example's metrics, Precision@10 at threshold 4.0
            optimized; 2 folds x ALS rank 64 with 5 and 10 iterations),
            then the same with ``--parallelism 2``. Each run: the launch
            counts of all four kernels zeroed just before and read just
            after (``fused_gram``, ``chol_solve``, ``fused_topk``
            positive, ``gram_table`` 0); exactly 2 packings and 4
            trainings (``models.als.pack_ratings`` and
            ``ALSAlgorithm.train`` wrapped here); every held-out query's
            10 items held against the plain top-k in float64 on the card
            as ``verify_topk`` holds the kernel; Precision@10 recomputed
            from those plain answers equal to the reported score, or
            within the share of lists that differ inside a near-tie; the
            instance EVALCOMPLETED with ``bestIndex`` the argmax of its
            scores. The two runs give the same scores bit for bit and the
            same launches. One line a run: the command's seconds,
            ``read_eval``'s, each params set's ``trainS``/``evalS`` and
            score, held-out queries scored a second, launches.
9. stream — streaming fold-in on phase 8's store and model: the stream
            cursor set where the trained log ends, ``cli deploy --batching
            --stream --stream-app MyApp1 --stream-max-events 512
            --stream-interval-ms 100``, and 3 bursts of 288 ``rate``
            events (224 from 16 users of the store on new items, drawn by
            the store's item popularity and rating histogram; 48 from 4
            cold users, 12 of their real surrogate ratings each; 16 on 2
            item ids new in the burst), each one npz column block through
            the event server, each after the previous pass applied. One
            line a pass: its events and rows, the trainer's pass time split
            into history reads, ``fold_in_rows`` and apply (the fold-in's
            own functions, wrapped here), event to servable (the block's
            201 to the first ``/queries.json`` answer served from the new
            rows) and the pass's launches. Checks: every touched user's
            row against a float64 solve of its store history (the most
            recent 512) on the bound item table within 1e-3 relative;
            untouched rows and the model bound before the first pass bit
            for bit; the cold users' answers against the plain top-k;
            ``n_items`` grown by 6; ``/stream.json`` 3 applies, 0 canary
            rejects, cursor lag 0; stop, then start with the same consumer
            consuming 0; no trainer thread after ``close()``. The launch
            counts are zeroed just before the bursts and read just after
            (``fused_gram``, ``chol_solve``, ``fused_topk`` positive).
            Each canary check prints a line of its own (the trainer's gate
            unchanged; ``CanaryProbeLog``): its verdict, each arm's probe
            times, and for the candidate's slowest key whether a probe
            overlapped a garbage-collector pause, a served
            ``/queries.json`` or the first launch on the candidate, and
            the device and pinned-host allocator growth. A refused delta
            fails the phase at once. ``/metrics``' ``pio_stream_*`` samples
            must equal the trainer's own counts. After the restart one
            more burst of 48 events goes through ``/batch/events.json``
            with a ``traceparent``: the event server stamps it into each
            event, and the restarted trainer's pass over them must be
            retained as that trace's ``stream.foldin`` (the caller's span
            its parent) and launch ``fused_gram`` and ``chol_solve``.

10. templates — the shipped e-commerce and similar-product variants
            (``examples/{ecommerce,similarproduct}/engine.json``, only the
            app name changed) in phase 8's ``PIO_HOME``, in an app of their
            own: every 200th surrogate user's ratings of the 8,000
            most-rated items become ``view`` events (a second where s >= 4),
            ``buy`` (s >= 4.5), ``like`` (s >= 4) and ``dislike`` (s <= 2),
            with ``$set`` for every user, every item (1-3 of 20
            categories) and the ``unavailableItems`` and ``weightedItems``
            constraints, loaded by ``cli import``. ``cli train`` of each
            variant on the card (rank 10, 20 iterations, as shipped;
            ``fused_gram`` and ``chol_solve`` counted for each training and
            each ALS algorithm, all positive), the co-occurrence model's
            indices and counts equal bit for bit to a numpy count of the
            stored pairs; views of 8 users unknown to the model posted
            after training; ``cli deploy`` of each and 32 ``/queries.json``
            each (known users with ``unseenOnly``, a category filter, a
            white list, unknown users with recent views and without; 1-3
            items with categories and black lists), every answer held to a
            float64 recomputation on the host from the persisted model and
            the store read without a deadline (ids equal outside
            near-ties, scores within 1e-5 * (1 + |plain|) for e-commerce,
            1e-4 for the z-scored similar-product sums). Every
            serving-time point read (``EventStoreFacade.find_by_entity``,
            wrapped here) is timed, and none may raise. Prints the HTTP
            and point-read p50/p99. Before the deploys, both variants
            again through ``Engine.train`` over a mesh of 4 positions on
            the one card (the context's mesh): every ALS table within
            1e-5 (1 + |x|) of the one-card training ``cli train`` stored,
            ``fused_gram`` and ``chol_solve`` counted and positive, each
            ALS iteration's time beside the one card's.

11. sequential-pio — the shipped sequential variant through the CLI in
            phase 8's ``PIO_HOME``, in an app of its own (only the app name
            changed): every 200th surrogate user's ratings as timed
            ``view`` events by ``cli import``, ``cli train`` (20 epochs, as
            shipped), ``cli deploy``, 32 user queries (each history read at
            serving time through ``find_by_entity`` with its 200 ms
            deadline, timed; none may raise and no answer may be empty,
            as a late read leaves it) and 32 item queries over HTTP, every
            answer held to its float64 recomputation as in phase 6b; then
            ``cli eval`` of the port's shipped sequential evaluation
            (``predictionio_tpu_torch.examples.sequential_evaluation``: 4
            params sets), the instance EVALCOMPLETED with ``bestIndex``
            the argmax of its HitRate@10 scores.
12. classification — the shipped classification variant
            (``examples/classification/engine.json`` unchanged: naive
            Bayes in app MyApp2) and a random-forest variant (the JAX
            package's default ``RandomForestParams``) through the CLI:
            100,000 users ``$set`` with ``plan`` (0 or 1) and Poisson
            attr0..2 of class-dependent means from ``--seed`` by ``cli
            import``, ``cli train`` and ``cli deploy --batching`` of each
            and 64 queries over HTTP; naive-Bayes labels held to the host
            float64 ``predict`` (a different label only within 1e-4 of a
            tie), the forest's labels to the argmax of a numpy traversal;
            every point scored on the card in one call and held the same
            way (the forest's votes equal exactly).

13. release — releases on phase 8's store: the items the surrogate
            rates but no 10th user did (4,251 at seed 0) get up to 3 of
            their surrogate ratings each by ``cli import``, then two COMPLETED
            releases of one engine triple (engine id ``release`` over
            MyApp1's events, rank 64, every rated item: 25,385 of the
            26,744 catalogue ids at seed 0, the algorithm's seed 1 then
            2) by ``cli train``, ``fused_gram`` and
            ``chol_solve`` counted; ``cli deploy --batching`` binds the newer; ``cli
            release pin`` of the older, ``POST /reload`` (timed to the
            first answer from the pinned release) and ``/status.json``
            naming it; a fresh ``cli deploy`` on the pinned store binds
            the pin too. A canary of the newer (``POST /release/canary``,
            a 1 s gate window, the JAX package's thresholds) driven until
            the gate concludes: ``promoted``, 0 errors on either arm, the
            history ``canary ... promote``. Each query's user comes from
            a cohort below the first ramp step (always the candidate) or
            at or past 25% (the stable arm until the last step), read
            with ``cohort_bucket``, and each answer is held to the float64
            top-k of the factors of the release that served it
            (``check_answer``). ``fused_topk`` launches are attributed to
            the arm that made them (``ArmLaunches``: the sum must equal
            the wrapper's count) and the candidate's B = 1 launches are
            event-timed. Then a shadow rollout of the older (answers from
            stable, ``pio_release_shadow_mirrors_total`` positive on
            ``/metrics``) ended by ``POST /release/rollback``, and ``POST
            /release/rollback`` with no candidate, which rebinds the older
            (answers held to it). Prints the reload and fresh-deploy
            times, the time of ``bind_candidate``, the launches and the
            ``/release.json`` p50/p99 of each arm, beside the card's name
            and power limit.

14. console — the console on phase 8's store, every command a ``python
            -m predictionio_tpu_torch.cli`` process where a fresh process
            is the point. ``cli build --artifact-dir A`` into a new, empty
            ``A`` (the command's seconds, each library's ``nvcc``
            seconds and the host codec's ``g++`` seconds), then again (no
            ``nvcc`` or ``g++`` may run). Phase 8's variant
            deployed with ``--batching`` twice side by side, from ``A``
            (built) and from a new, empty ``B`` (cold), each process's
            whole sequence below in a thread of its own: the seconds from
            the process's start to ``servingWarm`` and to the first
            correct answer (each under the other's load), and
            ``warmReport``; built must report ``artifactWarm`` and a
            ``compile`` phase of 0, cold a ``compile`` phase above 0; the
            ``fused_topk`` counter on ``/status.json`` must count at least
            the ladder's calls once warm; 32 answers are held to the
            float64 top-k of the bound tables. On the built deploy: ``cli
            status --ip --port`` names the card and its power limit, ``GET
            /`` names the instance, ``POST /drain`` reads ``draining`` and
            16 answers after it are still correct, the counter growing;
            ``cli undeploy`` ends each deploy, which is then waited for.
            ``start-all`` on free ports: the admin API lists, creates,
            empties and deletes an app; the dashboard lists phase 8c's
            EVALCOMPLETED instances and serves their HTML and JSON;
            ``stop-all``, after which no pid from the pidfiles is alive.
            ``cli export`` of phase 11's app (91,546 events) and ``cli
            import`` of the file into a new app: equal counts, and each
            one's rows/s.
            Every time stands beside the card's name and power limit.
15. resume — runs right after phase 6a, on the surrogate at rank 64 x
            10 iterations (packed once): ``train_als`` without
            checkpoints; with ``checkpoint_dir`` (a save every iteration,
            each save's seconds and bytes recorded); a second directory
            armed with ``checkpoint.commit=error,after=5,times=1`` (the
            run dies as step 6 commits, steps up to 5 on disk) where a torn
            ``step_6.npz`` is then written and a fresh call resumes: it
            must skip the torn step, start at 5, give U and V bitwise equal
            to both earlier runs and launch ``fused_gram`` and
            ``chol_solve`` exactly half a whole run's times (counted just
            before and after). A run of other params on the first
            directory is refused. Then ``history_mode="split"`` at
            ``auto_split_len``: 10 iterations twice from the same initial
            factors (bitwise equal), one iteration held to the bucket
            layout's from the same factors (atol 2e-4, rtol 2e-3: the same
            normal equations summed in another order), the 10-iteration
            RMSEs within 1e-3 relative; prints L, the virtual rows, one
            iteration's median ms, a profiled iteration's split into
            ``fused_gram``, ``chol_solve``, other kernels and device idle,
            and the launches. Then the split layout over 4 positions on
            the one card: 2 explicit iterations and 1 implicit iteration
            from the same factors, bitwise the one card's split training,
            the ``fused_gram`` and ``chol_solve`` launches counted (zeroed
            just before, read just after: each positive), and one
            iteration's ms on each path (median of 3).
16. jaxblob — runs after phase 14, in phase 8's ``PIO_HOME``: phase 6's trained
            factors and the surrogate's id maps as a blob in the JAX
            package's layout (``pickle`` protocol 4 of an ``ALSModel``,
            written by :class:`JaxLayoutPickler` from stand-in classes,
            which a CPU test loads through the JAX package's own
            ``loads_models``), stored under an engine instance whose
            factory is the JAX package's; ``cli deploy --batching`` of
            that variant answers 64 queries (``fused_topk`` counted just
            before and after, positive), their top-k ids equal to the same
            factors served from the port's own blob and their scores
            within 1e-5 * (1 + |s|). Prints the blob's write and decode
            times, ``servingWarm`` and the first answer. A blob naming
            ``builtins.open`` (its reduce would create a marker file) is
            refused and the marker never exists.
17. fleet — runs after phase 16, on its store and model. (a) ``python -m
            predictionio_tpu_torch.cli deploy --fleet-of 3 --autoscale
            --min-replicas 2 --max-replicas 4 --slo-specs
            slo/specs/ci.json --batching`` in a process of its own, with
            ``PTPU_FAULTS="router.forward=error,times=1"`` and no
            capacity model (the knee must read absent: no capacity floor
            measured elsewhere applies to the card); once ``/fleet.json``
            shows 3 warm replicas, ``cli fleet scale --to 4``: the new
            replica joins the ring warm, its ladder having launched
            ``fused_topk`` (``warmReport``), before it served anything
            (at the autoscaler's ceiling the ring then holds still
            through the bursts: the spec file's 150 ms latency spec can
            burn under them, and below the ceiling the autoscaler adds a
            replica in the middle of one). Then a burst of 2,048
            queries on 32 connections through the router with users
            uniform over the 138,493, then one with users Zipf(1.5).
            Every answer is held
            to the float64 top-10 of the model's factors. For each burst
            (the ring unchanged through it): each replica's served count
            (``/status.json`` through ``/fleet.json``) equals the answers
            naming it (``X-Routed-To``) and the users ``HashRing.assign``
            gives it less those placed elsewhere plus those placed on it,
            every off-ring placement being the retried query (the next
            replica in ring order) or a hot key inside its spill set, the
            router's spill count at least those; the merged query-latency
            count and 5xx equal the sum of the replicas' own
            ``/metrics.json``; ``pio_router_retries_total`` is exactly 1
            (the injected fault), each replica's
            ``pio_fault_injections_total`` counted it, and no 5xx; the
            ``fused_topk`` counter on ``/status.json`` grew. The same
            uniform burst to one replica alone. ``cli fleet scale --to 2``
            during a burst: two replicas drain and stop, every answer
            correct, no error. ``POST /stop`` to the aggregator: exit 0.
            (b) In process, ``cli.build_fleet_deploy`` of 2 replicas with
            the autoscaler and the spec file's 150 ms latency spec under
            steady traffic: a 400 ms ``serving.dispatch`` latency lights
            the fleet's fast burn, the autoscaler scales out to 3 (the
            decision logged and its trace kept under reason
            ``autoscale``); the fault cleared, the burn goes out. Prints
            each burst's qps, p50 and p99 (through the router against one
            replica alone), the scale-out and drain times, the merge's
            scrape ms, the times from injection to breach to a ready third
            replica, and, last, the SLO engine's cost: the uniform burst
            on one engine server with its default 1 s tick and with
            ``slo_interval_ms=0``, in turns.
17b. mesh — runs after phase 17, on its store and model, with 4 devices
            on the one card (``PTPU_TORCH_FORCE_DEVICE_COUNT=4`` for its
            own servers and meshes only). (a) ``shard_model`` over 4
            shards for the f32, bf16 and int8 tables at B = 2,048 and
            B = 1, k = 16: ids equal to the single table's, scores within
            the wire's tolerance (bitwise printed when they are), 4
            ``fused_topk`` launches a batch, 64 answers held to float64,
            one shard's launch timed beside the whole table's. (b) ``cli
            deploy --serving-mode replicated --batching`` (4 lanes) and a
            ``single`` deploy in fresh processes, the Zipf(1.5) burst of
            2,048 queries on 32 connections to each in turns (every
            answer held to float64, every lane dispatching); then a third
            replicated process with ``serving.lane=error,lane=1,times=3``
            and ``serving.lane_restart=error,lane=1,times=3`` armed: the
            burst fails no query, ``pio_serving_degraded`` reads 1 while
            lane 1 is dead, then ``pio_lane_restarts_total{lane="1"}``
            reads 1 and the lane serves again; every process exits 0 and
            the drill's leaves no thread. (c) ``deploy --serving-mode
            sharded --stream`` in process: one burst of 32 ``rate``
            events (4 users) folds in through ``fused_gram`` and
            ``chol_solve``, and
            the served rows equal a single-device fold-in of the same
            events. (d) The hot tier under replicated lanes: pinned serves
            on every lane bit-equal to the lane's full-table answer.
18. audit — runs after phase 17, on the stores of phases 8 and 16. (a)
            ``python -m predictionio_tpu_torch.cli audit-lifecycle`` in a
            process of its own on the card: the six entries (event,
            storage and engine servers, the stream trainer, the fleet
            aggregator, the router's lifecycle and autoscaler) must each
            release every thread, fd and socket over 3 start→stop cycles
            against the committed all-zero baseline. (b) In this process
            ``analysis.lifecycle_audit.run_audit`` (one warm-up cycle,
            then 3) over two full-width entries: ``engine_server``, a
            ``cli deploy --batching`` of phase 16's variant (138,493 x
            26,744, rank 64, 42.3 MB f32) answering 64 HTTP queries held
            to the float64 top-10 and closed, each cycle; and
            ``stream_trainer``, a ``cli deploy`` of phase 8's variant and a
            stream trainer of its own (consumer ``chip-audit``, its cursor
            set where the log ends) folding in one burst of 4 users' 64
            ``rate`` events through ``fused_gram`` and ``chol_solve``, then
            stopped and closed, each cycle. Each entry's census must be
            zero, ``torch.cuda.memory_allocated()`` after the measured
            cycles must exceed the reading after the warm-up cycle by
            less than one cycle's tables (42.3 MB), and every cycle must
            launch its kernels. (c) The gate bites: a poller that starts a
            thread it never joins and keeps a 42.3 MB tensor on the card
            each cycle is flagged by the static ``leaked-thread`` rule,
            and its run fails both the census (threads) and the memory
            gate.

Phase 2b (check), after phase 2: ``python -m predictionio_tpu_torch.cli
check`` in a process of its own must print ``clean`` and exit 0 (its
seconds printed); each kernel's shared-memory formula in
``ops/smem.py`` must equal its library's ``<name>_smem_bytes`` export at
every point its launcher accepts (for ``fused_topk`` every point
``csrc/fused_topk.cu`` validates, planned or not), and the largest
accepted point plus the kernel's static shared memory
(``cudaFuncGetAttributes``, through ``<name>_static_smem``) must fit the
card's opt-in limit, read from the card and printed beside its name and
power limit. The kernel-safety rules (``dma-unwaited``,
``low-precision-accumulator``, ``missing-interpret-fallback``) are in
the registry ``cli check`` ran with no baseline, and each finds its
seeded fault in a scratch package (a ``cp.async`` never waited, a bf16
shared accumulator, a launcher that returns before its launch). Then
``python -m predictionio_tpu_torch.cli audit-numerics`` in a process of
its own on the card must exit 0 against the committed ``cuda`` section
of ``analysis/numerics_baseline.json``, and its census must show: each
serving wire (``device_topk_off``, ``_bf16``, ``_int8``) launching
``fused_topk``; the bf16 and int8 wires' float32 results below the f32
size of their item table (no f32 copy of a quantized table);
``lhs_fused`` launching ``fused_gram`` and ``train_update_block``
``chol_solve``; ``foldin_update_bf16`` with no reduction at bf16. Last
a seeded regression, ``ops/gram.py``'s bf16 einsum with its upcast
dropped, must be flagged by ``low-precision-reduction`` in a scratch
package and, run on the card, fail the census diff against the
einsum as shipped. Then ``analysis/hlo_audit.py::run_audit`` on the card
in a threaded child, entry by entry (each kernel's launches and the
allocator's peak read around each): the collective census of the 8 mesh
entries must pass ``diff_manifests`` against the committed ``cuda``
section of ``analysis/hlo_baseline.json``, its collectives, their shapes
and its joins must be exactly the committed ``cpu`` section's,
``lhs_fused`` must launch ``fused_gram`` and ``chol_solve`` and
``sharded_rank`` ``fused_topk``, and ``sharded_rank`` with its item table
made whole through ``unshard_table`` must fail the gate with the entry
and its ``aten.cat`` join named.

Phase 4b arms ``serving.dispatch=latency,delay_ms=400,times=1`` for its
first burst (as ``benchmarks/trace_smoke.py`` does), so the delayed
batch's traces are kept and the exemplar check does not depend on the
adaptive p99; ``pio_fault_injections_total`` must read 1.

Phases 6b, 11 and 12 print the four kernels' launch counts (each 0: no
TPU kernel is on their paths) beside the card's name and power limit.
The in-process engine servers of the earlier phases warm at bind (their
serving ladder launches ``fused_topk``); each phase waits for that
before it counts or times its own work. Then a ``{"kernels": [...]}``
line (time, bound, plain and library times, launches on the main path,
in the batch-predict job for ``fused_topk``, in the serial eval run, on
the stream path, in the implicit iteration, in the templates phase and
its trainings over a mesh, in phase 8's feedback deploy and its retrain
on deploy, in phases 6b, 11, 12 and 13, for ``fused_topk`` in phase 14's two deploys,
in phase 4b's counted bursts, in phase 4c's counted part and in phase
8a's REMOTE training and deploy, phase 15's resumed and split
trainings and its split training over 4 positions, phase 16's
deploy, phase 17's fleet process and autoscaled fleet, phase 17b's
meshes, lanes and sharded stream and phase 18's
full-width cycles) and, last, ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import gc
import importlib.util
import inspect
import io
import json
import logging
import os
import pickle
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.controller.evaluation import EngineParamsGenerator
from predictionio_tpu_torch.controller.params import EngineParams
from predictionio_tpu_torch.examples import recommendation_evaluation
from predictionio_tpu_torch.models.als import ALSParams
from predictionio_tpu_torch.templates.recommendation import DataSourceParams

# ML-20M at rank 64: the north-star serving width
N_USERS, N_ITEMS, RANK = 138_493, 26_744, 64
BATCH = 2048                      # queries per dispatch of a batch sweep
RTOL = {"f32": 1e-5, "bf16": 1e-4, "int8": 1e-4}
#: published H100 SXM peaks (dense) for the operations on each wire, and
#: its memory rate; the bound is the larger of operations and bytes
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


#: the longest a bind-time warm-up may take (a cold one runs nvcc)
WARM_TIMEOUT_S = 300.0


def warmed(srv) -> dict:
    """Wait for an in-process engine server's bind-time warm-up (kernels
    loaded, serving ladder run) and return its report; fails on an
    error in it."""
    qs = srv.query_server
    check(qs.warm_done.wait(WARM_TIMEOUT_S),
          "the serving warm-up did not finish")
    report = qs.status()["warmReport"]
    check("error" not in report,
          f"the serving warm-up failed: {report.get('error')}")
    return report


@contextlib.contextmanager
def phase(name: str):
    """Print a phase's wall seconds when it ends."""
    t0 = time.perf_counter()
    yield
    print(f"phase {name} seconds={time.perf_counter() - t0:.2f}", flush=True)


def median_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` single runs (CUDA
    events around each, after one warm-up run)."""
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def queued_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` with the launch queue kept full: a long
    matrix product runs first, so the ``reps`` calls queue behind it and
    run back to back, whatever the host takes to launch one."""
    fn()
    big = torch.empty((8192, 8192), device="cuda")
    torch.cuda.synchronize()
    torch.mm(big, big)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def kernel_ms(fn, reps: int, names: tuple) -> list:
    """Mean device ms a call of ``fn`` spends in the kernels whose name
    holds each of ``names``, from a ``torch.profiler`` trace of ``reps``
    calls."""
    from torch.profiler import ProfilerActivity, profile

    from predictionio_tpu_torch.obs.trace import profiler_held

    fn()
    torch.cuda.synchronize()
    with profiler_held(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = [0.0] * len(names)
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        for n, name in enumerate(names):
            if name in e.key:
                out[n] += us / 1e3 / reps
    return out


def bound(wire: str, B: int, k: int, n_items: int, r: int) -> tuple:
    """(least ms, what bounds it) for one fused_topk call: each input byte
    read once (the B gathered user rows, the item table, scales, ids),
    each output byte written once, and 2*B*I*r operations at the wire's
    peak."""
    w = {"f32": 4, "bf16": 2, "int8": 1}[wire]
    scales = (B + n_items) * 4 if wire == "int8" else 0
    nbytes = B * r * w + n_items * r * w + scales + B * 4 + B * k * 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * B * n_items * r / PEAK_OPS[wire] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def verify_topk(tag, s, i, ps, U64, V64, idx, rtol):
    """Kernel (s, i) against the plain version's scores ``ps``; U64/V64
    are float64 copies of the dequantized tables on the card. Returns the
    largest score difference."""
    tol = rtol * (1.0 + ps.abs())
    err = (s - ps).abs()
    check(bool((err <= tol).all()),
          f"{tag}: scores off the plain version by {err.max().item():.3e}")
    own = torch.einsum("br,bkr->bk", U64[idx.long()], V64[i.long()])
    own_err = (own - s.double()).abs()
    check(bool((own_err <= tol.double()).all()),
          f"{tag}: a returned id does not score what was returned beside "
          f"it (off by {own_err.max().item():.3e})")
    srt = torch.sort(i.long(), dim=1).values
    check(bool((srt[:, 1:] != srt[:, :-1]).all()),
          f"{tag}: an id appears twice in one row")
    return err.max().item()


def phase_card() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs the card")
    from predictionio_tpu_torch.utils.device import card_info

    info = card_info()
    print(info["nvidia_smi"], flush=True)
    print(f"phase card: {info['name']} power_limit={info['power_limit']} "
          f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)
    # the plain versions are held to full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return info


def phase_build() -> None:
    from predictionio_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build(_build.all_sources())
    dt = time.perf_counter() - t0
    regs = [ln.strip() for log in logs.values() for ln in log.splitlines()
            if "Used" in ln or "spill" in ln]
    print(f"phase build: {len(logs)} source(s) {sorted(logs)} in "
          f"{dt:.2f}s; " + " | ".join(regs), flush=True)


def make_tables(seed: int):
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((N_USERS, RANK), dtype=np.float32)
    V = rng.standard_normal((N_ITEMS, RANK), dtype=np.float32)
    return rng, U, V


def phase_kernel(rng, U, V, dev) -> dict:
    from predictionio_tpu_torch.models.als import _quantize_rows
    from predictionio_tpu_torch.ops.fused_topk import (
        fused_topk,
        fused_topk_reference,
        topk_plan,
    )

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    Ud, Vd = torch.from_numpy(U).to(dev), torch.from_numpy(V).to(dev)
    qU, qus = _quantize_rows(U, "int8")
    qV, qvs = _quantize_rows(V, "int8")
    wires = {
        "f32": (Ud, Vd, None, None),
        "bf16": (Ud.bfloat16(), Vd.bfloat16(), None, None),
        "int8": (qU.to(dev), qV.to(dev), qus.to(dev), qvs.to(dev)),
    }
    row = {}
    for rank in (RANK, 10):
        for wire, full in wires.items():
            ut, vt = (t[:, :rank].contiguous() for t in full[:2])
            us, vs = full[2:]
            U64 = ut.double() * (us.double() if us is not None else 1.0)
            V64 = vt.double() * (vs.double() if vs is not None else 1.0)
            for B in (1, 8, 37, 64, BATCH) if rank == RANK else (8, BATCH):
                idx = torch.from_numpy(
                    rng.integers(0, N_USERS, B).astype(np.int32)).to(dev)
                for k in (16, 128) if rank == RANK else (16,):
                    def call():
                        return fused_topk(ut, idx, vt, us, vs, k=k,
                                          n_items=N_ITEMS)

                    s, i = call()
                    torch.cuda.synchronize()
                    ps, pi = fused_topk_reference(ut, idx, vt, us, vs, k=k,
                                                  n_items=N_ITEMS)
                    tag = f"{wire} r={rank} B={B} k={k}"
                    err = verify_topk(tag, s, i, ps, U64, V64, idx,
                                      RTOL[wire])
                    diff = int((i != pi).sum().item())
                    plan = topk_plan(B, N_ITEMS, rank, vt.element_size(), k,
                                     n_sm, vt.data_ptr() % 16 == 0)
                    check(plan.vec16 == (rank * vt.element_size() % 16 == 0),
                          f"{tag}: staging branch {plan.staging}")
                    check(B > 64 or -(-B // plan.qb) * plan.splits >= n_sm,
                          f"{tag}: {plan.splits} splits leave SMs idle")
                    ms = median_ms(call, 10)
                    dev_ms = queued_ms(call, 20)
                    scan_ms, merge_ms = kernel_ms(
                        call, 5, ("fused_topk_kernel", "merge_topk_kernel"))
                    plain_ms = median_ms(lambda: fused_topk_reference(
                        ut, idx, vt, us, vs, k=k, n_items=N_ITEMS), 3)
                    uq, vq = U64[idx.long()].float(), V64.float()
                    lib_ms = median_ms(
                        lambda: torch.topk(torch.matmul(uq, vq.T), k), 5)
                    b_ms, b_by = bound(wire, B, k, N_ITEMS, rank)
                    print(f"phase kernel: fused_topk {tag} "
                          f"splits={plan.splits} queries_per_block={plan.qb} "
                          f"staging={plan.staging} "
                          f"max_abs_err={err:.3e} ids_differing={diff} "
                          f"ms={ms:.4f} queued_ms={dev_ms:.4f} "
                          f"scan_ms={scan_ms:.4f} merge_ms={merge_ms:.4f} "
                          f"plain_ms={plain_ms:.4f} "
                          f"library_ms={lib_ms:.4f} bound_ms={b_ms:.5f} "
                          f"bound_by={b_by}", flush=True)
                    if (wire, rank, B, k) == ("int8", RANK, BATCH, 16):
                        # the shape the serving path's batch sweep gives it
                        row = {"max_abs_err": err, "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "library_ms": lib_ms}
                    if (wire, rank, B, k) == ("int8", RANK, 1, 16):
                        check(plan.splits >= n_sm, f"{tag}: {plan.splits} "
                              f"splits at B = 1 on {n_sm} SMs")

    # base != 0: ids offset by base, items at or past n_items masked
    ut, vt = wires["f32"][:2]
    base = 5000
    idx = torch.from_numpy(rng.integers(0, N_USERS, 37).astype(np.int32)
                           ).to(dev)
    s, i = fused_topk(ut, idx, vt, base=base, k=64, n_items=N_ITEMS)
    ps, pi = fused_topk_reference(ut, idx, vt, base=base, k=64,
                                  n_items=N_ITEMS)
    torch.cuda.synchronize()
    check(bool((i >= base).all() and (i < N_ITEMS).all()),
          "base case: ids outside [base, n_items)")
    err = verify_topk("base case", s, i - base, ps, ut.double(),
                      vt.double(), idx, RTOL["f32"])
    print(f"phase kernel: base={base} k=64 max_abs_err={err:.3e} "
          f"ids_differing={int((i != pi).sum().item())}", flush=True)

    # exact ties: integer-valued factors make every product exact, so
    # ranks are decided by the id order alone
    tie_rng = np.random.default_rng(7)
    Ui = tie_rng.integers(-2, 3, (4096, RANK)).astype(np.float32)
    Vi = tie_rng.integers(-2, 3, (N_ITEMS, RANK)).astype(np.float32)
    idx = torch.from_numpy(tie_rng.integers(0, 4096, 64).astype(np.int32)
                           ).to(dev)
    for wire, cast in (("f32", torch.float32), ("bf16", torch.bfloat16),
                       ("int8", torch.int8)):
        ut = torch.from_numpy(Ui).to(dev).to(cast)
        vt = torch.from_numpy(Vi).to(dev).to(cast)
        for k in (16, 128):
            s, i = fused_topk(ut, idx, vt, k=k, n_items=N_ITEMS - 3)
            ps, pi = fused_topk_reference(ut, idx, vt, k=k,
                                          n_items=N_ITEMS - 3)
            torch.cuda.synchronize()
            check(torch.equal(i, pi) and torch.equal(s, ps),
                  f"tie case {wire} k={k}: ids or scores not exact")
    print("phase kernel: integer-valued tie case exact on f32/bf16/int8 "
          "k=16,128", flush=True)

    try:
        fused_topk(ut, idx, vt, k=129, n_items=N_ITEMS)
    except ValueError:
        pass
    else:
        fail("k=129 did not raise")
    return row


#: loopback only: no proxy from the environment may carry these requests
_LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _post(port: int, body) -> tuple:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with _LOCAL.open(req, timeout=60) as resp:
        out = json.loads(resp.read())
    return out, time.perf_counter() - t0


def check_answer(query, answer, ud, us, vd, vs, U64, V64, n_items,
                 dev, user_ids=None, item_ids=None) -> None:
    """An answer agrees with the plain version on the bound tables.
    Without id maps, "u<n>" and "i<n>" name rows n."""
    from predictionio_tpu_torch.models.als import _compiled_k
    from predictionio_tpu_torch.ops.fused_topk import fused_topk_reference

    def row(ids, name):
        return ids[name] if ids is not None else int(name[1:])

    got = answer["itemScores"]
    uidx = row(user_ids, query["user"])
    black = {row(item_ids, b) for b in query.get("blackList", [])}
    kk = _compiled_k(query["num"] + len(black), n_items)
    idx = torch.tensor([uidx], dtype=torch.int32, device=dev)
    ps, pi = fused_topk_reference(ud, idx, vd, us, vs, k=kk,
                                  n_items=n_items)
    keep = [j for j, it in enumerate(pi[0].tolist()) if it not in black]
    want = ps[0, keep][: query["num"]].double()
    check(len(got) == len(want), f"{query}: {len(got)} items returned")
    ids = torch.tensor([row(item_ids, g["item"]) for g in got], device=dev)
    s = torch.tensor([g["score"] for g in got], dtype=torch.float64,
                     device=dev)
    tol = RTOL["int8"] * (1 + want.abs())
    check(bool(((s - want).abs() <= tol).all()),
          f"{query}: scores off the plain version")
    own = (U64[uidx][None, :] * V64[ids]).sum(1)
    check(bool(((own - s).abs() <= tol).all()),
          f"{query}: an item does not score what was returned")
    check(not (set(ids.tolist()) & black), f"{query}: blacklisted item")


#: the burst: queries, and the concurrent connections that send them
BURST_QUERIES, BURST_CLIENTS = 2048, 32
#: the batch path of each burst run, in order, on one bound model
BURST_MODES = ("staged", "serial", "staged")
#: a last staged burst with the server process's interpreter switch
#: interval cut from Python's 5 ms to this: how much of a batch's time
#: under load is waiting for the interpreter lock
DIAG_SWITCH_INTERVAL_S = 0.0005


def burst_clients(port: int, queries: list, n_clients: int,
                  traceparents=None, keep=()) -> tuple:
    """The burst's load generator, run in a process of its own (standard
    library only, so it shares no interpreter lock with the server):
    ``n_clients`` connections, each posting its share of ``queries`` one
    after another, query ``j`` with the ``traceparent`` header
    ``traceparents[j]`` where that is given and not None. Returns
    ``(wall_s, [(status, body, seconds, response traceparent, *the
    response headers named in keep), ...] in query order, [errors])``."""
    import http.client

    results = [None] * len(queries)
    errors = []
    gate = threading.Barrier(n_clients + 1)

    def client(w: int) -> None:
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            gate.wait(timeout=60)
            for j in range(w, len(queries), n_clients):
                headers = {"Content-Type": "application/json"}
                if traceparents and traceparents[j]:
                    headers["traceparent"] = traceparents[j]
                t0 = time.perf_counter()
                c.request("POST", "/queries.json", json.dumps(queries[j]),
                          headers)
                resp = c.getresponse()
                body = resp.read().decode()
                results[j] = (resp.status, body, time.perf_counter() - t0,
                              resp.getheader("traceparent"),
                              *[resp.getheader(h) for h in keep])
        except Exception as e:  # noqa: BLE001 — reported to the parent
            errors.append(f"client {w}: {e!r}")
        finally:
            c.close()

    threads = [threading.Thread(target=client, args=(w,))
               for w in range(n_clients)]
    for t in threads:
        t.start()
    gate.wait(timeout=60)
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, results, errors


#: the burst's client process: ``burst_clients`` alone, its arguments
#: read as JSON from standard input and its result written as JSON to
#: standard output (no torch, no multiprocessing helper process)
BURST_MAIN = """\
import json, sys, threading, time
{source}
json.dump(burst_clients(**json.load(sys.stdin)), sys.stdout)
"""


def start_burst(port: int, queries: list, traceparents=None,
                keep=()) -> subprocess.Popen:
    """``burst_clients`` in a process of its own, not waited for."""
    src = BURST_MAIN.format(source=inspect.getsource(burst_clients))
    with tempfile.TemporaryFile("w+") as args:
        json.dump(dict(port=port, queries=queries, n_clients=BURST_CLIENTS,
                       traceparents=traceparents, keep=keep), args)
        args.seek(0)
        return subprocess.Popen([sys.executable, "-c", src], stdin=args,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)


def finish_burst(proc: subprocess.Popen, tag: str = "burst") -> tuple:
    """Wait for a burst started by :func:`start_burst`, whatever happens:
    ``(wall_s, [(answer, seconds, traceparent, *kept headers)])``; fails
    on any client error or non-200 answer."""
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        out, err = None, "no answer in 300 s"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    check(out is not None and proc.returncode == 0,
          f"{tag}: the client process failed (exit {proc.returncode}): "
          f"{(err or '')[-500:]}")
    wall, results, errors = json.loads(out)
    check(not errors, f"{tag}: clients failed: {errors[:3]}")
    check(all(r is not None for r in results), f"{tag}: a query got no "
          f"answer")
    bad = [r[:2] for r in results if r[0] != 200]
    check(not bad, f"{tag}: {len(bad)} queries failed: {bad[:3]}")
    return wall, [(json.loads(r[1]), r[2], *r[3:]) for r in results]


def run_burst(port: int, queries: list, traceparents=None) -> tuple:
    """The burst from another process, waited for whatever happens;
    ``(wall_s, [(answer, seconds)])``, and with ``traceparents`` (one
    header or None a query) also each answer's ``traceparent``."""
    wall, res = finish_burst(start_burst(port, queries, traceparents))
    answers = [(r[0], r[1]) for r in res]
    if traceparents is None:
        return wall, answers
    return wall, answers, [r[2] for r in res]


def check_burst(queries, answers, ud, us, vd, vs, U64, V64, dev) -> None:
    """Every burst answer (num 10, no blacklist) against the plain top-k
    of its own user on the bound tables, in one batch: the scores, each
    returned item's own score in float64, no item twice. An answer meant
    for another user, or lost, cannot pass."""
    from predictionio_tpu_torch.ops.fused_topk import fused_topk_reference

    users = np.array([int(q["user"][1:]) for q in queries])
    check(all(len(a["itemScores"]) == 10 for a in answers),
          "a burst answer has not 10 items")
    idx = torch.from_numpy(users.astype(np.int32)).to(dev)
    ps, _ = fused_topk_reference(ud, idx, vd, us, vs, k=16,
                                 n_items=N_ITEMS)
    want = ps[:, :10].double()
    got_i = torch.tensor([[int(s["item"][1:]) for s in a["itemScores"]]
                          for a in answers], device=dev)
    got_s = torch.tensor([[s["score"] for s in a["itemScores"]]
                          for a in answers], dtype=torch.float64,
                         device=dev)
    tol = RTOL["int8"] * (1 + want.abs())
    check(bool(((got_s - want).abs() <= tol).all()),
          "burst: scores off the plain version")
    own = torch.einsum("br,bkr->bk", U64[idx.long()], V64[got_i])
    check(bool(((own - got_s).abs() <= tol).all()),
          "burst: an item does not score what was returned")
    srt = torch.sort(got_i, dim=1).values
    check(bool((srt[:, 1:] != srt[:, :-1]).all()),
          "burst: an item appears twice in one answer")


def burst_run(mode, engine, ep, bound_model, burst, tables, dev,
              switch_interval=None) -> dict:
    """One burst on a server of its own over the same bound tables, its
    batch path ``mode``; every answer checked. ``switch_interval`` sets
    this process's interpreter switch interval for the burst."""
    from predictionio_tpu_torch.models.als import _table_leaves
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.server.engineserver import (
        ServerConfig,
        deploy_models,
    )

    srv = deploy_models(engine, ep, [bound_model],
                        ServerConfig(batching=True, serving_quant="int8",
                                     serving_pipeline=mode),
                        host="127.0.0.1", port=0).start_background()
    try:
        warmed(srv)
        qs = srv.query_server
        check(_table_leaves(qs.models[0].item_factors)[0].data_ptr()
              == tables[2].data_ptr(),
              "the burst server did not bind the same tables")
        # the launch call of each batch, timed on its own thread: wall
        # against the thread's CPU time (the rest is waiting: for the
        # interpreter lock or inside a blocking call)
        algo = qs.algorithms[0]
        launch_call = algo.batch_predict_async
        spent = {"wall": 0.0, "cpu": 0.0}
        spent_lock = threading.Lock()

        def timed_launch(*a, **k):
            w0, c0 = time.perf_counter(), time.thread_time()
            try:
                return launch_call(*a, **k)
            finally:
                dw = time.perf_counter() - w0
                dc = time.thread_time() - c0
                with spent_lock:
                    spent["wall"] += dw
                    spent["cpu"] += dc

        algo.batch_predict_async = timed_launch
        before = ft.LAUNCHES
        default_interval = sys.getswitchinterval()
        if switch_interval is not None:
            sys.setswitchinterval(switch_interval)
        try:
            wall, results = run_burst(srv.port, burst)
        finally:
            sys.setswitchinterval(default_interval)
        launches = ft.LAUNCHES - before
        with _LOCAL.open(f"http://127.0.0.1:{srv.port}/status.json",
                         timeout=30) as resp:
            pipe = json.loads(resp.read())["pipeline"]
        phases, stages = dict(qs.phase_seconds), dict(qs.stage_seconds)
        batches, served = qs.batches_served, qs.queries_batched
    finally:
        srv.close()
    check_burst(burst, [a for a, _ in results], *tables, dev)
    check(pipe["mode"] == mode, f"/status.json pipeline mode {pipe['mode']}")
    check(launches > 0, f"the {mode} burst launched fused_topk no time")
    check(pipe["deadlineExceeded"] == 0,
          f"{pipe['deadlineExceeded']} burst queries shed at the deadline")
    ov = pipe["overlap"]
    if mode == "staged":
        check(ov["overlappedDispatches"] > 0,
              "staged burst: no batch launched while another was in flight")
    lat = np.array([t for _, t in results]) * 1e3
    per = {k: v / max(batches, 1) * 1e3 for k, v in phases.items()}
    st = {k: v / max(batches, 1) * 1e3 for k, v in stages.items()}
    label = mode if switch_interval is None else (
        f"{mode} switch_interval_ms={switch_interval * 1e3:g}")
    print(f"phase slice burst {label}: {len(burst)} queries x "
          f"{BURST_CLIENTS} connections from another process "
          f"qps={len(burst) / wall:.1f} p50_ms={np.percentile(lat, 50):.3f} "
          f"p99_ms={np.percentile(lat, 99):.3f} fused_topk launches="
          f"{launches} mean_batch={len(burst) / max(launches, 1):.2f} "
          f"(server: {served} queries in {batches} batches) | pipeline "
          f"depth={pipe.get('depth')} deadlineExceeded="
          f"{pipe['deadlineExceeded']} overlappedDispatches="
          f"{ov['overlappedDispatches']} deviceIdleFraction="
          f"{ov['deviceIdleFraction']} overlapFraction="
          f"{ov['overlapFraction']} wallSec={ov['wallSec']} | phase ms a "
          f"batch: " + " ".join(f"{k}={v:.4f}" for k, v in per.items())
          + (" | stage ms a batch: " + " ".join(
              f"{k}={v:.4f}" for k, v in st.items()) if st else "")
          + f" | launch call ms a batch: wall="
            f"{spent['wall'] / max(batches, 1) * 1e3:.4f} thread_cpu="
            f"{spent['cpu'] / max(batches, 1) * 1e3:.4f}",
          flush=True)
    return {"launches": launches, "qps": len(burst) / wall}


def readback_ms(bound_model, users, reps: int) -> tuple:
    """Host ms from the second of two launches of ``len(users)`` queries
    to the first one's results on the host, median of ``reps``: (the
    port's resolver, which queued its copies behind its own launch; the
    same launch read back by copies made when resolving, which queue
    behind the second launch)."""
    from predictionio_tpu_torch.models.als import (
        _compiled_k,
        _device_topk,
        recommend_batch_async,
    )

    m = bound_model
    k_dev = _compiled_k(10, m.n_items)
    half = len(users) // 2

    def at_resolve(u):
        s, i = _device_topk(m.user_factors, m.item_factors, u, k_dev,
                            m.n_items)
        done = torch.cuda.Event()
        done.record()

        def resolve():
            done.synchronize()
            return i[:, :10].cpu().numpy(), s[:, :10].cpu().numpy()

        return resolve

    out = []
    for dispatch in (lambda u: recommend_batch_async(m, u, 10), at_resolve):
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            first = dispatch(users[:half])
            second = dispatch(users[half:])
            t0 = time.perf_counter()
            first()
            times.append((time.perf_counter() - t0) * 1e3)
            second()
        out.append(float(np.median(times[1:])))
    return tuple(out)


def phase_slice(rng, U, V, dev) -> int:
    from predictionio_tpu_torch.models.als import (
        _table_leaves,
        recommend_batch,
        recommend_batch_async,
    )
    from predictionio_tpu_torch.models.convert import als_model_from_numpy
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.server.engineserver import (
        ServerConfig,
        deploy_models,
    )
    from predictionio_tpu_torch.templates.recommendation import (
        recommendation_engine,
    )

    users = [f"u{i}" for i in range(N_USERS)]
    items = [f"i{j}" for j in range(N_ITEMS)]
    model = als_model_from_numpy(
        U, V, N_USERS, N_ITEMS, {u: n for n, u in enumerate(users)},
        {it: n for n, it in enumerate(items)}, {"rank": RANK},
        device="cpu")
    engine = recommendation_engine()
    ep = engine.params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": RANK}}]})
    t0 = time.perf_counter()
    srv = deploy_models(engine, ep, [model],
                 ServerConfig(batching=True, serving_quant="int8"),
                 host="127.0.0.1", port=0)
    srv.start_background()
    bind_s = time.perf_counter() - t0
    warmed(srv)
    bound_model = srv.query_server.models[0]
    ud, us = _table_leaves(bound_model.user_factors)
    vd, vs = _table_leaves(bound_model.item_factors)
    check(vd.is_cuda and vd.dtype == torch.int8,
          "deploy did not place int8 tables on the card")
    U64 = ud.double() * us.double()
    V64 = vd.double() * vs.double()
    tables = (ud, us, vd, vs, U64, V64)

    def expect_ok(query, answer):
        check_answer(query, answer, ud, us, vd, vs, U64, V64, N_ITEMS, dev)

    queries = [{"user": f"u{u}", "num": 10}
               for u in rng.integers(0, N_USERS, 64)]
    queries[0]["blackList"] = ["i1", "i2", "i3"]
    burst = [{"user": f"u{u}", "num": 10}
             for u in rng.integers(0, N_USERS, BURST_QUERIES)]
    batch_users = rng.integers(0, N_USERS, BATCH)

    # -- the serving path, counted ------------------------------------
    ft.LAUNCHES = 0
    single = [_post(srv.port, q) for q in queries]
    runs = [burst_run(mode, engine, ep, bound_model, burst, tables, dev)
            for mode in BURST_MODES]
    diag = burst_run("staged", engine, ep, bound_model, burst, tables, dev,
                     switch_interval=DIAG_SWITCH_INTERVAL_S)
    unknown, _ = _post(srv.port, {"user": "nobody", "num": 10})
    t_batch = time.perf_counter()
    ids, scores = recommend_batch(bound_model, batch_users, 10)
    batch_s = time.perf_counter() - t_batch
    launches = ft.LAUNCHES
    # ------------------------------------------------------------------

    check(launches > 0, "the serving path launched fused_topk no time")
    for q, (a, _) in zip(queries, single):
        expect_ok(q, a)
    check(unknown == {"itemScores": []}, "unknown user got items")
    check(ids.shape == (BATCH, 10) and np.isfinite(scores).all(),
          "recommend_batch: wrong shape or non-finite scores")
    idx = torch.from_numpy(batch_users.astype(np.int32)).to(dev)
    ps, _ = ft.fused_topk_reference(ud, idx, vd, us, vs, k=16,
                                    n_items=N_ITEMS)
    want = ps[:, :10].cpu().numpy()
    check(bool((np.abs(scores - want) <= RTOL["int8"]
                * (1 + np.abs(want))).all()),
          "recommend_batch: scores off the plain version")
    with _LOCAL.open(f"http://127.0.0.1:{srv.port}/status.json",
                     timeout=30) as resp:
        status = json.loads(resp.read())
    check(status["card"] == torch.cuda.get_device_name(0),
          f"/status.json names {status['card']!r}")
    check(status["servingQuant"] == "int8",
          f"/status.json serves quant {status['servingQuant']!r}")
    check(status["kernels"]["fused_topk"]["launches"] >= launches,
          "/status.json launch count")

    # the dispatch half never waits on the card: PyTorch raises on any
    # synchronizing call made while the mode is "error"
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = recommend_batch_async(bound_model, batch_users, 10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ids2, _ = handle()
    check(np.array_equal(ids2, ids), "recommend_batch_async's resolver "
          "disagrees with recommend_batch")
    pinned_ms, at_resolve_ms = readback_ms(bound_model, batch_users, 20)

    # layers below HTTP, after the counted run: one query through the
    # bound QueryServer in-process (template, JSON, no HTTP or batcher),
    # and the model call alone (gather, kernel, readback)
    from predictionio_tpu_torch.models.als import recommend_products

    def host_ms(fn, arg_list):
        out = []
        for a in arg_list:
            t0 = time.perf_counter()
            fn(a)
            out.append((time.perf_counter() - t0) * 1e3)
        return np.percentile(out, 50)

    inproc_ms = host_ms(srv.query_server.query, queries)
    model_ms = host_ms(lambda q: recommend_products(
        bound_model, int(q["user"][1:]), 10), queries)
    srv.close()

    lat1 = np.array([t for _, t in single]) * 1e3
    print(f"phase slice: bind_s={bind_s:.3f} single p50_ms="
          f"{np.percentile(lat1, 50):.3f} p99_ms={np.percentile(lat1, 99):.3f}"
          f" | bursts " + " ".join(f"{m}={r['qps']:.1f}qps"
                                   for m, r in zip(BURST_MODES, runs))
          + f" staged@switch_interval_ms="
            f"{DIAG_SWITCH_INTERVAL_S * 1e3:g}={diag['qps']:.1f}qps"
          + f" | recommend_batch B={BATCH} s={batch_s:.4f} | fused_topk "
          f"launches={launches} | readback of a {BATCH // 2}-query launch "
          f"with a second queued behind it: copies queued at dispatch "
          f"{pinned_ms:.3f} ms, copies made at resolve {at_resolve_ms:.3f}"
          f" ms (median of 20)", flush=True)
    print(f"phase slice layers: single query p50_ms over HTTP+batcher="
          f"{np.percentile(lat1, 50):.3f} in-process QueryServer.query="
          f"{inproc_ms:.3f} recommend_products={model_ms:.3f}", flush=True)
    return launches

# -- telemetry --------------------------------------------------------------

#: the profiler window of the telemetry phase, and how far the card-memory
#: gauge may read from ``torch.cuda.memory_allocated()`` beside it
TELEMETRY_PROFILE_MS = 2000.0
#: armed for phase 4b's first burst (``benchmarks/trace_smoke.py``'s
#: spec): one dispatch delayed, so its traces are kept as exemplars
TELEMETRY_FAULT = "serving.dispatch=latency,delay_ms=400,times=1"
HBM_SLACK_BYTES = 64 << 20
#: events of the traced event-server ingest (one webhook, one batch)
TELEMETRY_BATCH_EVENTS = 40

#: one exposition sample: name, {labels} (quoted values may hold any
#: escaped character), value, and an OpenMetrics exemplar's trace id
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(\{(?:[^"}]|"(?:[^"\\]|\\.)*")*\})? (\S+)'
    r'(?: # \{trace_id="([0-9a-f]+)"\} \S+ \S+)?$')


def scrape(port: int, openmetrics: bool = False) -> str:
    headers = ({"Accept": "application/openmetrics-text"} if openmetrics
               else {})
    req = urllib.request.Request(f"http://127.0.0.1:{port}/metrics",
                                 headers=headers)
    with _LOCAL.open(req, timeout=60) as resp:
        return resp.read().decode()


def parse_exposition(text: str, openmetrics: bool = False) -> tuple:
    """A ``/metrics`` body as ``{name: {labels: value}}`` and the trace
    ids of its exemplars; fails on a line the format does not allow."""
    lines = text.splitlines()
    if openmetrics:
        check(bool(lines) and lines[-1] == "# EOF",
              "the OpenMetrics exposition does not end with # EOF")
        lines = lines[:-1]
    samples, exemplars = {}, []
    for ln in lines:
        if ln.startswith(("# HELP ", "# TYPE ")):
            continue
        m = _SAMPLE_RE.match(ln)
        check(m is not None, f"a /metrics line does not parse: {ln!r}")
        name, labels, value, trace_id = m.groups()
        check(openmetrics or trace_id is None,
              f"an exemplar in the text format: {ln!r}")
        samples.setdefault(name, {})[labels or ""] = float(value)
        if trace_id:
            exemplars.append(trace_id)
    return samples, exemplars


def http_status(port: int, method: str, path: str, body=None,
                headers=None) -> tuple:
    """``(status, JSON body, response headers)``, error statuses too."""
    data = json.dumps(body).encode() if body is not None else (
        b"" if method == "POST" else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method,
                                 headers=headers or {})
    try:
        resp = _LOCAL.open(req, timeout=60)
    except urllib.error.HTTPError as e:
        resp = e
    with resp:
        return resp.status, json.loads(resp.read() or b"null"), \
            dict(resp.headers)


def burst_latency(results) -> tuple:
    lat = np.array([t for _, t in results]) * 1e3
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))


def compute_pids() -> list:
    """The pids ``nvidia-smi`` lists as holding a CUDA context."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi: {out.stderr[-500:]}")
    return [int(t) for t in out.stdout.split() if t.strip().isdigit()]


def profiled_kernels(trace_path: Path) -> dict:
    """``{kernel name: [launches, device ms]}`` from a capture's
    ``trace.json`` (the chrome trace's ``kernel`` events)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out: dict = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            row = out.setdefault(ev["name"], [0, 0.0])
            row[0] += 1
            row[1] += float(ev.get("dur", 0.0)) / 1e3
    return out


def telemetry_eventserver(work: Path, card: dict) -> None:
    """``cli eventserver --stats`` as a process of its own: a segment.io
    webhook and a block of events, counted on ``/stats.json`` and by
    route on ``/metrics``; after the scrape the process holds no CUDA
    context (``nvidia-smi``); SIGINT ends it with exit 0."""
    from predictionio_tpu_torch.data.storage.base import AccessKey, App
    from predictionio_tpu_torch.data.storage.registry import Storage

    root = Path(__file__).resolve().parent
    home = work / "eventserver"
    home.mkdir()
    storage = Storage(env={"PIO_HOME": str(home)})
    app_id = storage.apps().insert(App(0, "TeleApp", None))
    storage.events().init(app_id)
    storage.access_keys().insert(AccessKey("TELEKEY", app_id, ()))
    storage.close()
    env = dict(os.environ, PIO_HOME=str(home), PYTHONPATH=os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH", "")) if p))
    log = work / "eventserver.log"
    # nvidia-smi may list pids of another namespace than this script's:
    # the count of contexts must not grow either
    contexts = compute_pids()
    t0 = time.perf_counter()
    proc = cli_process(["eventserver", "--stats", "--ip", "127.0.0.1",
                        "--port", "0"], env, log)
    try:
        port = None
        while port is None:
            check(proc.poll() is None and time.perf_counter() - t0 < 120,
                  f"cli eventserver did not start: {log.read_text()[-2000:]}")
            for line in log.read_text().splitlines():
                if " is listening at http://" in line:
                    port = int(line.rsplit(":", 1)[1].rstrip("."))
            time.sleep(0.01)
        start_s = time.perf_counter() - t0
        k = "?accessKey=TELEKEY"
        status, body, _ = http_status(port, "POST",
                                      f"/webhooks/segmentio.json{k}", {
                                          "type": "track", "version": "2",
                                          "user_id": "u1", "event": "signup",
                                          "properties": {"plan": "pro"}})
        check(status == 201, f"segment.io webhook: {status} {body}")
        # no target entity, as the webhook's event: /stats.json (in both
        # packages) fails on an app whose counts mix a target type and
        # none (ROADMAP.md queue 3)
        block = [{"event": "signup" if n % 2 else "visit",
                  "entityType": "user", "entityId": f"u{n % 7}",
                  "properties": {"plan": "pro"}}
                 for n in range(TELEMETRY_BATCH_EVENTS)]
        status, body, _ = http_status(port, "POST",
                                      f"/batch/events.json{k}", block)
        check(status == 200 and all(r["status"] == 201 for r in body),
              f"batch ingest: {status} {body[:3]}")
        _, stats, _ = http_status(port, "GET", f"/stats.json{k}")
        n = TELEMETRY_BATCH_EVENTS + 1
        check(sum(b["value"] for b in stats["basic"]) == n
              and stats["statusCode"] == [{"key": 201, "value": n}],
              f"/stats.json: {stats}")
        t_scrape = time.perf_counter()
        samples, _ = parse_exposition(scrape(port))
        scrape_ms = (time.perf_counter() - t_scrape) * 1e3
        ingested = samples.get("pio_events_ingested_total", {})
        check(ingested == {'{route="batch"}': TELEMETRY_BATCH_EVENTS,
                           '{route="webhook"}': 1.0},
              f"pio_events_ingested_total: {ingested}")
        check(samples["pio_stats_enabled"][""] == 1.0, "pio_stats_enabled")
        check("pio_device_hbm_bytes" not in samples,
              "the event server reports the card's memory")
        pids = compute_pids()
        check(proc.pid not in pids and len(pids) == len(contexts),
              f"the event server (pid {proc.pid}) holds a CUDA context "
              f"after a scrape: {contexts} -> {pids}")
        proc.send_signal(signal.SIGINT)
        rc = end_process(proc, 60)
        check(rc == 0, f"cli eventserver exited {rc}: "
              f"{log.read_text()[-1000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    print(f"phase telemetry eventserver: cli eventserver --stats up in "
          f"{start_s:.3f}s, 1 segment.io webhook + {TELEMETRY_BATCH_EVENTS} "
          f"batch events counted on /stats.json and pio_events_ingested_total"
          f" by route, /metrics scrape {scrape_ms:.3f} ms | compute pids "
          f"before the process {contexts}, after its scrape {pids} (this "
          f"script {os.getpid()}"
          f"{' listed' if os.getpid() in pids else ' not listed'}), the "
          f"event server {proc.pid} not listed | exit on SIGINT 0 | "
          f"{card_tag(card)}", flush=True)


def phase_telemetry(rng, U, V, dev, card) -> dict:
    """Observability on the card, over phase 4's tables (see the module's
    docstring, phase 4b). Returns each kernel's launches in the counted
    bursts."""
    from predictionio_tpu_torch.models.als import _table_leaves
    from predictionio_tpu_torch.models.convert import als_model_from_numpy
    from predictionio_tpu_torch.faults import inject_spec
    from predictionio_tpu_torch.faults import registry as fault_registry
    from predictionio_tpu_torch.obs import numerics
    from predictionio_tpu_torch.obs.trace import parse_traceparent
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.server.engineserver import (
        ServerConfig,
        deploy_models,
    )
    from predictionio_tpu_torch.templates.recommendation import (
        recommendation_engine,
    )

    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="telemetry_", dir=scratch))
    model = als_model_from_numpy(
        U, V, N_USERS, N_ITEMS, {f"u{n}": n for n in range(N_USERS)},
        {f"i{n}": n for n in range(N_ITEMS)}, {"rank": RANK}, device="cpu")
    engine = recommendation_engine()
    ep = engine.params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": RANK}}]})
    burst = [{"user": f"u{u}", "num": 10}
             for u in rng.integers(0, N_USERS, BURST_QUERIES)]
    burst2 = [{"user": f"u{u}", "num": 10}
              for u in rng.integers(0, N_USERS, BURST_QUERIES)]
    sent = [f"00-{rng.bytes(16).hex()}-{rng.bytes(8).hex()}-01"
            if j % 2 else None for j in range(len(burst))]
    srv = deploy_models(engine, ep, [model], ServerConfig(
        batching=True, serving_quant="int8", debug_numerics=True,
        profile_dir=str(work / "profiles")),
        host="127.0.0.1", port=0).start_background()
    try:
        warmed(srv)
        port = srv.port
        bound = srv.query_server.models[0]
        ud, us = _table_leaves(bound.user_factors)
        vd, vs = _table_leaves(bound.item_factors)
        tables = (ud, us, vd, vs, ud.double() * us.double(),
                  vd.double() * vs.double())
        table_bytes = sum(t.numel() * t.element_size()
                          for t in (ud, us, vd, vs))
        before, _ = parse_exposition(scrape(port))
        key = '{entry="serve_topk"}'
        checks0 = before["pio_numerics_checks_total"].get(key, 0.0)

        # -- the main path, counted --------------------------------------
        zero_launch_counts()
        # one dispatch delayed 400 ms, as benchmarks/trace_smoke.py
        # does: the fault marks the traces of its batch, which the tail
        # sampler then keeps, so the burst has exemplars whatever the
        # adaptive p99 has seen
        inject_spec(TELEMETRY_FAULT)
        try:
            wall, results, got = run_burst(port, burst, sent)
        finally:
            fault_registry().clear("serving.dispatch")
        burst_launches = ft.LAUNCHES
        text = scrape(port)
        allocated = torch.cuda.memory_allocated(dev)
        om = scrape(port, openmetrics=True)
        status, info, _ = http_status(port, "POST", "/profile",
                                      {"durationMs": TELEMETRY_PROFILE_MS})
        check(status == 202, f"POST /profile: {status} {info}")
        busy, _, _ = http_status(port, "POST", "/profile",
                                 {"durationMs": 100})
        check(busy == 409, f"a second POST /profile answered {busy}")
        wall2, results2 = run_burst(port, burst2)
        counted = launch_counts()
        # ------------------------------------------------------------------

        check_burst(burst, [a for a, _ in results], *tables, dev)
        check_burst(burst2, [a for a, _ in results2], *tables, dev)
        check(counted["fused_topk"] > burst_launches > 0,
              f"the bursts launched fused_topk {counted['fused_topk']} "
              f"times ({burst_launches} in the first)")
        samples, _ = parse_exposition(text)
        om_samples, exemplars = parse_exposition(om, openmetrics=True)
        injected = sum(
            v for lab, v in samples.get("pio_fault_injections_total",
                                        {}).items()
            if 'point="serving.dispatch"' in lab and 'mode="latency"' in lab)
        check(injected == 1.0,
              f"pio_fault_injections_total reads {injected} for the one "
              f"serving.dispatch injection")
        print(f"phase telemetry: serving.dispatch fault "
              f"({TELEMETRY_FAULT}) injections on /metrics={injected:.0f}, "
              f"{len(exemplars)} exemplars after the burst", flush=True)
        n = len(burst)
        check(samples["pio_query_latency_seconds_count"][""] == n,
              f"pio_query_latency_seconds_count "
              f"{samples['pio_query_latency_seconds_count']} for {n} answers")
        check(samples["pio_batch_occupancy_sum"][""] == n,
              f"pio_batch_occupancy_sum {samples['pio_batch_occupancy_sum']}")
        checks = samples["pio_numerics_checks_total"][key] - checks0
        check(checks == burst_launches,
              f"{checks} serve_topk checks for {burst_launches} fused_topk "
              f"launches")
        check(not any(samples.get("pio_numerics_nonfinite_total",
                                  {}).values()), "a nonfinite score")
        hbm = {lab: v for lab, v in samples["pio_device_hbm_bytes"].items()
               if f'device="cuda:{dev.index}"' in lab}
        used = next(v for lab, v in hbm.items() if 'stat="used"' in lab)
        limit = next(v for lab, v in hbm.items() if 'stat="limit"' in lab)
        total = torch.cuda.get_device_properties(dev).total_memory
        check(used >= table_bytes, f"pio_device_hbm_bytes used {used:.0f} "
              f"below the bound tables' {table_bytes} bytes")
        check(abs(used - allocated) <= HBM_SLACK_BYTES,
              f"pio_device_hbm_bytes used {used:.0f} against "
              f"memory_allocated {allocated}")
        check(limit == total, f"pio_device_hbm_bytes limit {limit:.0f} "
              f"against total_memory {total}")
        check(set(om_samples) == set(samples) and bool(exemplars),
              f"the OpenMetrics exposition: samples "
              f"{sorted(set(om_samples) ^ set(samples))} differ, "
              f"{len(exemplars)} exemplars")
        resolved = [http_status(port, "GET", f"/trace.json?id={t}")[0]
                    for t in sorted(set(exemplars))]
        _, rec, _ = http_status(port, "GET", "/trace.json")
        missing = sum(s != 200 for s in resolved)
        check(missing <= rec["evicted"],
              f"{missing} exemplars name traces the ring never evicted")
        kept = [parse_traceparent(g)[0] == s.split("-")[1]
                for s, g in zip(sent, got) if s]
        check(all(kept), f"{kept.count(False)} queries sent with a "
              f"traceparent lost their trace id")
        _, slow, _ = http_status(port, "GET", "/trace.json?slowest=8")
        spans_seen = []
        for t in slow["traces"]:
            if t["name"] != "POST /queries.json":
                continue
            _, tr, _ = http_status(port, "GET",
                                   f"/trace.json?id={t['traceId']}")
            spans = {e["name"]: e["args"] for e in tr["traceEvents"][1:]}
            batch = spans.get("batch")
            check(batch is not None and all(
                spans.get(name, {}).get("parentId") == batch["spanId"]
                for name in ("dispatch", "device_wait", "readback")),
                f"trace {t['traceId']}: spans {sorted(spans)}")
            spans_seen.append(t["durationMs"])
        check(bool(spans_seen), "no /queries.json trace among the slowest")

        # the capture: wait for the window to end, then read its kernels
        deadline = time.perf_counter() + 120
        while True:
            _, prof, _ = http_status(port, "GET", "/profile.json")
            done = [h for h in prof["history"] if h["dir"] == info["dir"]]
            if done:
                break
            check(time.perf_counter() < deadline, "the capture never ended")
            time.sleep(0.05)
        check("error" not in done[0], f"the capture failed: {done[0]}")
        trace_path = Path(info["dir"]) / "trace.json"
        kernels = profiled_kernels(trace_path)
        scan = [v for k, v in kernels.items() if "fused_topk_kernel" in k]
        merge = [v for k, v in kernels.items() if "merge_topk_kernel" in k]
        check(bool(scan) and bool(merge) and all(
            c > 0 and ms > 0 for c, ms in scan + merge),
            f"the capture names no fused_topk scan and merge kernels with "
            f"device time: {sorted(kernels)[:12]}")
        # the scrapes before the burst's: their mean render time
        render_ms = (samples["pio_metrics_render_seconds_sum"][
            '{format="text"}'] / samples["pio_metrics_render_seconds_count"][
            '{format="text"}'] * 1e3)
        status_json = _http(port, "GET", "/status.json")[1]
        # what the telemetry costs: the first burst again, on a server
        # with tracing, hot keys and the sentinel off, in turns with this
        # one (off, on, off). The sentinel is process-wide: it is armed
        # for this server's bursts only
        numerics.disable()
        off = deploy_models(engine, ep, [model], ServerConfig(
            batching=True, serving_quant="int8", tracing=False,
            hot_keys_k=0), host="127.0.0.1", port=0).start_background()
        runs = {"on": [(wall, results)], "off": []}
        try:
            warmed(off)
            for arm in ("off", "on", "off"):
                if arm == "on":
                    numerics.enable()
                runs[arm].append(run_burst(
                    port if arm == "on" else off.port, burst, sent)[:2])
                numerics.disable()
        finally:
            off.close()
    finally:
        srv.close()
        numerics.disable()  # later phases run as they did without it
    for arm_runs in runs.values():
        for _, res in arm_runs:
            check_burst(burst, [a for a, _ in res], *tables, dev)
    telemetry_eventserver(work, card)
    shutil.rmtree(work, ignore_errors=True)

    def arm_line(arm: str) -> str:
        return " ".join(
            f"run {k + 1} qps={n / w:.1f} p50_ms={burst_latency(r)[0]:.3f} "
            f"p99_ms={burst_latency(r)[1]:.3f}"
            for k, (w, r) in enumerate(runs[arm]))

    qps = {arm: float(np.median([n / w for w, _ in runs[arm]]))
           for arm in runs}
    scan_n, scan_ms = (sum(c for c, _ in scan), sum(m for _, m in scan))
    merge_n, merge_ms = (sum(c for c, _ in merge), sum(m for _, m in merge))
    print(f"phase telemetry: burst of {n} queries x {BURST_CLIENTS} "
          f"connections, every other one with a traceparent, in turns on "
          f"two servers (on, off, on, off) | on (JAX defaults: tracing, "
          f"hot keys 128; debug_numerics): {arm_line('on')} | off "
          f"(tracing, hot keys and the sentinel off): {arm_line('off')} | "
          f"median qps on/off {qps['on'] / qps['off']:.4f} | "
          f"{card_tag(card)}", flush=True)
    print(f"phase telemetry metrics: pio_query_latency_seconds_count={n:.0f}"
          f" pio_batch_occupancy_sum={n:.0f} serve_topk checks={checks:.0f}"
          f" = fused_topk launches={burst_launches} | "
          f"pio_device_hbm_bytes used={used:.0f} (memory_allocated "
          f"{allocated}, bound tables {table_bytes}) limit={limit:.0f} | "
          f"{len(set(exemplars))} exemplars, {len(resolved) - missing} "
          f"resolve on /trace.json (ring {rec['retained']}/"
          f"{rec['ringCapacity']}, evicted {rec['evicted']}, slow threshold "
          f"{rec['slowThresholdMs']} ms) | {len(spans_seen)} of the 8 "
          f"slowest are queries with batch > dispatch, device_wait, "
          f"readback spans ({spans_seen[0]} ms the slowest) | "
          f"{sum(kept)} traceparents kept | /metrics text render "
          f"{render_ms:.4f} ms mean | hotKeys top "
          f"{status_json['hotKeys']['top'][:1]}", flush=True)
    print(f"phase telemetry profile: POST /profile durationMs="
          f"{TELEMETRY_PROFILE_MS:.0f} during a second burst "
          f"(qps={len(burst2) / wall2:.1f}), a second POST 409 | "
          f"trace.json {trace_path.name} "
          f"fused_topk_kernel launches={scan_n} device_ms={scan_ms:.3f} "
          f"merge_topk_kernel launches={merge_n} device_ms={merge_ms:.3f} | "
          f"{len(kernels)} kernel names in the window | {card_tag(card)}",
          flush=True)
    return counted


# -- the serving caches ------------------------------------------------------

#: phase cache: the skew of the burst's users (the JAX package's load
#: generator's Zipf, ``benchmarks/_loadgen.py::sample_entities``), the hot
#: tier's capacity and re-pin cadence (``ServerConfig``'s defaults), the
#: users the ingest and the fold-in touch, the pinned table of the kernel
#: check, and the re-pin a fold-in starts: how long it may take to land
CACHE_ZIPF = 1.5
CACHE_HOT, CACHE_REFRESH = 512, 256
CACHE_INGEST_USERS, CACHE_FOLD_USERS = 8, 4
CACHE_PIN_ROWS = 512
CACHE_KS = (8, 16, 32, 64, 128)
CACHE_SLOTS = (0, 1, 255, 511)
CACHE_REPIN_TIMEOUT_S = 60.0


class CacheLaunches:
    """Attributes each ``fused_topk`` launch of the cache phase to where it
    came from: ``models.als.fused_topk`` (the wrapper every serving
    dispatch calls) is wrapped to count a launch as a pinned serve while a
    wrapped ``ALSAlgorithm.predict_pinned`` runs on the calling thread,
    as the pin's k-ladder while a wrapped ``pin_hot_entities`` runs
    there (the hot tier's refresh thread), and as a full-table launch
    otherwise. The wrapper's own count is untouched: the three must sum
    to its delta. ``pinned_calls`` counts the pinned serves themselves."""

    def __init__(self):
        from predictionio_tpu_torch.models import als
        from predictionio_tpu_torch.templates import recommendation as rec

        self._als, self._algo = als, rec.ALSAlgorithm
        self._real_topk = als.fused_topk
        self._real_pin = rec.ALSAlgorithm.pin_hot_entities
        self._real_pinned = rec.ALSAlgorithm.predict_pinned
        self._local = threading.local()
        self._lock = threading.Lock()
        self.counts = {"pinned": 0, "ladder": 0, "full": 0}
        self.pinned_calls = 0

    def __enter__(self):
        local, lock = self._local, self._lock
        real_topk, real_pin, real_pinned = (self._real_topk, self._real_pin,
                                            self._real_pinned)

        def topk(*a, **kw):
            out = real_topk(*a, **kw)
            with lock:
                self.counts[getattr(local, "kind", "full")] += 1
            return out

        def tagged(kind, fn):
            def run(*a, **kw):
                local.kind = kind
                try:
                    return fn(*a, **kw)
                finally:
                    local.kind = "full"
            return run

        pinned = tagged("pinned", real_pinned)

        def predict_pinned(*a, **kw):
            with lock:
                self.pinned_calls += 1
            return pinned(*a, **kw)

        self._als.fused_topk = topk
        self._algo.pin_hot_entities = tagged("ladder", real_pin)
        self._algo.predict_pinned = predict_pinned
        return self

    def __exit__(self, *exc):
        self._als.fused_topk = self._real_topk
        self._algo.pin_hot_entities = self._real_pin
        self._algo.predict_pinned = self._real_pinned

    def take(self) -> dict:
        """The counts since the last take, and a reset."""
        with self._lock:
            out = dict(self.counts, calls=self.pinned_calls)
            self.counts = {"pinned": 0, "ladder": 0, "full": 0}
            self.pinned_calls = 0
        return out


def bound_tables(srv) -> tuple:
    """(ud, us, vd, vs, U64, V64) of an in-process server's bound int8
    model: what ``check_burst`` and ``check_answer`` hold answers to."""
    from predictionio_tpu_torch.models.als import _table_leaves

    bound = srv.query_server.models[0]
    ud, us = _table_leaves(bound.user_factors)
    vd, vs = _table_leaves(bound.item_factors)
    check(vd.is_cuda and vd.dtype == torch.int8,
          "the cache phase's deploy did not place int8 tables on the card")
    return ud, us, vd, vs, ud.double() * us.double(), vd.double() * vs.double()


def tier_delta(before: dict, after: dict, tier: str) -> dict:
    """A tier's counters over a window, with its live size after it."""
    b, a = before["tiers"][tier], after["tiers"][tier]
    out = {k: a[k] - b[k] for k in ("hits", "misses", "invalidations")}
    looked = out["hits"] + out["misses"]
    out["hit_ratio"] = out["hits"] / looked if looked else 0.0
    out["entries"], out["bytes"] = a["entries"], a["bytes"]
    return out


def cache_kernel_check(U, V, users, dev, card) -> None:
    """``fused_topk`` at the hot tier's shapes on each wire: a pinned
    ``[CACHE_PIN_ROWS, RANK]`` user table gathered by ``pin_user_rows``
    (its rows the source rows bit for bit), B = 1, every k of the pin's
    ladder; each launch held to the plain version as phase ``kernel``
    holds it and to the full-table launch for the same user, ids and
    scores bit for bit (the launch plan depends on the item table, B, r
    and k alone). Then the pinned B = 1 launch and the full-table one,
    event-timed in turns."""
    from predictionio_tpu_torch.models.als import (
        ALSModel,
        QuantizedFactors,
        _quantize_rows,
        _table_leaves,
        pin_user_rows,
    )
    from predictionio_tpu_torch.ops.fused_topk import (
        fused_topk,
        fused_topk_reference,
    )

    Ud, Vd = torch.from_numpy(U).to(dev), torch.from_numpy(V).to(dev)
    qU, qus = _quantize_rows(U, "int8")
    qV, qvs = _quantize_rows(V, "int8")
    wires = {
        "f32": (Ud, Vd),
        "bf16": (QuantizedFactors(Ud.bfloat16(), None, "bf16"),
                 QuantizedFactors(Vd.bfloat16(), None, "bf16")),
        "int8": (QuantizedFactors(qU.to(dev), qus.to(dev), "int8"),
                 QuantizedFactors(qV.to(dev), qvs.to(dev), "int8")),
    }
    rows = torch.tensor(users, dtype=torch.long, device=dev)
    for wire, (ut, vt) in wires.items():
        model = ALSModel(ut, vt, N_USERS, N_ITEMS)
        pinned, nbytes = pin_user_rows(model, users, CACHE_PIN_ROWS)
        ud, us = _table_leaves(ut)
        vd, vs = _table_leaves(vt)
        pd, ps = _table_leaves(pinned)
        check(tuple(pd.shape) == (CACHE_PIN_ROWS, RANK)
              and torch.equal(pd, ud[rows])
              and (us is None or torch.equal(ps, us[rows])),
              f"pinned {wire} rows are not the source rows bit for bit")
        P64 = pd.double() * (ps.double() if ps is not None else 1.0)
        V64 = vd.double() * (vs.double() if vs is not None else 1.0)
        worst = 0.0
        for k in CACHE_KS:
            for slot in CACHE_SLOTS:
                idx = torch.tensor([slot], dtype=torch.int32, device=dev)
                full = torch.tensor([users[slot]], dtype=torch.int32,
                                    device=dev)
                s, i = fused_topk(pd, idx, vd, ps, vs, k=k, n_items=N_ITEMS)
                fs, fi = fused_topk(ud, full, vd, us, vs, k=k,
                                    n_items=N_ITEMS)
                rs, _ = fused_topk_reference(pd, idx, vd, ps, vs, k=k,
                                             n_items=N_ITEMS)
                torch.cuda.synchronize()
                tag = f"pinned {wire} k={k} slot={slot}"
                worst = max(worst, verify_topk(tag, s, i, rs, P64, V64, idx,
                                               RTOL[wire]))
                check(torch.equal(i, fi) and torch.equal(s, fs),
                      f"{tag}: not bit-equal to the full-table launch")
        k, slot = 16, CACHE_SLOTS[2]
        idx = torch.tensor([slot], dtype=torch.int32, device=dev)
        full = torch.tensor([users[slot]], dtype=torch.int32, device=dev)
        times = {"pinned": [], "full": []}
        for arm in ("pinned", "full", "full", "pinned"):
            if arm == "pinned":
                times[arm].append(median_ms(lambda: fused_topk(
                    pd, idx, vd, ps, vs, k=k, n_items=N_ITEMS), 20))
            else:
                times[arm].append(median_ms(lambda: fused_topk(
                    ud, full, vd, us, vs, k=k, n_items=N_ITEMS), 20))
        print(f"phase cache kernel: fused_topk {wire} on a pinned "
              f"[{CACHE_PIN_ROWS}, {RANK}] table ({nbytes} bytes) B=1 k in "
              f"{CACHE_KS} x slots {CACHE_SLOTS}: max_abs_err={worst:.3e} "
              f"vs the plain version, ids and scores bit-equal to the "
              f"full-table launch, rows bit-equal to the source | k=16 "
              f"event-timed ms (pinned, full, full, pinned): "
              f"pinned={times['pinned'][0]:.4f},{times['pinned'][1]:.4f} "
              f"full={times['full'][0]:.4f},{times['full'][1]:.4f} | "
              f"{card_tag(card)}", flush=True)


def phase_cache(rng, U, V, dev, card) -> dict:
    """The serving caches and the pinned hot tier on the card, over phase
    4's tables (see the module's docstring, phase 4c). Returns each
    kernel's launches in the counted part."""
    from predictionio_tpu_torch.data.storage.base import (
        STATUS_COMPLETED,
        AccessKey,
        App,
        EngineInstance,
    )
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models.als import (
        _table_leaves,
        apply_row_updates,
    )
    from predictionio_tpu_torch.models.convert import als_model_from_numpy
    from predictionio_tpu_torch.server.engineserver import (
        ServerConfig,
        deploy_models,
    )
    from predictionio_tpu_torch.server.eventserver import (
        create_event_server,
    )
    from predictionio_tpu_torch.templates.recommendation import (
        recommendation_engine,
    )

    users = (rng.zipf(CACHE_ZIPF, BURST_QUERIES) - 1) % N_USERS
    burst = [{"user": f"u{u}", "num": 10} for u in users]
    distinct, freq = np.unique(users, return_counts=True)
    check(len(distinct) <= CACHE_HOT,
          f"{len(distinct)} distinct users past the hot capacity")
    hottest = [f"u{u}" for u in distinct[np.argsort(-freq, kind="stable")]]
    model = als_model_from_numpy(
        U, V, N_USERS, N_ITEMS, {f"u{n}": n for n in range(N_USERS)},
        {f"i{n}": n for n in range(N_ITEMS)}, {"rank": RANK}, device="cpu")
    engine = recommendation_engine()
    ep = engine.params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": RANK}}]})
    hot = dict(hot_entities=CACHE_HOT, hot_refresh_every=CACHE_REFRESH)
    configs = {"a": ServerConfig(serving_quant="int8"),
               "b": ServerConfig(serving_quant="int8", serving_cache=True,
                                 **hot),
               "c": ServerConfig(serving_quant="int8", serving_cache=True,
                                 batching=True, **hot)}
    threads0 = threading.active_count()
    counter = CacheLaunches()
    servers: dict = {}
    lines, totals = [], {"pinned": 0, "ladder": 0, "full": 0, "calls": 0}

    def take() -> dict:
        got = counter.take()
        for key in totals:
            totals[key] += got[key]
        return got

    def burst_on(name: str, label: str) -> dict:
        srv = servers[name]
        qs = srv.query_server
        before = qs.cache.stats() if qs.cache is not None else None
        take()
        wall, results = run_burst(srv.port, burst)
        split = take()
        after = qs.cache.stats() if qs.cache is not None else None
        check_burst(burst, [a for a, _ in results], *tables[name], dev)
        lat = np.array([t for _, t in results]) * 1e3
        out = {"qps": len(burst) / wall, "split": split}
        text = (f"phase cache burst {label}: {len(burst)} queries x "
                f"{BURST_CLIENTS} connections from another process, "
                f"{len(distinct)} users (Zipf {CACHE_ZIPF}) "
                f"qps={out['qps']:.1f} p50_ms={np.percentile(lat, 50):.3f} "
                f"p99_ms={np.percentile(lat, 99):.3f}")
        if after is not None:
            for tier in ("query", "feature", "hot"):
                d = out[tier] = tier_delta(before, after, tier)
                text += (f" | {tier} hits={d['hits']} misses={d['misses']} "
                         f"hit_ratio={d['hit_ratio']:.4f} entries="
                         f"{d['entries']} bytes={d['bytes']}")
            h0, h1 = before["tiers"]["hot"], after["tiers"]["hot"]
            out["coalesced"] = (after["singleflightCoalesced"]
                                - before["singleflightCoalesced"])
            out["stale"] = h1["pinnedStale"] - h0["pinnedStale"]
            out["pinned"] = out["hot"]["hits"] - out["stale"]
            text += (f" | coalesced={out['coalesced']} | pinned_serves="
                     f"{out['pinned']} refreshes={h1['refreshes']} "
                     f"pinnedStale={h1['pinnedStale']} refreshErrors="
                     f"{h1['refreshErrors']}")
            check(h1["refreshErrors"] == 0,
                  f"{label}: a hot-tier refresh failed: {h1['lastError']}")
        text += (f" | fused_topk launches pinned={split['pinned']} "
                 f"ladder={split['ladder']} full={split['full']} | "
                 f"{card_tag(card)}")
        print(text, flush=True)
        lines.append(out)
        return out

    with counter:
        try:
            for name, cfg in configs.items():
                servers[name] = deploy_models(
                    engine, ep, [model], cfg, "127.0.0.1",
                    0).start_background()
            for srv in servers.values():
                warmed(srv)
            tables = {n: bound_tables(srv) for n, srv in servers.items()}
            qs = servers["b"].query_server
            hot_tier = qs.cache.hot

            # -- the main path, counted ----------------------------------
            zero_launch_counts()
            counter.take()
            a = burst_on("a", "(a) cache off, per-query path")
            b1 = burst_on("b", "(b) cache on, per-query path, first "
                               "burst from a cold cache")
            hot_tier.refresh(wait=True)
            qs.cache.query.flush()
            check(all(hot_tier.peek(u) is not None for u in hottest),
                  "a burst user is not pinned after the refresh")
            b2 = burst_on("b", "(b) cache on, per-query path, second "
                               "burst (query tier emptied, hot tier "
                               "refreshed)")
            c = burst_on("c", "(c) cache on behind the staged pipeline")
            check(b2["pinned"] > 0, "the second burst served no query "
                                    "from the pinned table")
            check(b2["hot"]["misses"] == 0,
                  f"{b2['hot']['misses']} query-tier misses of the second "
                  f"burst found their user unpinned")
            check(b2["pinned"] == b2["query"]["misses"] - b2["coalesced"],
                  f"second burst: {b2['pinned']} pinned serves for "
                  f"{b2['query']['misses']} query-tier misses of pinned "
                  f"users ({b2['coalesced']} coalesced)")
            for out in (b1, b2, c):
                check(out["split"]["pinned"] == out["pinned"]
                      == out["split"]["calls"],
                      f"{out['split']['pinned']} pinned fused_topk launches "
                      f"for {out['pinned']} pinned serves")

            # invalidation by ingest: one rate event for each of 8 cached
            # hot users through an in-process event server (the bus)
            ud, us, vd, vs, U64, V64 = tables["b"]
            ingest = hottest[:CACHE_INGEST_USERS]
            store = Storage(env={"PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"})
            app_id = store.apps().insert(App(0, "CacheApp"))
            store.access_keys().insert(AccessKey("CK", app_id, ()))
            ev = create_event_server(store, "127.0.0.1",
                                     0).start_background()
            try:
                st0 = qs.cache.stats()
                for u in ingest:
                    status, _ = _http(ev.port, "POST",
                                      "/events.json?accessKey=CK",
                                      {"event": "rate", "entityType": "user",
                                       "entityId": u,
                                       "targetEntityType": "item",
                                       "targetEntityId": "i1",
                                       "properties": {"rating": 4.0}})
                    check(status == 201, f"ingest for {u}: {status}")
            finally:
                ev.close()
            st1 = qs.cache.stats()
            inval = (st1["tiers"]["query"]["invalidations"]
                     - st0["tiers"]["query"]["invalidations"])
            check(inval >= CACHE_INGEST_USERS,
                  f"{CACHE_INGEST_USERS} ingests invalidated {inval} "
                  f"query-tier entries")
            for u in ingest:
                obs: dict = {}
                q = {"user": u, "num": 10}
                ans = qs.serve(q, obs=obs)
                check("cache" not in obs,
                      f"{u}'s answer after its ingest: {obs.get('cache')}")
                check_answer(q, ans, ud, us, vd, vs, U64, V64, N_ITEMS, dev)
            st2 = qs.cache.stats()
            check(st2["tiers"]["query"]["misses"]
                  - st1["tiers"]["query"]["misses"] == CACHE_INGEST_USERS,
                  "the ingested users' answers were not all misses")

            # invalidation by fold-in: new rows for 4 pinned users
            fold = hottest[CACHE_INGEST_USERS:
                           CACHE_INGEST_USERS + CACHE_FOLD_USERS]
            untouched = hottest[CACHE_INGEST_USERS + CACHE_FOLD_USERS]
            old = {u: hot_tier.peek(u) for u in fold}
            bound = qs.models[0]
            rows = np.random.default_rng(CACHE_FOLD_USERS).standard_normal(
                (len(fold), RANK)).astype(np.float32)
            row_idx = np.array([int(u[1:]) for u in fold])
            new_model = apply_row_updates(bound, "user", row_idx, rows)
            refreshes = hot_tier.stats()["refreshes"]
            take()
            check(qs.apply_stream_delta(0, new_model, fold, qs.binding_id),
                  "apply_stream_delta refused the delta")
            deadline = time.perf_counter() + CACHE_REPIN_TIMEOUT_S
            while hot_tier.stats()["refreshes"] == refreshes:
                check(time.perf_counter() < deadline,
                      "the fold-in started no re-pin")
                time.sleep(0.01)
            hot_tier.refresh(wait=True)  # the re-pin in flight, if any
            nd, ns = _table_leaves(new_model.user_factors)
            N64 = nd.double() * ns.double()
            for u in fold:
                h = hot_tier.peek(u)
                check(h is not None and h[1][0] is not old[u][1][0],
                      f"{u}'s pinned handle survived its fold-in")
                table, slot = h[1]
                check(torch.equal(table.data[slot], nd[int(u[1:])])
                      and torch.equal(table.scale[slot], ns[int(u[1:])]),
                      f"{u}'s re-pinned row is not its folded row")
            h0 = hot_tier.stats()["hits"]
            take()
            for u in fold + [untouched]:
                obs = {}
                q = {"user": u, "num": 10 if u != untouched else 12}
                ans = qs.serve(q, obs=obs)
                check("cache" not in obs, f"{u}: {obs.get('cache')}")
                check_answer(q, ans, nd, ns, vd, vs, N64, V64, N_ITEMS, dev)
            split = take()
            check(hot_tier.stats()["hits"] - h0 == len(fold) + 1
                  and split["pinned"] == len(fold) + 1,
                  f"after the fold-in {split['pinned']} pinned launches for "
                  f"{len(fold) + 1} pinned users' queries")

            # the operator's flush, then a rebind
            status, body = _http(servers["b"].port, "POST", "/cache/flush")
            check(status == 200, f"POST /cache/flush: {status} {body}")
            _, cj = _http(servers["b"].port, "GET", "/cache.json")
            check(all(t["entries"] == 0 for t in cj["tiers"].values()),
                  f"/cache/flush left entries: {cj['tiers']}")
            for u in hottest[:16]:
                qs.serve({"user": u, "num": 10})
            hot_tier.refresh(wait=True)
            flushes = qs.cache.stats()["flushes"]
            when = datetime.now(timezone.utc)
            qs.bind_candidate(EngineInstance(
                id="cache-rebind", status=STATUS_COMPLETED,
                start_time=when, end_time=when, engine_id="cache",
                engine_version="1", engine_variant="engine.json",
                engine_factory="chip_smoke"), models=[model])
            qs.promote_candidate()
            st = qs.cache.stats()
            check(st["flushes"] == flushes + 1 and all(
                t["entries"] == 0 for t in st["tiers"].values()),
                f"the rebind did not flush every tier: {st['tiers']}")
            warmed(servers["b"])
            tables["b"] = bound_tables(servers["b"])
            q = {"user": hottest[0], "num": 10}
            check_answer(q, _post(servers["b"].port, q)[0],
                         *tables["b"], N_ITEMS, dev)
            take()
            counted = launch_counts()
            # ----------------------------------------------------------------
            final = {n: srv.query_server.cache.stats()
                     for n, srv in servers.items()
                     if srv.query_server.cache is not None}
        finally:
            for srv in servers.values():
                srv.close()
    for n, st in final.items():
        hot_st = st["tiers"]["hot"]
        check(hot_st["refreshErrors"] == 0,
              f"server ({n}): a hot-tier refresh failed: "
              f"{hot_st['lastError']}")
    check(counted["fused_topk"] == sum(totals[k] for k in
                                       ("pinned", "ladder", "full")),
          f"the launch split {totals} does not sum to the wrapper's "
          f"{counted['fused_topk']}")
    pinned_serves = sum(st["tiers"]["hot"]["hits"]
                        - st["tiers"]["hot"]["pinnedStale"]
                        for st in final.values())
    check(totals["pinned"] == pinned_serves == totals["calls"],
          f"{totals['pinned']} pinned fused_topk launches for "
          f"{pinned_serves} pinned serves")
    deadline = time.perf_counter() + 10
    while threading.active_count() > threads0 \
            and time.perf_counter() < deadline:
        time.sleep(0.05)
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("hot-tier-refresh")]
    check(threading.active_count() <= threads0 and not left,
          f"threads left after close(): {threading.active_count()} of "
          f"{threads0} before the phase ({left})")
    check_no_children()
    print(f"phase cache: qps (a) cache off={a['qps']:.1f} (b) first="
          f"{b1['qps']:.1f} second={b2['qps']:.1f} (c) staged="
          f"{c['qps']:.1f} | query hit ratio (b) first="
          f"{b1['query']['hit_ratio']:.4f} (c)="
          f"{c['query']['hit_ratio']:.4f} | pinned serves (b) second="
          f"{b2['pinned']} = query misses {b2['query']['misses']} - "
          f"coalesced {b2['coalesced']} | ingest invalidated {inval} | "
          f"fold-in: {len(fold)} users re-pinned and answered from their "
          f"folded rows, 1 untouched pinned | flush and rebind emptied "
          f"every tier | fused_topk launches {counted['fused_topk']}: "
          f"pinned={totals['pinned']} ladder={totals['ladder']} "
          f"full={totals['full']} | {card_tag(card)}", flush=True)
    # the kernel at the pinned shapes: the burst's users first, then the
    # lowest other ids, CACHE_PIN_ROWS distinct rows
    pin = [int(u[1:]) for u in hottest]
    taken = set(pin)
    pin += [u for u in range(N_USERS) if u not in taken][
        :CACHE_PIN_ROWS - len(pin)]
    cache_kernel_check(U, V, pin, dev, card)
    return counted


# -- training ---------------------------------------------------------------

TRAIN_ITERS = 10


def load_surrogate(seed: int, with_times: bool = False):
    """The MovieLens-20M surrogate (pure numpy), loaded by file path:
    (users, items, stars, n_users, n_items), and with ``with_times`` the
    ratings' timestamps (seconds) beside it."""
    path = Path(__file__).resolve().parent / "benchmarks" / "ml20m_surrogate.py"
    spec = importlib.util.spec_from_file_location("ml20m_surrogate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    users, items, stars, ts, n_users, n_items = mod.generate(scale=1.0,
                                                             seed=seed)
    print(f"phase train-data: {len(users)} ratings, {n_users} users x "
          f"{n_items} items (seed {seed}) in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    data = users, items, stars, n_users, n_items
    return (data, ts) if with_times else data


def gram_bound(B: int, L: int, rows: int, r: int, wire: str) -> tuple:
    """(least ms, what bounds it) for one fused_gram call: the ``rows``
    distinct table rows the indices name, the indices and both weights
    read once, A (all r x r, as returned) and b written once. Per slot
    r(r+1)/2 multiply-adds for the distinct entries of the symmetric A,
    r multiplies for wa * f and r multiply-adds for b: r^2 + 4r operations
    at the wire's peak (bf16 x bf16 products are exact in f32, so the bf16
    wire may run them on tensor cores)."""
    w = {"f32": 4, "bf16": 2}[wire]
    nbytes = rows * r * w + B * L * 12 + B * (r * r + r) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = B * L * (r * r + 4.0 * r) / PEAK_OPS[wire] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def solve_bound(n: int, r: int) -> tuple:
    """(least ms, what bounds it) for one chol_solve call: the lower
    triangle of A (all a Cholesky solve reads) and b read once, x written
    once; r^3/3 + 2r^2 operations per system at the f32 peak."""
    t_bytes = n * (r * (r + 1) // 2 + 2 * r) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = n * (r ** 3 / 3.0 + 2.0 * r * r) / PEAK_OPS["f32"] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_gram(tag, A, b, Ar, br, table, wa, wb) -> float:
    """|dA| <= 1e-5 * sum_l |wa| * max|f|^2 and |db| <= 1e-5 * sum_l |wb|
    * max|f| per row; returns the largest |dA|."""
    fmax = table.float().abs().max()
    errA = (A - Ar).abs().amax(dim=(1, 2))
    errb = (b - br).abs().amax(dim=1)
    tolA = 1e-5 * wa.abs().sum(1) * fmax * fmax
    tolb = 1e-5 * wb.abs().sum(1) * fmax
    check(bool((errA <= tolA).all()) and bool((errb <= tolb).all()),
          f"{tag}: A off the plain version by {errA.max().item():.3e}, b by "
          f"{errb.max().item():.3e}")
    return errA.max().item()


def library_gram(table, idx, wa, wb):
    """One library computation of the same (A, b): gather, then torch.bmm."""
    F = table[idx.long()].float()
    Fw = F * wa[..., None]
    return (torch.bmm(Fw.transpose(1, 2), F),
            torch.bmm(wb[:, None, :], F)[:, 0])


def phase_train_kernel(packed, params, dev) -> tuple:
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops import fused_gram as fg
    from predictionio_tpu_torch.ops import solve as sv

    r = params.rank
    for side, h in (("user", packed.user_h), ("item", packed.item_h)):
        if isinstance(h, als.BucketedHistories):
            shape = " ".join(f"{b.length}x{b.n_rows}" for b in h.buckets)
            real = sum(int((b.counts > 0).sum()) for b in h.buckets)
            print(f"phase train-kernel: {side} layout bucket, L x rows: "
                  f"{shape}; {h.padded_entries} padded slots; "
                  f"{h.n_rows - real} of {h.n_rows} rows without a rating",
                  flush=True)
        else:
            print(f"phase train-kernel: {side} layout pad {h.n_rows} x "
                  f"{h.max_len}", flush=True)
    U0, V0 = als.draw_initial_factors(
        params.seed, packed.n_users, als._rows_padded(packed.user_h),
        packed.n_items, als._rows_padded(packed.item_h), r)
    U0, V0 = U0.to(dev), V0.to(dev)
    total = {w: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                     slots=0, err=0.0, by={"bytes": 0.0, "operations": 0.0})
             for w in ("f32", "bf16")}
    systems = {}
    blocks = {}  # each side's row blocks, the solve's launches in training
    table_block = None  # the user L = 512 block, for the gram-table phase
    named = {("user", 32), ("user", 512), ("item", 65536), ("item", 131072)}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    small = {}  # the first block of each named shape, for the rank-10 run
    for side, h, table in (("user", packed.user_h, V0),
                           ("item", packed.item_h, U0)):
        As, bs = [], []
        for idx, val, cnt, _ in als.training_blocks(h, r):
            B, L = idx.shape
            wa, wb = als._weights(val, cnt, params.alpha, implicit=False)
            rows = int(torch.unique(idx).numel())
            for wire, tab in (("f32", table), ("bf16", table.bfloat16())):
                A, b = fg.fused_gram(tab, idx, wa, wb)
                torch.cuda.synchronize()
                Ar, br = fg.fused_gram_reference(tab, idx, wa, wb)
                tag = f"fused_gram {side} {wire} B={B} L={L}"
                err = check_gram(tag, A, b, Ar, br, tab, wa, wb)
                del Ar, br
                ms = median_ms(lambda: fg.fused_gram(tab, idx, wa, wb), 5)
                plain_ms = median_ms(
                    lambda: fg.fused_gram_reference(tab, idx, wa, wb), 3)
                lib_ms = median_ms(lambda: library_gram(tab, idx, wa, wb), 3)
                b_ms, b_by = gram_bound(B, L, rows, r, wire)
                t = total[wire]
                t["ms"] += ms
                t["plain_ms"] += plain_ms
                t["library_ms"] += lib_ms
                t["bound_ms"] += b_ms
                t["by"][b_by] += b_ms
                t["slots"] += B * L
                t["err"] = max(t["err"], err)
                if (side, L, wire) == ("user", 512, "f32") \
                        and table_block is None:  # the 8,192-row block
                    table_block = (tab, idx, wa, wb, rows)
                if (side, L) in named:
                    small.setdefault((side, L), (idx, wa, wb))
                    plan = fg.gram_plan(B, L, r, tab.element_size(), n_sm,
                                        tab.data_ptr() % 16 == 0)
                    check(plan.vec16, f"{tag}: staging {plan.staging}")
                    if L >= 65536:
                        check(B * plan.splits >= n_sm, f"{tag}: "
                              f"{plan.splits} L-splits leave SMs idle")
                    if L == 131072:
                        A2, b2 = fg.fused_gram(tab, idx, wa, wb)
                        check(torch.equal(A, A2) and torch.equal(b, b2),
                              f"{tag}: two runs differ in a bit")
                        check(torch.equal(A, A.transpose(1, 2)),
                              f"{tag}: A is not exactly symmetric")
                        del A2, b2
                    print(f"phase train-kernel: {tag} L_splits={plan.splits} "
                          f"staging={plan.staging} max_abs_err={err:.3e} "
                          f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                          f"library_ms={lib_ms:.4f} bound_ms={b_ms:.5f} "
                          f"bound_by={b_by}", flush=True)
                if wire == "f32":
                    A.diagonal(dim1=-2, dim2=-1).add_(
                        (params.reg * torch.clamp(cnt.float(), min=1.0))
                        [:, None])
                    As.append(A)
                    bs.append(b)
                else:
                    del A, b
        systems[side] = (torch.cat(As), torch.cat(bs))
        blocks[side] = list(zip(As, bs))
        del As, bs
    for wire, t in total.items():
        print(f"phase train-kernel: fused_gram {wire} one iteration "
              f"({t['slots']} slots, both sides) max_abs_err={t['err']:.3e} "
              f"ms={t['ms']:.3f} plain_ms={t['plain_ms']:.3f} "
              f"library_ms={t['library_ms']:.3f} bound_ms={t['bound_ms']:.4f} "
              f"(bytes-bound calls {t['by']['bytes']:.4f}, operations-bound "
              f"calls {t['by']['operations']:.4f})", flush=True)
    # the shipped engine.json's rank: 40-byte f32 rows, 20-byte bf16 rows
    rng10 = np.random.default_rng(10)
    for (side, L), (idx, wa, wb) in sorted(small.items()):
        m = (V0 if side == "user" else U0).shape[0]
        t10 = torch.from_numpy(rng10.standard_normal(
            (m, 10), dtype=np.float32)).to(dev)
        for wire, tab in (("f32", t10), ("bf16", t10.bfloat16())):
            plan = fg.gram_plan(idx.shape[0], L, 10, tab.element_size(), n_sm)
            check(not plan.vec16, f"rank 10 {wire}: staging {plan.staging}")
            A, b = fg.fused_gram(tab, idx, wa, wb)
            torch.cuda.synchronize()
            Ar, br = fg.fused_gram_reference(tab, idx, wa, wb)
            tag = (f"fused_gram {side} {wire} rank 10 B={idx.shape[0]} "
                   f"L={L}")
            err = check_gram(tag, A, b, Ar, br, tab, wa, wb)
            del Ar, br
            ms = median_ms(lambda: fg.fused_gram(tab, idx, wa, wb), 5)
            print(f"phase train-kernel: {tag} L_splits={plan.splits} "
                  f"staging={plan.staging} max_abs_err={err:.3e} "
                  f"ms={ms:.4f}", flush=True)
    del small
    f32 = total["f32"]
    gram_row = {"max_abs_err": f32["err"], "ms": f32["ms"],
                "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
                "bound_by": max(f32["by"], key=f32["by"].get),
                "library_ms": f32["library_ms"]}

    def solve_checks(tag, A, b, x):
        """The residual, dx and finite checks; (residual, dx, max|dx|)."""
        rr = b.shape[1]
        xp = sv.solve_spd_reference(A, b)
        Aj = A + 1e-6 * torch.eye(rr, device=dev)
        res = ((torch.einsum("nrs,ns->nr", Aj, x) - b).norm(dim=1)
               / (torch.linalg.matrix_norm(Aj) * x.norm(dim=1)
                  + b.norm(dim=1)))
        dx = (x - xp).norm(dim=1) / xp.norm(dim=1).clamp(min=1e-30)
        check(bool(torch.isfinite(x).all()), f"{tag}: non-finite x")
        check(res.max().item() <= 1e-5, f"{tag}: relative residual "
              f"{res.max().item():.3e} > 1e-5")
        check(dx.max().item() <= 1e-3, f"{tag}: x off the plain version by "
              f"{dx.max().item():.3e} (normwise relative)")
        return res.max().item(), dx.max().item(), (x - xp).abs().max().item()

    def plan_text(n, rr, A):
        route = sv.solve_route(A.dtype, rr, A.device.type)
        if route != "kernel":
            return f"route={route}"
        p = sv.solve_plan(rr, n, n_sm, A.data_ptr() % 16 == 0)
        return (f"plan=({p.route} R={p.rank} systems/warp="
                f"{p.systems_per_warp} warps/block={p.warps_per_block} "
                f"blocks={p.blocks} smem={p.smem_bytes} vec16={p.vec16})")

    def solve_case(tag, A, b):
        n, rr = b.shape
        before = sv.LAUNCHES
        x = sv.solve_spd_batch(A, b)
        torch.cuda.synchronize()
        launched = sv.LAUNCHES - before
        res, dx, err = solve_checks(tag, A, b, x)
        Aj = A + 1e-6 * torch.eye(rr, device=dev)
        ms = median_ms(lambda: sv.solve_spd_batch(A, b), 5)
        q_ms = queued_ms(lambda: sv.solve_spd_batch(A, b), 10)
        plain_ms = median_ms(lambda: sv.solve_spd_reference(A, b), 2)
        lib_ms = median_ms(lambda: torch.cholesky_solve(
            b[..., None], torch.linalg.cholesky(Aj))[..., 0], 5)
        b_ms, b_by = solve_bound(n, rr)
        print(f"phase train-kernel: chol_solve {tag} n={n} r={rr} "
              f"launched={launched} residual={res:.3e} dx={dx:.3e} "
              f"max_abs_err={err:.3e} ms={ms:.4f} queued_ms={q_ms:.4f} "
              f"plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.5f} bound_by={b_by} "
              f"{plan_text(n, rr, A)}", flush=True)
        return launched, x, {"max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "library_ms": lib_ms}

    def lower_triangle_case(tag, A, b, x):
        """Random finite values above the diagonal: the same x, bit for
        bit, as the symmetric A's (the kernel reads the lower triangle
        only)."""
        rr = b.shape[1]
        Au = A.clone()
        iu = torch.triu_indices(rr, rr, 1, device=dev)
        Au[:, iu[0], iu[1]] = torch.randn(
            (A.shape[0], iu.shape[1]), device=dev,
            generator=torch.Generator(dev).manual_seed(7))
        xu = sv.solve_spd_batch(Au, b)
        torch.cuda.synchronize()
        res, dx, _ = solve_checks(tag + " upper random", A, b, xu)
        check(torch.equal(xu, x), f"{tag}: random values above the diagonal "
              f"change x (max {(xu - x).abs().max().item():.3e})")
        print(f"phase train-kernel: chol_solve lower triangle {tag} "
              f"n={A.shape[0]} r={rr}: x bit-identical with random values "
              f"above the diagonal, residual={res:.3e} dx={dx:.3e}",
              flush=True)

    launched, _, solve_row = solve_case("user systems", *systems["user"])
    check(launched == 1, "the user systems did not take the kernel")
    item_launched, x_item, _ = solve_case("item systems", *systems["item"])
    check(item_launched == 1, "the item systems did not take the kernel")
    lower_triangle_case("item systems", *systems["item"], x_item)
    del systems, x_item
    # the solve as training launches it: one launch a row block
    per_launch = []
    for side in ("user", "item"):
        for A, b in blocks[side]:
            n = b.shape[0]
            before = sv.LAUNCHES
            x = sv.solve_spd_batch(A, b)
            torch.cuda.synchronize()
            check(sv.LAUNCHES - before == 1,
                  f"{side} block n={n}: did not take the kernel")
            solve_checks(f"chol_solve {side} block n={n}", A, b, x)
            per_launch.append(
                (median_ms(lambda: sv.solve_spd_batch(A, b), 5), side, n,
                 queued_ms(lambda: sv.solve_spd_batch(A, b), 10)))
    del blocks
    train_ms = sum(p[0] for p in per_launch)
    slow, fast = max(per_launch), min(per_launch)
    print(f"phase train-kernel: chol_solve as training launches it: "
          f"{len(per_launch)} launches (one a row block, both sides) "
          f"ms={train_ms:.4f} queued_ms={sum(p[3] for p in per_launch):.4f} "
          f"slowest={slow[0]:.4f} ({slow[1]} n={slow[2]}) "
          f"fastest={fast[0]:.4f} ({fast[1]} n={fast[2]}) | every launch "
          f"within the residual and dx limits", flush=True)
    rng = np.random.default_rng(5)
    for rr in (10, 96, 128, 136):
        n = 4096 if rr <= 128 else 256
        W = torch.from_numpy(rng.standard_normal(
            (n, 2 * rr, rr), dtype=np.float32)).to(dev)
        A = torch.einsum("nkr,nks->nrs", W, W) / (2 * rr) \
            + 0.1 * torch.eye(rr, device=dev)
        b = torch.from_numpy(rng.standard_normal((n, rr),
                                                 dtype=np.float32)).to(dev)
        launched, x, row = solve_case(f"synthetic r={rr}", A, b)
        check(launched == (1 if rr <= 128 else 0),
              f"r={rr}: {launched} launches, routed wrong")
        if rr > 128:
            check(sv.solve_route(A.dtype, rr, "cuda") == "library",
                  f"r={rr}: not the library route")
            print(f"phase train-kernel: chol_solve r={rr} takes the library "
                  f"route (cholesky_ex + cholesky_solve): route ms="
                  f"{row['ms']:.4f} library_ms={row['library_ms']:.4f} "
                  f"plain loop ms={row['plain_ms']:.4f}", flush=True)
        if rr == 128:
            check(row["ms"] < row["library_ms"], f"r=128: the kernel "
                  f"({row['ms']:.4f} ms) is not under the library "
                  f"({row['library_ms']:.4f} ms)")
        if rr in (10, 128):
            lower_triangle_case(f"synthetic r={rr}", A, b, x)
    per_iter = {"gram_ms": gram_row["ms"], "solve_ms": train_ms}
    return gram_row, solve_row, per_iter, table_block


def rmse(U, V, users, items, stars) -> float:
    """Training RMSE over every rating, on the card in chunks."""
    se = 0.0
    for s in range(0, len(users), 1 << 22):
        e = min(s + (1 << 22), len(users))
        pred = (U[users[s:e]] * V[items[s:e]]).sum(1)
        se += ((pred - stars[s:e]) ** 2).sum().item()
    return (se / len(users)) ** 0.5


@contextlib.contextmanager
def plain_kernels(als):
    """The training path's two kernels swapped for their plain versions,
    for the duration."""
    from predictionio_tpu_torch.ops.fused_gram import fused_gram_reference
    from predictionio_tpu_torch.ops.solve import solve_spd_reference

    saved = als.fused_gram, als.solve_spd_batch
    als.fused_gram, als.solve_spd_batch = (fused_gram_reference,
                                           solve_spd_reference)
    try:
        yield
    finally:
        als.fused_gram, als.solve_spd_batch = saved


def phase_train(data, dev) -> dict:
    from predictionio_tpu_torch.controller.base import DataSource
    from predictionio_tpu_torch.controller.context import Context
    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.models.als import (
        _table_leaves,
        pack_ratings_cached,
    )
    from predictionio_tpu_torch.ops import fused_gram as fg
    from predictionio_tpu_torch.ops import solve as sv
    from predictionio_tpu_torch.server.engineserver import (
        ServerConfig,
        deploy_models,
    )
    from predictionio_tpu_torch.templates.recommendation import (
        TrainingData,
        recommendation_engine,
    )
    from predictionio_tpu_torch.workflow.persistence import (
        dumps_models,
        loads_models,
    )

    users, items, stars, n_users, n_items = data
    ratings = als.RatingsCOO(users, items, stars, n_users, n_items)

    class SurrogateDataSource(DataSource):
        def read_training(self, ctx):
            return TrainingData(
                ratings, BiMap({f"u{n}": n for n in range(n_users)}),
                BiMap({f"i{n}": n for n in range(n_items)}))

    engine = recommendation_engine(datasource_classes=SurrogateDataSource)
    ep = engine.params_from_variant({"algorithms": [{"name": "als", "params": {
        "rank": RANK, "numIterations": TRAIN_ITERS}}]})
    params = ep.algorithms[0][1]
    ctx = Context(device=dev)

    # -- the training path, counted ------------------------------------
    fg.LAUNCHES = 0
    sv.LAUNCHES = 0
    t0 = time.perf_counter()
    result = engine.train(ctx, ep)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"fused_gram": fg.LAUNCHES, "chol_solve": sv.LAUNCHES}
    # ------------------------------------------------------------------
    check(launches["fused_gram"] > 0, "training launched fused_gram no time")
    check(launches["chol_solve"] > 0, "training launched chol_solve no time")
    (model,) = result.models
    packed = pack_ratings_cached(ratings, params, device=dev)
    u_t = torch.from_numpy(users.astype(np.int64)).to(dev)
    i_t = torch.from_numpy(items.astype(np.int64)).to(dev)
    s_t = torch.from_numpy(stars).to(dev)
    rmse_10 = rmse(model.user_factors, model.item_factors, u_t, i_t, s_t)

    one = dataclasses.replace(params, num_iterations=1)
    U1, V1 = als.train_als(ratings, one, device=dev, packed=packed)
    rmse_1 = rmse(U1, V1, u_t, i_t, s_t)
    check(np.isfinite(rmse_10) and rmse_10 < rmse_1,
          f"training RMSE {rmse_10:.4f} after {TRAIN_ITERS} iterations is "
          f"not below {rmse_1:.4f} after 1")
    before = (fg.LAUNCHES, sv.LAUNCHES)
    with plain_kernels(als):
        U1p, V1p = als.train_als(ratings, one, device=dev, packed=packed)
    torch.cuda.synchronize()
    check((fg.LAUNCHES, sv.LAUNCHES) == before,
          "the plain half-steps launched a kernel")
    for name, got, want in (("U", U1, U1p), ("V", V1, V1p)):
        bad = (got - want).abs() > 2e-4 + 2e-3 * want.abs()
        check(not bool(bad.any()),
              f"one iteration: {name} off the plain half-steps at "
              f"{int(bad.sum())} entries (max "
              f"{(got - want).abs().max().item():.3e})")
    dU = (U1 - U1p).abs().max().item()
    dV = (V1 - V1p).abs().max().item()
    del U1p, V1p

    # one iteration (a user and an item half-step) from the initial
    # factors, timed alone: host clock around work ending in a sync
    U0, V0 = (t.to(dev) for t in als.draw_initial_factors(
        params.seed, n_users, als._rows_padded(packed.user_h), n_items,
        als._rows_padded(packed.item_h), RANK))

    def iteration():
        U = als._update_side(V0, packed.user_h, params)
        return U, als._update_side(U, packed.item_h, params)

    iteration()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iteration()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    iter_s = float(np.median(times))
    flops = als.als_flops_per_iter(packed.user_h, packed.item_h, params)
    _, breakdown = profile_device("phase train profile, one iteration",
                                  iteration)
    print(f"phase train: Engine.train {TRAIN_ITERS} iterations rank {RANK} "
          f"{len(users)} ratings in {train_s:.3f}s (stages "
          f"{ctx.stage_timings}), over that whole window (read and pack "
          f"included) {train_s / TRAIN_ITERS * 1e3:.2f} ms an iteration, "
          f"ratings_per_s_per_iter={len(users) * TRAIN_ITERS / train_s:.1f}"
          f" | launches fused_gram="
          f"{launches['fused_gram']} chol_solve={launches['chol_solve']} | "
          f"rmse after 1={rmse_1:.4f} after {TRAIN_ITERS}={rmse_10:.4f} | "
          f"one isolated iteration from the initial factors s={iter_s:.4f} "
          f"(median of runs "
          f"{', '.join(f'{t:.4f}' for t in times)}) ratings_per_s_per_iter="
          f"{len(users) / iter_s:.1f} padded_tflop_per_s="
          f"{flops / iter_s / 1e12:.3f} ({flops / 1e9:.1f} GFLOP an "
          f"iteration) | kernel vs plain one iteration: "
          f"max |dU|={dU:.3e} |dV|={dV:.3e}", flush=True)

    (loaded,) = loads_models(dumps_models(result.models))
    srv = deploy_models(engine, ep, [loaded],
                 ServerConfig(batching=True, serving_quant="int8"),
                 host="127.0.0.1", port=0)
    srv.start_background()
    try:
        bound_model = srv.query_server.models[0]
        ud, us = _table_leaves(bound_model.user_factors)
        vd, vs = _table_leaves(bound_model.item_factors)
        U64 = ud.double() * (us.double() if us is not None else 1.0)
        V64 = vd.double() * (vs.double() if vs is not None else 1.0)
        rng = np.random.default_rng(11)
        queries = [{"user": f"u{u}", "num": 10}
                   for u in rng.integers(0, n_users, 32)]
        queries[0]["blackList"] = ["i1", "i2", "i3"]
        for q in queries:
            check_answer(q, _post(srv.port, q)[0], ud, us, vd, vs, U64, V64,
                         n_items, dev)
        with _LOCAL.open(f"http://127.0.0.1:{srv.port}/status.json",
                         timeout=30) as resp:
            quant = json.loads(resp.read())["servingQuant"]
    finally:
        srv.close()
    print(f"phase train deploy: {len(queries)} /queries.json answers "
          f"checked on the trained model, servingQuant={quant}", flush=True)
    return {"launches": launches, "iter_s": iter_s, "breakdown": breakdown,
            "item_factors": model.item_factors,
            "host_factors": (model.user_factors.cpu().numpy(),
                             model.item_factors.cpu().numpy())}


def phase_implicit(data, dev) -> dict:
    """One implicit ALS iteration (Hu-Koren-Volinsky, alpha 1.0, the
    stars as counts) at ML-20M width and rank 64 on the card, launches
    counted, held against the same half-steps with the plain
    ``fused_gram`` and solve to phase ``train``'s limits, then profiled:
    ``fused_gram``, ``chol_solve``, the fixed side's Gramian G and the
    rest."""
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops import fused_gram as fg
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.ops import gram
    from predictionio_tpu_torch.ops import solve as sv

    users, items, stars, n_users, n_items = data
    ratings = als.RatingsCOO(users, items, stars, n_users, n_items)
    params = als.ALSParams(rank=RANK, num_iterations=1, implicit_prefs=True,
                           alpha=1.0)
    packed = als.pack_ratings(ratings, params, device=dev)
    torch.cuda.synchronize()

    # -- one implicit iteration, counted -------------------------------
    fg.LAUNCHES = sv.LAUNCHES = ft.LAUNCHES = gram.LAUNCHES = 0
    t0 = time.perf_counter()
    U1, V1 = als.train_als(ratings, params, device=dev, packed=packed)
    torch.cuda.synchronize()
    iter_s = time.perf_counter() - t0
    launches = {"fused_gram": fg.LAUNCHES, "chol_solve": sv.LAUNCHES,
                "fused_topk": ft.LAUNCHES, "gram_table": gram.LAUNCHES}
    # ------------------------------------------------------------------
    check(launches["fused_gram"] > 0 and launches["chol_solve"] > 0,
          f"the implicit iteration launched {launches}")
    check(launches["fused_topk"] == 0 and launches["gram_table"] == 0,
          f"a training iteration launched a serving or table kernel: "
          f"{launches}")
    check(bool(torch.isfinite(U1).all()) and bool(torch.isfinite(V1).all()),
          "the implicit iteration gave non-finite factors")
    with plain_kernels(als):
        U1p, V1p = als.train_als(ratings, params, device=dev, packed=packed)
    torch.cuda.synchronize()
    check((fg.LAUNCHES, sv.LAUNCHES, ft.LAUNCHES, gram.LAUNCHES)
          == tuple(launches.values()), "the plain half-steps launched a kernel")
    for name, got, want in (("U", U1, U1p), ("V", V1, V1p)):
        bad = (got - want).abs() > 2e-4 + 2e-3 * want.abs()
        check(not bool(bad.any()),
              f"implicit iteration: {name} off the plain half-steps at "
              f"{int(bad.sum())} entries (max "
              f"{(got - want).abs().max().item():.3e})")
    dU = (U1 - U1p).abs().max().item()
    dV = (V1 - V1p).abs().max().item()
    del U1p, V1p

    U0, V0 = (t.to(dev) for t in als.draw_initial_factors(
        params.seed, n_users, als._rows_padded(packed.user_h), n_items,
        als._rows_padded(packed.item_h), RANK))

    def iteration():
        U = als._update_side(V0, packed.user_h, params)
        return U, als._update_side(U, packed.item_h, params)

    iteration()
    _, bd = profile_device("phase implicit profile, one iteration",
                           iteration)
    g_alone = median_ms(lambda: (sv.gramian(V0), sv.gramian(U0)), 5)
    other = bd["device_ms"] - bd["fused_gram"] - bd["chol_solve"] - bd["G"]
    print(f"phase implicit: one iteration rank {RANK} alpha 1.0 over "
          f"{len(users)} ratings (stars as counts) in {iter_s:.3f}s "
          f"(first call, synchronized) | launches fused_gram="
          f"{launches['fused_gram']} chol_solve={launches['chol_solve']} "
          f"(an explicit train iteration: 30 each) fused_topk="
          f"{launches['fused_topk']} gram_table={launches['gram_table']} | "
          f"kernel vs plain: max "
          f"|dU|={dU:.3e} |dV|={dV:.3e} | profiled iteration ms: wall="
          f"{bd['wall_ms']:.3f} fused_gram={bd['fused_gram']:.3f} "
          f"chol_solve={bd['chol_solve']:.3f} G={bd['G']:.3f} "
          f"other_kernels={other:.3f} device_idle="
          f"{bd['wall_ms'] - bd['device_ms']:.3f} | G alone (both sides' "
          f"tables, event-timed) {g_alone:.3f} ms", flush=True)
    return {"launches": launches, "breakdown": bd}


def profile_device(label: str, fn) -> tuple:
    """Run ``fn`` once under ``torch.profiler`` and print its device time
    by kernel; the busy share is the summed kernel and copy time over the
    wall time. Returns ``fn``'s result and the breakdown."""
    from torch.profiler import ProfilerActivity, profile

    from predictionio_tpu_torch.obs.trace import profiler_held

    torch.cuda.synchronize()
    # held for the window: a server's POST /profile meanwhile answers 409
    with profiler_held(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # kernels only: a CPU op also carries the device time of the kernels
    # it launched, which would count them twice
    rows = sorted(((dev_us(e) / 1e3, e.key) for e in prof.key_averages()
                   if dev_us(e) > 0 and str(e.device_type).endswith("CUDA")),
                  reverse=True)
    total = sum(ms for ms, _ in rows)
    check(bool(rows), f"{label}: the profiler shows no device time")
    top = " | ".join(f"{name[:48]}={ms:.3f}" for ms, name in rows[:8])
    print(f"{label}: wall_ms={wall_ms:.3f} device_ms={total:.3f} "
          f"busy_share={total / wall_ms:.5f} idle_share="
          f"{1 - total / wall_ms:.5f} | {top}", flush=True)
    out = {"wall_ms": wall_ms, "device_ms": total}
    # each wrapper by its kernels' names in the trace (fused_gram launches
    # gram_tile.cuh's gram_rows_kernel and, for split rows, sum_partials)
    for key, kernels in (("fused_gram", ("gram_rows_kernel", "sum_partials")),
                         ("chol_solve", ("chol_solve_regs",
                                         "chol_solve_smem")),
                         ("fused_topk", ("fused_topk_kernel",
                                         "merge_topk_kernel")),
                         # the implicit half-step's G = F^T F: the
                         # library's matrix product (and its split-K sum)
                         ("G", ("gemm", "splitK"))):
        out[key] = sum(ms for ms, name in rows
                       if any(k in name for k in kernels))
    return result, out


# -- the last kernel and the pio lifecycle ----------------------------------

def _cudart() -> ctypes.CDLL:
    """The CUDA runtime this process already loaded for torch, else the
    toolkit's."""
    with open("/proc/self/maps") as maps:
        paths = sorted({ln.split()[-1] for ln in maps
                        if "libcudart.so" in ln.split()[-1]})
    return ctypes.CDLL(paths[0] if paths
                       else "/usr/local/cuda/lib64/libcudart.so")


#: the tensor cores' published dense TF32 peak (gram_table's products)
TF32_PEAK_OPS = 495e12


def table_bounds(B: int, L: int, rows: int, r: int, itemsize: int,
                 passes: int) -> tuple:
    """(ms, by, tensor-core ms, by) for one gram_table call: the
    ``rows`` distinct table rows the indices name, the indices and both
    weights read once, A and b written once; the r^2 + 4r operations a
    slot of ``gram_bound`` at the f32 peak, and again ``passes`` times
    at the TF32 peak (the split products: 3 on the f32 wire, 2 on the
    bf16 wire, whose F is exact)."""
    nbytes = rows * r * itemsize + B * L * 12 + B * (r * r + r) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ops = B * L * (r * r + 4.0 * r)
    out = ()
    for t_ops in (ops / PEAK_OPS["f32"] * 1e3,
                  ops * passes / TF32_PEAK_OPS * 1e3):
        out += ((t_ops, "operations") if t_ops >= t_bytes
                else (t_bytes, "bytes"))
    return out


def table_inputs(rng, m: int, r: int, B: int, L: int, dev, outside=False):
    """An N(0, 1) [m, r] f32 table, uniform indices and weights in [0, 1)
    on the card; with ``outside`` 3% of the indices below 0 and 3% past
    the table."""
    idx = rng.integers(0, m, (B, L)).astype(np.int32)
    if outside:
        hit = rng.random((B, L))
        idx[hit < 0.03] = -1
        idx[(hit >= 0.03) & (hit < 0.06)] = m + 7
    return tuple(torch.from_numpy(x).to(dev) for x in (
        rng.standard_normal((m, r), dtype=np.float32), idx,
        rng.random((B, L), dtype=np.float32),
        rng.random((B, L), dtype=np.float32)))


def phase_gram_table(seed: int, table_block, dev) -> dict:
    """``gram_table`` against its plain version on both wires: the 512-row
    table at r = 64 taking each path and the automatic one, at r = 10 and
    r = 128 too; the ML-20M block (the 26,744 x 64 initial item table,
    the user side's L = 512 bucket, its 0/1 weights); a B that is no
    multiple of a block's workers and an L no multiple of 32 with
    indices outside the table; a split launch, run twice and compared
    bit for bit. Each case prints its plan, ``ms``, ``queued_ms``, its
    bounds (f32 operations, and the split products at the TF32 peak), the
    plain version's and the library's ms."""
    from predictionio_tpu_torch.ops import gram

    rng = np.random.default_rng(seed + 3)
    optin = smem_optin(dev.index or 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    small = table_inputs(rng, 512, RANK, 8192, 512, dev)
    cases = [(f"512x{RANK} {p}", small, p, True)
             for p in ("auto", 1, 2)]
    cases += [("ML-20M block", tuple(table_block[:4]), "auto", True)]
    for r in (10, 128):
        t = table_inputs(rng, 512, r, 8192, 512, dev)
        cases += [(f"512x{r} {p}", t, p, True) for p in ("auto", 2)]
    cases += [("odd B and L, outside indices",
               table_inputs(rng, 512, RANK, 8191, 500, dev, outside=True),
               "auto", False),
              ("split, outside indices",
               table_inputs(rng, 26744, RANK, 40, 2048, dev, outside=True),
               "auto", False)]
    row, results = {}, []
    for tag, (tab32, idx, wa, wb), want, timed in cases:
        rows = int(torch.unique(idx.clamp(0, tab32.shape[0] - 1)).numel())
        for wire, tab in (("f32", tab32), ("bf16", tab32.bfloat16())):
            m, r = tab.shape
            B, L = idx.shape
            path = 0 if want == "auto" else want
            if path == 1 and gram.gram_resident_bytes(
                    m, r, tab.element_size()) > optin:
                continue  # rank 128 in f32: the table does not fit
            plan = gram.table_plan(m, r, tab.element_size(), B, L, n_sm,
                                   optin, path, tab.data_ptr() % 16 == 0)
            name = f"gram_table {tag} {wire}"
            gram.LAUNCHES = 0
            A, b = gram.gram_table(tab, idx, wa, wb, path=path)
            torch.cuda.synchronize()
            check(gram.LAUNCHES == 1 and gram.LAST_PATH == plan.path,
                  f"{name}: {gram.LAUNCHES} launches, path "
                  f"{gram.LAST_PATH}, plan {plan.path}")
            check(torch.equal(A, A.transpose(1, 2)),
                  f"{name}: A is not exactly symmetric")
            if plan.splits > 1:
                A2, b2 = gram.gram_table(tab, idx, wa, wb, path=path)
                torch.cuda.synchronize()
                check(torch.equal(A, A2) and torch.equal(b, b2),
                      f"{name}: two runs of {plan.splits} splits differ")
                del A2, b2
            Ar, br = gram.gram_table_reference(tab, idx, wa, wb)
            # the same function for the library's gather: an index outside
            # the table a clipped one with no weight (and no weight in the
            # tolerance)
            out = (idx < 0) | (idx >= m)
            ref = (tab, idx.clamp(0, m - 1), wa.masked_fill(out, 0.0),
                   wb.masked_fill(out, 0.0))
            err = check_gram(name, A, b, Ar, br, tab, ref[2], ref[3])
            del A, b, Ar, br
            line = (f"phase gram-table: {tag} {wire} m={m} r={r} B={B} "
                    f"L={L} path={plan.path} plan=(workers={plan.workers} "
                    f"warps={plan.warps} threads={plan.threads} "
                    f"blocks={plan.blocks} splits={plan.splits} "
                    f"smem={plan.smem_bytes} staging="
                    f"{'cp.async-16B' if plan.vec16 else 'element-wise'}) "
                    f"max_abs_err={err:.3e}")
            if timed:
                call = lambda: gram.gram_table(tab, idx, wa, wb, path=path)
                ms = median_ms(call, 10)
                q_ms = queued_ms(call, 10)
                plain_ms = median_ms(lambda: gram.gram_table_reference(
                    tab, idx, wa, wb), 3)
                lib_ms = median_ms(lambda: library_gram(*ref), 3)
                b_ms, b_by, tc_ms, tc_by = table_bounds(
                    B, L, rows, r, tab.element_size(),
                    2 if wire == "bf16" else 3)
                line += (f" ms={ms:.4f} queued_ms={q_ms:.4f} "
                         f"bound_ms={b_ms:.5f} bound_by={b_by} "
                         f"tc_bound_ms={tc_ms:.5f} tc_bound_by={tc_by} "
                         f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f}")
                results.append((tag, wire, plan.path, ms))
                if tag == "ML-20M block" and wire == "f32":
                    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": b_ms, "bound_by": b_by,
                           "library_ms": lib_ms, "queued_ms": q_ms,
                           "tc_bound_ms": tc_ms}
            print(line, flush=True)
    by = {(t, w, p): ms for t, w, p, ms in results}
    for wire in ("f32", "bf16"):
        p1 = by.get((f"512x{RANK} 1", wire, 1))
        p2 = by.get((f"512x{RANK} 2", wire, 2))
        print(f"phase gram-table: 512x{RANK} {wire} path 1 / path 2 ms "
              f"{p1:.4f} / {p2:.4f} ({p1 / p2:.3f}x)", flush=True)
    return row  # the ML-20M block in f32, the same work as fused_gram's row


#: the lifecycle's subset of the surrogate: every rating of 1 user in 10
#: fold-in blocks of phase stream-kernel: touched rows, history width
STREAM_BLOCKS = ((64, 512), (2048, 512))


def phase_stream_kernel(item_factors, seed: int, dev) -> dict:
    """``fold_in_rows`` on the card against the trained item table (f32,
    and its int8 serving table), explicit and implicit with a cached
    ``G``, each held against the same call on CPU copies (the plain
    versions): |x - x_cpu| <= 1e-4 + 1e-3 |x_cpu|."""
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops import fused_gram as fg
    from predictionio_tpu_torch.ops import solve as sv

    V = item_factors.contiguous()
    n_rows, r = V.shape
    qd, qs = als._quantize_rows(V.cpu().numpy(), "int8")
    tables = {"f32": V, "int8": als.QuantizedFactors(qd, qs, "int8").to(dev)}
    rng = np.random.default_rng(seed + 6)
    out = {"fused_gram": 0, "chol_solve": 0}
    for B, L in STREAM_BLOCKS:
        idx = rng.integers(0, n_rows, size=(B, L)).astype(np.int32)
        val = (rng.integers(1, 11, size=(B, L)) / 2).astype(np.float32)
        cnt = rng.integers(L // 2, L + 1, size=B).astype(np.int32)
        cnt[0] = L
        for kind in ("explicit", "implicit"):
            params = als.ALSParams(rank=r, implicit_prefs=kind == "implicit")
            for wire, table in tables.items():
                cpu = table.to(torch.device("cpu")) \
                    if isinstance(table, als.QuantizedFactors) else table.cpu()
                G = als.fixed_gramian(table, params)
                G_cpu = als.fixed_gramian(cpu, params)

                def call():
                    return als.fold_in_rows(table, idx, val, cnt, params, G=G)

                before = (fg.LAUNCHES, sv.LAUNCHES)
                x = call()
                launched = (fg.LAUNCHES - before[0], sv.LAUNCHES - before[1])
                check(launched[0] > 0 and launched[1] > 0,
                      f"fold-in B={B}: launches fused_gram={launched[0]} "
                      f"chol_solve={launched[1]}")
                xp = als.fold_in_rows(cpu, idx, val, cnt, params, G=G_cpu)
                err = np.abs(x - xp)
                tag = f"fold_in_rows {kind} {wire} B={B} L={L}"
                check(bool(np.isfinite(x).all()), f"{tag}: non-finite rows")
                check(bool((err <= 1e-4 + 1e-3 * np.abs(xp)).all()),
                      f"{tag}: rows off the CPU copies by {err.max():.3e}")
                ms = median_ms(call, 5)
                g_ms, p_ms, c_ms, s_ms = kernel_ms(
                    call, 3, ("gram_rows_kernel", "sum_partials",
                              "chol_solve_regs", "chol_solve_smem"))
                gb, gby = gram_bound(B, L, min(n_rows, B * L), r, "f32")
                sb, sby = solve_bound(B, r)
                print(f"phase stream-kernel: {tag} launched fused_gram="
                      f"{launched[0]} chol_solve={launched[1]} max_abs_err="
                      f"{err.max():.3e} ms={ms:.4f} (event-timed call, host "
                      f"packing and copies included) | device fused_gram_ms="
                      f"{g_ms + p_ms:.4f} (bound {gb:.4f} by {gby}) "
                      f"chol_solve_ms={c_ms + s_ms:.4f} (bound {sb:.5f} by "
                      f"{sby})", flush=True)
                out["fused_gram"] += launched[0]
                out["chol_solve"] += launched[1]
    return out


PIO_USER_STRIDE = 10
PIO_APP = "MyApp1"
#: rows per npz column block of the bulk ingest route
PIO_BLOCK = 100_000
#: phase pio's first event time (ms since the epoch), and its events sent
#: one a POST and fifty a POST (at second resolution) before the blocks
PIO_T0_MS = 1_700_000_000_000
PIO_SINGLE, PIO_BATCHED = 50, 250


def pio_event_times(n: int) -> np.ndarray:
    """The event times (ms) phase pio's ingest gives its ``n`` events: the
    single and batched POSTs' at second resolution, then ``t0 + k``."""
    t = PIO_T0_MS + np.arange(n, dtype=np.int64)
    head = PIO_SINGLE + PIO_BATCHED
    t[:head] = t[:head] // 1000 * 1000
    return t


def write_rating_jsonl(path, users, items, stars,
                       chunk: int = 100_000) -> int:
    """Phase pio's ``rate`` events as JSON lines in ``cli export``'s
    format (its keys, order and spacing; an event id and a creation time
    a line), in the order phase pio ingested them: what phase storage
    imports. Returns the lines written."""
    n = len(users)
    times = np.datetime_as_string(
        pio_event_times(n).astype("datetime64[ms]"), unit="ms").tolist()
    with open(path, "w", encoding="utf-8") as f:
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            f.write("".join(
                f'{{"event": "rate", "entityType": "user", "entityId": '
                f'"u{u}", "eventId": "{k:032x}", "targetEntityType": '
                f'"item", "targetEntityId": "i{i}", "properties": '
                f'{{"rating": {r!r}}}, "eventTime": "{t}Z", '
                f'"creationTime": "{t}Z"}}\n'
                for k, u, i, r, t in zip(
                    range(s, e), users[s:e].tolist(), items[s:e].tolist(),
                    [float(x) for x in stars[s:e].tolist()], times[s:e])))
    return n

#: the eval phase's folds, answer length and the grid's iteration counts
EVAL_K, EVAL_QUERY_NUM, EVAL_ITERS = 2, 10, (5, 10)

#: the evaluation ``cli eval chip_smoke:EVALUATION chip_smoke:GRID`` runs:
#: the shipped example's (its metrics, Precision@10 at threshold 4.0 the
#: one optimized), on the grid below
EVALUATION = recommendation_evaluation.evaluation


class _EvalGrid(EngineParamsGenerator):
    """2 folds of the ``pio`` store x ALS at rank 64 with 5 and 10
    iterations."""

    engine_params_list = [
        EngineParams(
            datasource=("", DataSourceParams(
                app_name=PIO_APP, eval_k=EVAL_K,
                eval_query_num=EVAL_QUERY_NUM)),
            algorithms=[("als", ALSParams(rank=RANK, num_iterations=it,
                                          reg=0.01, seed=3))])
        for it in EVAL_ITERS
    ]


GRID = _EvalGrid()


def rating_block(users, items, stars, t0_ms: int):
    """One npz column block of ``rate`` events with their ``rating``
    property as JSON bytes (what the row store keeps), built with numpy
    and no per-event objects."""
    from predictionio_tpu_torch.data.columnar import (
        ColumnarBatch,
        ColumnarDicts,
        StringDict,
    )
    from predictionio_tpu_torch.data.storage.wire import batch_to_npz

    n = len(users)
    uu, u_codes = np.unique(users, return_inverse=True)
    ii, i_codes = np.unique(items, return_inverse=True)
    vals, v_codes = np.unique(stars, return_inverse=True)
    props = [json.dumps({"rating": float(v)}).encode() for v in vals]
    lens = np.array([len(p) for p in props], np.int64)[v_codes]
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    blob = np.frombuffer(b"".join([props[c] for c in v_codes.tolist()]),
                         np.uint8)
    zeros = np.zeros(n, np.int32)
    batch = ColumnarBatch(
        event=zeros, entity_type=zeros, entity_id=u_codes.astype(np.int32),
        target_type=zeros, target_id=i_codes.astype(np.int32),
        event_time=t0_ms + np.arange(n, dtype=np.int64),
        props_offsets=offsets, props_blob=blob,
        float_props={"rating": stars.astype(np.float64)},
        dicts=ColumnarDicts(
            event_names=StringDict(["rate"]),
            entity_types=StringDict(["user"]),
            entity_ids=StringDict([f"u{x}" for x in uu.tolist()]),
            target_types=StringDict(["item"]),
            target_ids=StringDict([f"i{x}" for x in ii.tolist()])))
    return batch_to_npz(batch)


def _http(port, method, path, body=None, raw=None) -> tuple:
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method)
    with _LOCAL.open(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read() or b"null")


def triples(u, i, r) -> np.ndarray:
    """(user, item, rating) rows in one order, for multiset equality."""
    order = np.lexsort((r, i, u))
    return np.stack([u[order].astype(np.float64), i[order].astype(np.float64),
                     r[order].astype(np.float64)], axis=1)


def id_numbers(bimap, n: int) -> np.ndarray:
    """Dense row -> the number in its "u<n>"/"i<n>" id."""
    out = np.empty(n, np.int64)
    for k, j in bimap.items():
        out[j] = int(k[1:])
    return out


#: the app phase 8's feedback deploy records its answers in: an app of
#: its own, since later phases read the ratings app
PIO_FEEDBACK_APP = "FeedbackApp"
#: what the feedback deploy's remote log puts before every message
PIO_LOG_PREFIX = "chip-smoke: "
#: the 5xx phase 8 forces on the feedback deploy (one failed dispatch)
PIO_LOG_FAULT = "serving.dispatch=error,times=1"
#: the engine id of phase 8's instance whose stored model is None, and the
#: answers its deploy (a retrain) gives
PIO_RETRAIN_ENGINE_ID = "retrain"
PIO_RETRAIN_QUERIES = 16


class LogCollector:
    """A sink for ``ServerConfig.log_url`` on a free port: the body of
    every POST, in order."""

    def __init__(self) -> None:
        from predictionio_tpu_torch.server.http import (
            AppServer,
            HTTPApp,
            json_response,
        )

        self.received: list = []
        app = HTTPApp("log-collector")

        @app.route("POST", "/log")
        def sink(req):
            self.received.append(req.body.decode("utf-8"))
            return json_response({"ok": True})

        self.server = AppServer(app, "127.0.0.1", 0).start_background()
        self.url = f"http://127.0.0.1:{self.server.port}/log"

    def close(self) -> None:
        self.server.close()


class AccessLines(logging.Handler):
    """The engine servers' JSON access-log lines while attached (the
    logger's level raised to INFO, kept from the root's handlers)."""

    def __init__(self) -> None:
        super().__init__(logging.INFO)
        self.lines: list = []
        self.log = logging.getLogger("predictionio_tpu_torch.access")

    def __enter__(self) -> "AccessLines":
        self._saved = (self.log.level, self.log.propagate)
        self.log.setLevel(logging.INFO)
        self.log.propagate = False
        self.log.addHandler(self)
        return self

    def __exit__(self, *exc) -> None:
        self.log.removeHandler(self)
        self.log.setLevel(self._saved[0])
        self.log.propagate = self._saved[1]

    def emit(self, record) -> None:
        self.lines.append(json.loads(record.getMessage()))


def bound_tables64(srv) -> tuple:
    """(ud, us, vd, vs, U64, V64) of a deploy's bound ALS model."""
    from predictionio_tpu_torch.models.als import _table_leaves

    m = srv.query_server.models[0]
    ud, us = _table_leaves(m.user_factors)
    vd, vs = _table_leaves(m.item_factors)
    U64 = ud.double() * (us.double() if us is not None else 1.0)
    V64 = vd.double() * (vs.double() if vs is not None else 1.0)
    return ud, us, vd, vs, U64, V64


def pio_feedback(storage, engine_json: Path, inst, queries: list,
                 off_port: int, app_id: int, n_events: int, dev) -> dict:
    """Phase 8's stored model deployed with the feedback loop on, into an
    app of its own, with the remote log pointed at a collector here. (a)
    Counted: the queries on it alone, ``fused_topk`` launched; each
    answer's ``prId`` names one ``pio_pr``/``predict`` event whose
    ``prediction`` is the answer without it, every answer held to the
    float64 top-k. (b) The same queries in turns with the deploy without
    feedback (``off_port``): the client p50 / p99 of each and the
    per-query ``feedbackMs`` of the access log. (c) One 5xx through the
    ``serving.dispatch`` fault point: the collector receives exactly one
    message, prefixed, naming the instance; ``close()`` leaves no
    thread. The ratings app's event count stays ``n_events``; the
    feedback app is deleted after."""
    from predictionio_tpu_torch import cli, faults
    from predictionio_tpu_torch.controller.context import Context
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.server.engineserver import (
        ServerConfig,
        deploy,
    )

    with contextlib.redirect_stdout(io.StringIO()):
        check(cli.main(["app", "new", PIO_FEEDBACK_APP], storage=storage)
              == 0, "app new of the feedback app failed")
    fb_app = storage.apps().get_by_name(PIO_FEEDBACK_APP)
    variant = json.loads(Path(engine_json).read_text())
    engine, ep = cli.engine_from_variant(variant)
    before = {t.ident for t in threading.enumerate()}
    collector = LogCollector()
    t = time.perf_counter()
    srv = deploy(Context(device=dev, _storage=storage), engine, ep,
                 engine_id=inst.engine_id,
                 engine_version=inst.engine_version,
                 engine_variant=inst.engine_variant,
                 config=ServerConfig(batching=True, feedback=True,
                                     feedback_app_name=PIO_FEEDBACK_APP,
                                     log_url=collector.url,
                                     log_prefix=PIO_LOG_PREFIX),
                 host="127.0.0.1", port=0).start_background()
    closed = False
    try:
        warmed(srv)
        bind_s = time.perf_counter() - t
        tables = bound_tables64(srv)
        n_items = srv.query_server.models[0].n_items
        model = srv.query_server.models[0]
        # (a) counted, on its own
        ft.LAUNCHES = 0
        answered = [(q, _post(srv.port, q)[0]) for q in queries]
        launches = ft.LAUNCHES
        check(launches > 0, "the feedback deploy launched fused_topk no "
              "time")
        # (b) in turns with the deploy without feedback
        lat = {"on": [], "off": []}
        with AccessLines() as access:
            for q in queries:
                lat["off"].append(_post(off_port, q)[1])
                a, s_on = _post(srv.port, q)
                lat["on"].append(s_on)
                answered.append((q, a))
        fb_ms = np.array([ln["feedbackMs"] for ln in access.lines
                          if "feedbackMs" in ln])
        check(len(fb_ms) == len(queries),
              f"{len(fb_ms)} access-log lines carry feedbackMs for "
              f"{len(queries)} feedback answers")
        events = {e.entity_id: e for e in storage.events().find(fb_app.id)}
        check(len(events) == len(answered),
              f"{len(events)} feedback events for {len(answered)} answers")
        for q, a in answered:
            pr_id = a.get("prId", "")
            ev = events.get(pr_id)
            check(ev is not None and len(pr_id) == 64,
                  f"{q}: no feedback event for prId {pr_id!r}")
            props = ev.properties.to_dict()
            check((ev.event, ev.entity_type) == ("predict", "pio_pr")
                  and props["engineInstanceId"] == inst.id
                  and props["query"] == q
                  and props["prediction"] == {k: v for k, v in a.items()
                                              if k != "prId"},
                  f"{q}: feedback event {ev.to_json()} does not record "
                  f"the answer")
            check_answer(q, a, *tables, n_items, dev, model.user_ids,
                         model.item_ids)
        # (c) one 5xx, shipped once
        faults.inject_spec(PIO_LOG_FAULT)
        try:
            _post(srv.port, queries[0])
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
        finally:
            faults.clear()
        check(code == 500, f"the injected dispatch fault answered {code}")
        srv.close()  # joins the remote log's shipping thread
        closed = True
        msgs = collector.received
        check(len(msgs) == 1 and msgs[0].startswith(PIO_LOG_PREFIX),
              f"the collector received {msgs}")
        body = json.loads(msgs[0][len(PIO_LOG_PREFIX):])
        check(body["engineInstance"] == inst.id and body["message"],
              f"the remote log message {body} does not name {inst.id}")
    finally:
        if not closed:
            srv.close()
        collector.close()
    left = storage_threads_left(before)
    check(not left, f"the feedback deploy left threads {left}")
    n_after = storage.events().find_columnar(app_id, ordered=False,
                                             with_props=False).n
    check(n_after == n_events, f"the ratings app holds {n_after} events "
          f"after the feedback deploy, {n_events} before")
    with contextlib.redirect_stdout(io.StringIO()):
        check(cli.main(["app", "delete", PIO_FEEDBACK_APP, "--force"],
                       storage=storage) == 0, "app delete failed")
    on, off = np.array(lat["on"]) * 1e3, np.array(lat["off"]) * 1e3
    print(f"phase pio feedback: deploy with --feedback to warm "
          f"{bind_s:.3f}s | {len(answered)} answers, each one "
          f"pio_pr/predict event with its prId and prediction, held to "
          f"float64 | fused_topk launches={launches} for {len(queries)} "
          f"queries | in turns, {len(queries)} each: feedback on p50_ms="
          f"{np.percentile(on, 50):.3f} p99_ms={np.percentile(on, 99):.3f}"
          f" off p50_ms={np.percentile(off, 50):.3f} p99_ms="
          f"{np.percentile(off, 99):.3f} | feedbackMs p50="
          f"{np.percentile(fb_ms, 50):.3f} p99={np.percentile(fb_ms, 99):.3f}"
          f" | remote log: 1 5xx, 1 message to the collector | ratings "
          f"app events {n_after} unchanged | no thread left", flush=True)
    return {"fused_topk": launches}


def pio_retrain(storage, inst, model, queries: list, dev) -> dict:
    """An instance of phase 8's variant whose stored model is None (an
    algorithm that persists nothing): its deploy retrains on the card
    before it binds. ``fused_gram`` and ``chol_solve`` counted from zero
    to the bind (before the first answer), both positive; every answer
    held to the float64 top-k of the retrained factors. The instance is
    removed after, so later phases see phase 8's alone."""
    from predictionio_tpu_torch import cli
    from predictionio_tpu_torch.controller.context import Context
    from predictionio_tpu_torch.data.storage.base import Model
    from predictionio_tpu_torch.server.engineserver import (
        ServerConfig,
        deploy,
    )
    from predictionio_tpu_torch.workflow.persistence import dumps_models

    iid = storage.engine_instances().insert(inst.copy(
        id="", engine_id=PIO_RETRAIN_ENGINE_ID))
    storage.models().insert(Model(id=iid, models=dumps_models([None])))
    try:
        variant = json.loads(Path(inst.engine_variant).read_text())
        engine, ep = cli.engine_from_variant(variant)
        zero_launch_counts()
        t = time.perf_counter()
        srv = deploy(Context(device=dev, _storage=storage), engine, ep,
                     engine_id=PIO_RETRAIN_ENGINE_ID,
                     engine_version=inst.engine_version,
                     engine_variant=inst.engine_variant,
                     config=ServerConfig(batching=True), host="127.0.0.1",
                     port=0)
        bind_s = time.perf_counter() - t
        launches = launch_counts()
        try:
            check(launches["fused_gram"] > 0 and launches["chol_solve"] > 0,
                  f"the deploy of a None model launched {launches} before "
                  f"its first answer")
            srv.start_background()
            answers = [_post(srv.port, q) for q in queries]
            first_s = time.perf_counter() - t
            bound = srv.query_server.models[0]
            tables = bound_tables64(srv)
            for q, (a, _) in zip(queries, answers):
                check_answer(q, a, *tables, bound.n_items, dev,
                             bound.user_ids, bound.item_ids)
            nu, ni = bound.n_users, bound.n_items
            dU = float((bound.user_factors[:nu].float().cpu()
                        - model.user_factors[:nu].float()).abs().max())
            dV = float((bound.item_factors[:ni].float().cpu()
                        - model.item_factors[:ni].float()).abs().max())
        finally:
            srv.close()
    finally:
        storage.engine_instances().delete(iid)
        storage.models().delete(iid)
    print(f"phase pio retrain: the deploy of instance {iid} (stored model "
          f"None) retrained before binding: deploy call {bind_s:.3f}s, "
          f"first answer at {first_s:.3f}s | launches before the first "
          f"answer fused_gram={launches['fused_gram']} chol_solve="
          f"{launches['chol_solve']} | {len(answers)} answers held to the "
          f"float64 top-k of the retrained factors | max |d| against cli "
          f"train's factors U={dU:.3e} V={dV:.3e}", flush=True)
    return {"fused_gram": launches["fused_gram"],
            "chol_solve": launches["chol_solve"]}


def phase_pio(data, dev, home: str) -> dict:
    from predictionio_tpu_torch import cli
    from predictionio_tpu_torch.controller.context import Context
    from predictionio_tpu_torch.data.storage.base import STATUS_COMPLETED
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.models.als import _table_leaves
    from predictionio_tpu_torch.ops import fused_gram as fg
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.ops import gram
    from predictionio_tpu_torch.ops import solve as sv
    from predictionio_tpu_torch.templates.recommendation import (
        DataSourceParams,
        RecommendationDataSource,
    )
    from predictionio_tpu_torch.workflow.persistence import loads_models

    users, items, stars = data[:3]
    keep = users % PIO_USER_STRIDE == 0
    users, items, stars = users[keep], items[keep], stars[keep]
    n = len(users)
    root = Path(__file__).resolve().parent
    storage = Storage(env={"PIO_HOME": home})
    try:
        check(cli.main(["app", "new", PIO_APP], storage=storage) == 0,
              "app new failed")
        app = storage.apps().get_by_name(PIO_APP)
        key = storage.access_keys().get_by_app_id(app.id)[0].key
        q = f"?accessKey={key}"
        args = cli._parser().parse_args(["eventserver", "--ip", "127.0.0.1",
                                         "--port", "0"])
        srv = cli.build_eventserver(args, storage).start_background()
        t0_ms = PIO_T0_MS

        def event(k: int) -> dict:
            return {"event": "rate", "entityType": "user",
                    "entityId": f"u{users[k]}", "targetEntityType": "item",
                    "targetEntityId": f"i{items[k]}",
                    "properties": {"rating": float(stars[k])},
                    "eventTime": time.strftime(
                        "%Y-%m-%dT%H:%M:%S.000Z",
                        time.gmtime((t0_ms + k) // 1000))}

        try:
            t_ingest = time.perf_counter()
            n_single, n_batch = PIO_SINGLE, PIO_BATCHED
            for k in range(n_single):
                status, _ = _http(srv.port, "POST", f"/events.json{q}",
                                  event(k))
                check(status == 201, f"/events.json answered {status}")
            for s in range(n_single, n_single + n_batch, 50):
                status, body = _http(srv.port, "POST",
                                     f"/batch/events.json{q}",
                                     [event(k) for k in range(s, s + 50)])
                check(status == 200 and all(r["status"] == 201
                                            for r in body),
                      "/batch/events.json refused an event")
            block_s = []
            for s in range(n_single + n_batch, n, PIO_BLOCK):
                e = min(s + PIO_BLOCK, n)
                raw = rating_block(users[s:e], items[s:e], stars[s:e],
                                   t0_ms + s)
                t = time.perf_counter()
                status, body = _http(srv.port, "POST",
                                     f"/columnar/events.npz{q}", raw=raw)
                block_s.append(time.perf_counter() - t)
                check(status == 201 and body["accepted"] == e - s,
                      f"/columnar/events.npz: {status} {body}")
            ingest_s = time.perf_counter() - t_ingest
            probe = int(users[0])
            status, got = _http(srv.port, "GET",
                                f"/events.json{q}&entityType=user&entityId="
                                f"u{probe}&limit=-1")
            mine = users == probe
            want = sorted(zip([f"i{x}" for x in items[mine]],
                              stars[mine].tolist()))
            check(status == 200 and sorted(
                (g["targetEntityId"], g["properties"]["rating"])
                for g in got) == want,
                  f"GET /events.json of u{probe} differs from what was sent")
        finally:
            srv.close()

        t = time.perf_counter()
        threads = threading.active_count()
        batch = storage.events().find_columnar(app.id, ordered=False,
                                               with_props=False)
        find_cold_s = time.perf_counter() - t
        encode = dict(storage.events().last_encode)
        # a process with threads never forks its encode: a child forked
        # from it could inherit a held lock (phase storage's threaded
        # child reads the same store in-process)
        check(threads == 1 or encode.get("path") == "in-process",
              f"a process with {threads} threads encoded {encode}")
        ctx = Context(device=dev, _storage=storage)
        td = RecommendationDataSource(DataSourceParams(
            app_name=PIO_APP)).read_training(ctx)
        r = td.ratings
        u_num = id_numbers(td.user_ids, r.n_users)
        i_num = id_numbers(td.item_ids, r.n_items)
        check(batch.n == n and np.array_equal(
            triples(u_num[r.users], i_num[r.items], r.ratings),
            triples(users, items, stars)),
              "the store did not read back the ingested ratings")

        variant = json.loads((root / "examples" / "recommendation" /
                              "engine.json").read_text())
        variant["datasource"] = {"params": {"app_name": PIO_APP}}
        variant["algorithms"] = [{"name": "als", "params": {
            "rank": RANK, "num_iterations": TRAIN_ITERS}}]
        engine_json = Path(home) / "engine.json"
        engine_json.write_text(json.dumps(variant))

        # -- the lifecycle's training, counted -------------------------
        fg.LAUNCHES = sv.LAUNCHES = gram.LAUNCHES = 0
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["train", "--engine-json", str(engine_json)],
                          storage=storage)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        launches = {"fused_gram": fg.LAUNCHES, "chol_solve": sv.LAUNCHES,
                    "gram_table": gram.LAUNCHES}
        # ----------------------------------------------------------------
        check(rc == 0, f"cli train returned {rc}: {out.getvalue()}")
        check(launches["fused_gram"] > 0, "cli train launched fused_gram "
              "no time")
        check(launches["chol_solve"] > 0, "cli train launched chol_solve "
              "no time")
        stages = json.loads(next(
            ln for ln in out.getvalue().splitlines()
            if ln.startswith("Train stages: "))[len("Train stages: "):])
        (inst,) = storage.engine_instances().get_all()
        check(inst.status == STATUS_COMPLETED,
              f"engine instance {inst.id} is {inst.status}")

        (model,) = loads_models(storage.models().get(inst.id).models)
        u_t = torch.from_numpy(r.users.astype(np.int64)).to(dev)
        i_t = torch.from_numpy(r.items.astype(np.int64)).to(dev)
        s_t = torch.from_numpy(r.ratings).to(dev)
        rmse_10 = rmse(model.user_factors.to(dev), model.item_factors.to(dev),
                       u_t, i_t, s_t)
        one = als.ALSParams(rank=RANK, num_iterations=1)
        U1, V1 = als.train_als(r, one, device=dev)
        rmse_1 = rmse(U1, V1, u_t, i_t, s_t)
        check(np.isfinite(rmse_10) and rmse_10 < rmse_1,
              f"lifecycle RMSE {rmse_10:.4f} after {TRAIN_ITERS} is not "
              f"below {rmse_1:.4f} after 1")
        del U1, V1

        # -- the lifecycle's deploy, counted -----------------------------
        ft.LAUNCHES = 0
        args = cli._parser().parse_args([
            "deploy", "--engine-json", str(engine_json), "--ip",
            "127.0.0.1", "--port", "0", "--batching"])
        rng = np.random.default_rng(17)
        picks = rng.choice(np.unique(users), 64, replace=False)
        queries = [{"user": f"u{u}", "num": 10} for u in picks]
        queries[0]["blackList"] = [f"i{x}" for x in items[users == picks[0]][:3]]
        t = time.perf_counter()
        srv = cli.build_deploy(args, storage).start_background()
        try:
            answers = [_post(srv.port, queries[0])]
            first_s = time.perf_counter() - t
            answers += [_post(srv.port, qq) for qq in queries[1:]]
            dep_launches = ft.LAUNCHES
            bound_model = srv.query_server.models[0]
            ud, us = _table_leaves(bound_model.user_factors)
            vd, vs = _table_leaves(bound_model.item_factors)
            U64 = ud.double() * (us.double() if us is not None else 1.0)
            V64 = vd.double() * (vs.double() if vs is not None else 1.0)
            for qq, (a, _) in zip(queries, answers):
                check_answer(qq, a, ud, us, vd, vs, U64, V64,
                             bound_model.n_items, dev,
                             bound_model.user_ids, bound_model.item_ids)
            with _LOCAL.open(f"http://127.0.0.1:{srv.port}/status.json",
                             timeout=30) as resp:
                status = json.loads(resp.read())
            t = time.perf_counter()
            feedback_l = pio_feedback(storage, engine_json, inst,
                                      queries[1:], srv.port, app.id, n, dev)
            feedback_s = time.perf_counter() - t
        finally:
            srv.close()
        t = time.perf_counter()
        retrain_l = pio_retrain(storage, inst, model,
                                queries[:PIO_RETRAIN_QUERIES], dev)
        retrain_s = time.perf_counter() - t
        check(dep_launches > 0, "the deploy launched fused_topk no time")
        check(status["engineInstanceId"] == inst.id,
              "deploy bound another instance")
        lat = np.array([s for _, s in answers[1:]]) * 1e3
        print(f"phase pio: {n} rate events of {len(np.unique(users))} users "
              f"x {len(np.unique(items))} items (1 user in "
              f"{PIO_USER_STRIDE}) | ingest {n_single} single + {n_batch} "
              f"batched + {n - n_single - n_batch} in {len(block_s)} npz "
              f"blocks in {ingest_s:.3f}s = {n / ingest_s:.1f} events/s "
              f"(a block's POST first {block_s[0]:.3f}s last "
              f"{block_s[-1]:.3f}s max {max(block_s):.3f}s) | "
              f"find_columnar cold {find_cold_s:.3f}s (encode "
              f"{encode.get('path')}, {threads} threads) | cli train "
              f"{train_s:.3f}s stages {stages} | Engine.train window "
              f"{sum(stages[k] for k in ('read_s', 'prepare_s', 'algo_train_s')) / TRAIN_ITERS * 1e3:.2f}"
              f" ms an iteration | launches fused_gram="
              f"{launches['fused_gram']} chol_solve={launches['chol_solve']}"
              f" gram_table={launches['gram_table']} | rmse after 1="
              f"{rmse_1:.4f} after {TRAIN_ITERS}={rmse_10:.4f} | deploy to "
              f"first answer {first_s:.3f}s servingQuant="
              f"{status['servingQuant']} | 63 queries p50_ms="
              f"{np.percentile(lat, 50):.3f} p99_ms="
              f"{np.percentile(lat, 99):.3f} fused_topk launches="
              f"{dep_launches} | instance {inst.id} {inst.status} | "
              f"feedback checks {feedback_s:.2f}s, retrain on deploy "
              f"{retrain_s:.2f}s", flush=True)
        return {"gram_table_launches": launches["gram_table"],
                "feedback": feedback_l, "retrain": retrain_l,
                "encode": encode,
                "engine_json": str(engine_json), "log_end_ms": t0_ms + n,
                "find_cold_s": find_cold_s}
    finally:
        storage.close()


#: the storage phase's LOCALFS step: every 80th user (the cut of depth)
STORAGE_LOCALFS_STRIDE = 80
#: answers the storage phase's deploy holds to float64
STORAGE_QUERIES = 64
STORAGE_SECRET = "chip-smoke-pod"
#: the longest one command of the storage phase may take
STORAGE_TIMEOUT_S = 600.0

#: ``cli`` in a fresh process, then its kernel launches, the event
#: store's last sidecar encode (SQLite), its last columnar pull (REMOTE)
#: and the process's seconds on one line
CLI_COUNTED_MAIN = """\
import json, sys, time
t0 = time.perf_counter()
from predictionio_tpu_torch import cli
from predictionio_tpu_torch.data.storage.registry import get_storage
from predictionio_tpu_torch.ops import fused_gram, fused_topk, gram, solve
rc = cli.main(sys.argv[1:])
ev = get_storage().events()
print("COUNTED " + json.dumps({
    "fused_gram": fused_gram.LAUNCHES, "chol_solve": solve.LAUNCHES,
    "gram_table": gram.LAUNCHES, "fused_topk": fused_topk.LAUNCHES,
    "encode": getattr(ev, "last_encode", None),
    "pull": getattr(getattr(ev, "c", None), "last_columnar", None),
    "seconds": time.perf_counter() - t0}), flush=True)
sys.exit(rc)
"""

#: phase ``storage``'s LOCALFS step in a process of its own (it runs
#: beside the SEGMENTFS steps): the exported lines of every STRIDE-th
#: user cut into a file of their own, ``cli import`` of it into a new
#: LOCALFS store, then ``find_columnar`` from a fresh client; the (user,
#: item, rating) numbers go to an npz, the seconds to stdout
LOCALFS_MAIN = """\
import contextlib, io, json, re, sys, time
import numpy as np
from predictionio_tpu_torch import cli
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.models.data import ratings_from_columnar
root, exported, src, out, app, stride = sys.argv[1:7]
t = time.perf_counter()
pattern = re.compile(rb'"entityId": "u(\\d+)"')
with open(exported, "rb") as f_in, open(src, "wb") as f_out:
    for line in f_in:
        if int(pattern.search(line).group(1)) % int(stride) == 0:
            f_out.write(line)
cut_s = time.perf_counter() - t
env = {"PIO_STORAGE_SOURCES_L_TYPE": "LOCALFS",
       "PIO_STORAGE_SOURCES_L_PATH": root}
st = Storage(env=env)
log = io.StringIO()
with contextlib.redirect_stdout(log):
    assert cli.main(["app", "new", app], storage=st) == 0
    t = time.perf_counter()
    assert cli.main(["import", "--app", app, "--input", src],
                    storage=st) == 0
    import_s = time.perf_counter() - t
app_id = st.apps().get_by_name(app).id
st.close()
st = Storage(env=env)
t = time.perf_counter()
batch = st.events().find_columnar(app_id, ordered=False, with_props=False)
find_s = time.perf_counter() - t
r, uids, iids = ratings_from_columnar(batch)
num = lambda bm, n: np.array([int(k[1:]) for k, _ in
                              sorted(bm.items(), key=lambda kv: kv[1])],
                             np.int64).reshape(n)
np.savez(out, users=num(uids, r.n_users)[r.users],
         items=num(iids, r.n_items)[r.items], ratings=r.ratings)
print(json.dumps({"cut_s": cut_s, "import_s": import_s, "find_s": find_s,
                  "n": batch.n}), flush=True)
"""


#: phase ``storage``'s threaded reader in a process of its own (it runs
#: beside the SEGMENTFS steps): a second thread alive, then the cold
#: ``find_columnar`` of a copy of the ``pio`` store without its sidecar;
#: the store must encode in-process (a process with threads never forks:
#: a child forked from it could inherit a held lock)
INPROC_MAIN = """\
import json, sys, threading, time
from predictionio_tpu_torch.data.storage.registry import Storage
home, app = sys.argv[1:3]
hold = threading.Event()
other = threading.Thread(target=hold.wait, name="held-open")
other.start()
try:
    st = Storage(env={"PIO_HOME": home})
    app_id = st.apps().get_by_name(app).id
    threads = threading.active_count()
    t = time.perf_counter()
    batch = st.events().find_columnar(app_id, ordered=False,
                                      with_props=False)
    read_s = time.perf_counter() - t
    encode = dict(st.events().last_encode)
    st.close()
finally:
    hold.set()
    other.join()
print(json.dumps({"threads": threads, "encode": encode, "n": batch.n,
                  "read_s": read_s}), flush=True)
"""


class GCPauses:
    """Seconds the cyclic garbage collector held this process, summed
    while installed (``gc.callbacks``)."""

    def __init__(self):
        self.s = 0.0
        self._t0 = None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.s += time.perf_counter() - self._t0
            self._t0 = None

    def close(self) -> None:
        gc.callbacks.remove(self._cb)


class EncodeSplit:
    """Seconds of the SEGMENTFS sidecar encode by part, summed while
    installed: parse (the codec's ``parse_segment`` blocks), hash (the
    event ids' blake2b), timestamps (ISO strings to millis), dictionaries
    (``columnar_from_columns``) and write (segments, dictionaries,
    manifest, id hashes)."""

    def __init__(self):
        from predictionio_tpu_torch.data import columnar
        from predictionio_tpu_torch.data.storage import segmentfs

        self.s = dict.fromkeys(("parse", "hash", "timestamps",
                                "dictionaries", "write"), 0.0)
        store = segmentfs.SegmentFSEventStore
        self._undo = []
        for owner, name, part in (
                (segmentfs, "bulk_hash64", "hash"),
                (segmentfs, "bulk_iso_to_millis", "timestamps"),
                (segmentfs, "columnar_from_columns", "dictionaries"),
                (columnar.SegmentLog, "append", "write"),
                (store, "_write_id_hashes", "write")):
            self._wrap(owner, name, part)
        real_iter = store._iter_segment_columns

        def timed_iter(es, path, float_props):
            it = real_iter(es, path, float_props)
            while True:
                t = time.perf_counter()
                try:
                    block = next(it)
                except StopIteration:
                    return
                finally:
                    self.s["parse"] += time.perf_counter() - t
                yield block

        self._undo.append((store, "_iter_segment_columns", real_iter))
        store._iter_segment_columns = timed_iter
        self.gc = GCPauses()

    def _wrap(self, owner, name, part):
        real = owner.__dict__[name]

        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                self.s[part] += time.perf_counter() - t

        self._undo.append((owner, name, real))
        setattr(owner, name, timed)

    def close(self) -> None:
        for owner, name, real in reversed(self._undo):
            setattr(owner, name, real)
        self.gc.close()

    def line(self, total: float) -> str:
        """The parts, what of ``total`` none of them holds, and the
        garbage collector's pauses (inside the parts and the rest)."""
        return " ".join(f"{k}={v:.3f}s" for k, v in self.s.items()) + \
            f" other={total - sum(self.s.values()):.3f}s; gc pauses " \
            f"{self.gc.s:.3f}s"


def counted_cli(args: list, env: dict, log: Path) -> tuple:
    """``cli ARGS`` as a fresh process through :data:`CLI_COUNTED_MAIN`:
    (exit code, output, seconds, its ``COUNTED`` report)."""
    root = Path(__file__).resolve().parent
    t = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", CLI_COUNTED_MAIN,
                                 *args], stdout=f, stderr=subprocess.STDOUT,
                                cwd=root, env=env)
    rc = end_process(proc, STORAGE_TIMEOUT_S)
    out = log.read_text()
    counted = next((json.loads(ln[len("COUNTED "):])
                    for ln in out.splitlines() if ln.startswith("COUNTED ")),
                   None)
    return rc, out, time.perf_counter() - t, counted


def train_stages(out: str) -> dict:
    return json.loads(next(
        ln for ln in out.splitlines()
        if ln.startswith("Train stages: "))[len("Train stages: "):])


def scrape_counter(port: int, name: str, labels: str = "") -> float:
    with _LOCAL.open(f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
        text = r.read().decode()
    m = re.search(rf"^{re.escape(name + labels)} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


def ratings_triples(td) -> np.ndarray:
    r = td.ratings
    return triples(id_numbers(td.user_ids, r.n_users)[r.users],
                   id_numbers(td.item_ids, r.n_items)[r.items], r.ratings)


def phase_storage(data, dev, home: str, pio: dict, card: dict) -> dict:
    """The pod storage layout over phase 8's events (see the module's
    docstring, phase 8a). Returns the kernels' launches in the phase's
    counted processes: the REMOTE training and the deploy (and the forked
    SQLite training, counted apart)."""
    from predictionio_tpu_torch import cli, native
    from predictionio_tpu_torch.controller.context import Context
    from predictionio_tpu_torch.data.storage.objectstore import (
        FakeObjectStoreServer,
    )
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.data.storage.segmentfs import (
        SegmentFSEventStore,
    )
    from predictionio_tpu_torch.data.storage.sqlite import SQLiteEventStore
    from predictionio_tpu_torch.templates.recommendation import (
        RecommendationDataSource,
    )
    from predictionio_tpu_torch.workflow.persistence import loads_models
    from urllib.parse import quote

    threads_before = {t.ident for t in threading.enumerate()}
    root = Path(__file__).resolve().parent
    work = Path(tempfile.mkdtemp(prefix="storage_", dir=Path(home)))
    base_env = {k: v for k, v in os.environ.items()
                if not k.startswith("PIO_")}
    base_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH", "")) if p)
    seg_env = {"PIO_STORAGE_SOURCES_SEG_TYPE": "SEGMENTFS",
               "PIO_STORAGE_SOURCES_SEG_PATH": str(work / "segmentfs")}
    users, items, stars = (a[data[0] % PIO_USER_STRIDE == 0]
                           for a in data[:3])
    sqlite_st = Storage(env={"PIO_HOME": home})
    seg = Storage(env=seg_env)
    server = bucket = localfs = inproc = pod = None
    deploy = None
    device = [] if dev.type == "cuda" else ["--device", "cpu"]
    try:
        # -- 1. the JSON lines to import: phase pio's events, written from
        # the arrays it ingested (a cli export of these 2 M events took
        # 70-96 s beside the H100; phase console times cli export on its
        # own app)
        exported = work / "export.jsonl"
        t = time.perf_counter()
        n_out = write_rating_jsonl(exported, users, items, stars)
        export_s = time.perf_counter() - t

        # -- 7. LOCALFS, every 80th user, in a process beside 2-6 --------
        keep = users % STORAGE_LOCALFS_STRIDE == 0
        lf_log = work / "localfs.log"
        with open(lf_log, "w") as f:
            localfs = subprocess.Popen(
                [sys.executable, "-c", LOCALFS_MAIN, str(work / "localfs"),
                 str(exported), str(work / "localfs.jsonl"),
                 str(work / "localfs.npz"), PIO_APP,
                 str(STORAGE_LOCALFS_STRIDE)], stdout=f,
                stderr=subprocess.STDOUT, cwd=root, env=base_env)

        # -- 7b. the threaded reader, on a copy of the SQLite file without
        # its sidecar, beside 2-6 ------------------------------------------
        inproc_home = work / "inproc"
        inproc_home.mkdir()
        shutil.copy(Path(home) / "pio.db", inproc_home / "pio.db")
        inproc_log = work / "inproc.log"
        with open(inproc_log, "w") as f:
            inproc = subprocess.Popen(
                [sys.executable, "-c", INPROC_MAIN, str(inproc_home),
                 PIO_APP], stdout=f, stderr=subprocess.STDOUT, cwd=root,
                env=base_env)

        # -- 2. import into SEGMENTFS through the native lane ---------------
        out = io.StringIO()
        native.reset_lane_counts()
        split = EncodeSplit()
        seconds = {}
        real_import = SegmentFSEventStore.import_jsonl
        real_warm = SegmentFSEventStore.warm_columnar

        def timed(fn, key):
            def run(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    seconds[key] = time.perf_counter() - t0
            return run

        SegmentFSEventStore.import_jsonl = timed(real_import, "import")
        SegmentFSEventStore.warm_columnar = timed(real_warm, "encode")
        try:
            with contextlib.redirect_stdout(out):
                check(cli.main(["app", "new", PIO_APP], storage=seg) == 0,
                      "app new on SEGMENTFS failed")
                t = time.perf_counter()
                rc = cli.main(["import", "--app", PIO_APP, "--input",
                               str(exported)], storage=seg)
                cli_import_s = time.perf_counter() - t
        finally:
            SegmentFSEventStore.import_jsonl = real_import
            SegmentFSEventStore.warm_columnar = real_warm
            split.close()
        lanes = native.lane_counts()
        check(rc == 0 and f"Imported {n_out} event(s)." in out.getvalue(),
              f"cli import into SEGMENTFS: {rc} {out.getvalue()}")
        check(lanes.get("import_jsonl", {}).get("python", 0) == 0
              and lanes["import_jsonl"]["native"] > 0
              and lanes.get("parse_segment", {}).get("python", 0) == 0,
              f"the Python lane carried codec work: {lanes}")

        # -- 3. the columnar reads ------------------------------------------
        app_id = seg.apps().get_by_name(PIO_APP).id
        fresh = Storage(env=seg_env)
        t = time.perf_counter()
        fresh.events().find_columnar(app_id, ordered=False,
                                     with_props=False)
        built_s = time.perf_counter() - t
        t = time.perf_counter()
        fresh.events().find_columnar(app_id, ordered=False,
                                     with_props=False)
        warm_s = time.perf_counter() - t
        fresh.close()
        params = DataSourceParams(app_name=PIO_APP)
        td_seg = RecommendationDataSource(params).read_training(
            Context(device=dev, _storage=seg))
        td_sql = RecommendationDataSource(params).read_training(
            Context(device=dev, _storage=sqlite_st))
        check(td_seg.user_ids.to_dict() == td_sql.user_ids.to_dict()
              and td_seg.item_ids.to_dict() == td_sql.item_ids.to_dict(),
              "SEGMENTFS and SQLite number the users or items apart")
        check(np.array_equal(ratings_triples(td_seg),
                             ratings_triples(td_sql)),
              "SEGMENTFS does not read back the SQLite store's ratings")
        same_order = all(np.array_equal(getattr(td_seg.ratings, f),
                                        getattr(td_sql.ratings, f))
                         for f in ("users", "items", "ratings"))
        del td_seg

        # -- 4. the storage server and the bucket ---------------------------
        srv_log = work / "storageserver.log"
        server = cli_process(["storageserver", "--ip", "127.0.0.1",
                              "--port", "0", "--secret", STORAGE_SECRET],
                             dict(base_env, **seg_env), srv_log)
        srv_port = None
        t0 = time.perf_counter()
        while srv_port is None:
            check(server.poll() is None
                  and time.perf_counter() - t0 < STORAGE_TIMEOUT_S,
                  f"cli storageserver did not start: {srv_log.read_text()}")
            for ln in srv_log.read_text().splitlines():
                if " is listening at http://" in ln:
                    srv_port = int(ln.rsplit(":", 1)[1].rstrip("."))
            time.sleep(0.01)
        bucket = FakeObjectStoreServer(str(work / "bucket"))
        bucket.start_background()
        pod_env = {
            "PIO_STORAGE_SOURCES_NET_TYPE": "REMOTE",
            "PIO_STORAGE_SOURCES_NET_URL": f"http://127.0.0.1:{srv_port}",
            "PIO_STORAGE_SOURCES_NET_SECRET": STORAGE_SECRET,
            "PIO_STORAGE_SOURCES_OBJ_TYPE": "S3",
            "PIO_STORAGE_SOURCES_OBJ_ENDPOINT":
                f"http://127.0.0.1:{bucket.port}/models",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "NET",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "NET",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "OBJ"}
        pod = Storage(env=pod_env)

        # -- 5. train through REMOTE, the blob to the bucket ----------------
        rc, out, train_s, train_c = counted_cli(
            ["train", "--engine-json", pio["engine_json"], *device],
            dict(base_env, **pod_env), work / "train.log")
        check(rc == 0 and train_c is not None,
              f"cli train over REMOTE: {rc} {out[-3000:]}")
        stages = train_stages(out)
        check(dev.type != "cuda" or (train_c["fused_gram"] > 0
                                     and train_c["chol_solve"] > 0),
              f"cli train over REMOTE launched fused_gram "
              f"{train_c['fused_gram']}, chol_solve "
              f"{train_c['chol_solve']} times")
        check(train_c["pull"]["status"] == 200,
              f"the training read pulled {train_c['pull']}")
        (inst,) = pod.engine_instances().get_all()
        check(inst.status == "COMPLETED", f"instance {inst.status}")
        blob = pod.models().get(inst.id).models
        on_disk = (work / "bucket" / quote(f"models/{inst.id}",
                                            safe="")).read_bytes()
        check(blob == on_disk, "the bucket's blob differs from "
              "ModelsDAO.get's")
        (model,) = loads_models(blob)
        (sql_inst,) = sqlite_st.engine_instances().get_all()
        (ref,) = loads_models(sqlite_st.models().get(sql_inst.id).models)
        check(model.user_ids.to_dict() == ref.user_ids.to_dict()
              and model.item_ids.to_dict() == ref.item_ids.to_dict(),
              "the REMOTE model numbers its ids apart from phase 8's")
        du = (model.user_factors - ref.user_factors).abs().max().item()
        dv = (model.item_factors - ref.item_factors).abs().max().item()
        exact = du == 0.0 and dv == 0.0
        check(exact or not same_order,
              f"the ratings came in phase 8's order, yet the factors "
              f"differ (users {du:.3e}, items {dv:.3e})")
        check(np.isfinite(du) and np.isfinite(dv) and max(du, dv) < 2e-3,
              f"the REMOTE model is off phase 8's by {max(du, dv):.3e}")

        # the REMOTE read again: an ETag round trip, no npz re-sent
        ev = pod.events()
        ev.find_columnar(app_id, ordered=False, with_props=False)
        first_pull = dict(ev.c.last_columnar)
        hits = scrape_counter(srv_port, "pio_columnar_requests_total",
                              '{outcome="hit"}')
        sent = scrape_counter(srv_port, "pio_columnar_bytes_total")
        t = time.perf_counter()
        ev.find_columnar(app_id, ordered=False, with_props=False)
        again_s = time.perf_counter() - t
        second_pull = dict(ev.c.last_columnar)
        check(second_pull == {"status": 304, "bytes": 0}
              and scrape_counter(srv_port, "pio_columnar_requests_total",
                                 '{outcome="hit"}') == hits + 1
              and scrape_counter(srv_port, "pio_columnar_bytes_total")
              == sent, f"the second REMOTE read re-sent the npz: "
                       f"{second_pull}")

        # -- 6. deploy from the bucket and answer ---------------------------
        deploy = console_deploy("storage", pio["engine_json"], None,
                                dict(base_env, **pod_env), work, pod, dev,
                                queries=STORAGE_QUERIES)
        st = _http(deploy["port"], "GET", "/status.json")[1]
        topk = st["kernels"]["fused_topk"]["launches"]
        check(st["engineInstanceId"] == inst.id, "deploy bound another "
              "instance")
        check(dev.type != "cuda" or topk > 0,
              "the deploy launched fused_topk no time")
        rc = cli.main(["undeploy", "--ip", "127.0.0.1", "--port",
                       str(deploy["port"])], storage=pod)
        check(rc == 0 and end_process(deploy["proc"]) == 0,
              f"the storage deploy did not end cleanly: {rc}")
        warm_at, first_at = deploy["warm_s"], deploy["first_s"]
        deploy = None

        # -- 8. a copy of the SQLite file without its sidecar, trained in a
        # fresh process whose single thread forks the first encode, while
        # LOCALFS runs ---------------------------------------------------
        fork_home = work / "fork"
        fork_home.mkdir()
        shutil.copy(Path(home) / "pio.db", fork_home / "pio.db")
        check(not (fork_home / "pio.db.columnar").exists(),
              "the SQLite copy has a sidecar")
        rc, out, _, fork_c = counted_cli(
            ["train", "--engine-json", pio["engine_json"], *device],
            dict(base_env, PIO_HOME=str(fork_home)), work / "fork.log")
        check(rc == 0 and fork_c is not None,
              f"cli train of the SQLite copy: {rc} {out[-3000:]}")
        fork_s = fork_c["seconds"]
        fork_stages = train_stages(out)
        # the store forks its first encode from this many rows up
        check(fork_c["encode"]["path"] == "forked"
              or n_out < SQLiteEventStore.ENCODE_PARALLEL_MIN,
              f"the first encode did not fork: {fork_c['encode']}")
        check(dev.type != "cuda" or (fork_c["fused_gram"] > 0
                                     and fork_c["chol_solve"] > 0),
              f"the SQLite copy's training launched {fork_c}")

        # -- 7, its end ------------------------------------------------------
        t = time.perf_counter()
        check(end_process(localfs, STORAGE_TIMEOUT_S) == 0,
              f"the LOCALFS step failed: {lf_log.read_text()[-3000:]}")
        lf_wait_s = time.perf_counter() - t
        lf = json.loads(lf_log.read_text().strip().splitlines()[-1])
        t = time.perf_counter()
        check(end_process(inproc, STORAGE_TIMEOUT_S) == 0,
              f"the threaded reader failed: {inproc_log.read_text()[-3000:]}")
        inproc_wait_s = time.perf_counter() - t
        inproc = None
        rd = json.loads(inproc_log.read_text().strip().splitlines()[-1])
        check(rd["threads"] > 1 and rd["encode"].get("path") == "in-process"
              and rd["n"] == n_out,
              f"a process with {rd['threads']} threads read {rd['n']} of "
              f"{n_out} events, encoded {rd['encode']}")
        got = np.load(work / "localfs.npz")
        check(lf["n"] == int(keep.sum()) and np.array_equal(
            triples(got["users"], got["items"], got["ratings"]),
            triples(users[keep], items[keep], stars[keep])),
              "LOCALFS did not read back the cut's ratings")
        localfs = None

        launches = {"fused_topk": topk,
                    "fused_gram": train_c["fused_gram"],
                    "chol_solve": train_c["chol_solve"],
                    "gram_table": train_c["gram_table"]}
        check(launches["gram_table"] == 0 and fork_c["gram_table"] == 0,
              "the storage phase launched gram_table")

        # -- 9. teardown ------------------------------------------------------
        server.send_signal(signal.SIGINT)
        check(end_process(server, 60) == 0,
              f"cli storageserver did not exit cleanly: "
              f"{srv_log.read_text()[-2000:]}")
        server = None
        pod.close()
        bucket.shutdown()
        bucket = None
        left = storage_threads_left(threads_before)
        check(not left, f"the storage phase left threads: {left}")
        print(
            f"phase storage: {n_out} events written as JSON lines in "
            f"{export_s:.3f}s (cli export of the store cut: phase console "
            f"times it) | SEGMENTFS cli import "
            f"{cli_import_s:.3f}s: import_jsonl {seconds['import']:.3f}s = "
            f"{n_out / seconds['import']:.1f} events/s, lanes "
            f"{json.dumps(lanes)}, cold sidecar encode (warm_columnar) "
            f"{seconds['encode']:.3f}s ({split.line(seconds['encode'])}) | "
            f"find_columnar "
            f"from a fresh client {built_s:.3f}s, warm {warm_s:.3f}s | "
            f"RatingsCOO equal to SQLite's (id maps, triples; same order "
            f"{same_order}) | cli train over REMOTE {train_s:.3f}s stages "
            f"{json.dumps(stages)} (npz pull {train_c['pull']['bytes']} "
            f"bytes) launches fused_gram={train_c['fused_gram']} "
            f"chol_solve={train_c['chol_solve']} gram_table="
            f"{train_c['gram_table']} | factors against phase 8's: "
            f"max |d| users {du:.3e} items {dv:.3e} "
            f"({'exact' if exact else 'within 2e-3'}) | REMOTE read again "
            f"{again_s * 1e3:.3f} ms: {second_pull['status']}, "
            f"{second_pull['bytes']} bytes (first {first_pull}) | deploy "
            f"from the bucket: servingWarm at {warm_at:.3f}s, first answer "
            f"at {first_at:.3f}s, {STORAGE_QUERIES} answers held to "
            f"float64, "
            f"fused_topk launches={topk} | forked SQLite encode: cli train "
            f"{fork_s:.3f}s read_s {fork_stages['read_s']:.3f}s "
            f"{json.dumps(fork_c['encode'])} (phase pio's cold "
            f"find_columnar {pio['find_cold_s']:.3f}s, "
            f"{pio['encode'].get('path')}) "
            f"fused_gram={fork_c['fused_gram']} chol_solve="
            f"{fork_c['chol_solve']} | a threaded process's cold read "
            f"{rd['read_s']:.3f}s ({rd['threads']} threads, encode "
            f"{rd['encode'].get('path')}; in its process beside steps 2-6, "
            f"waited for {inproc_wait_s:.3f}s after them) | LOCALFS 1 user in "
            f"{STORAGE_LOCALFS_STRIDE} ({lf['n']} events, cut "
            f"{lf['cut_s']:.3f}s in its process, beside steps 2-6, waited "
            f"for {lf_wait_s:.3f}s after them): "
            f"cli import {lf['import_s']:.3f}s = "
            f"{lf['n'] / lf['import_s']:.1f} events/s, find_columnar "
            f"{lf['find_s']:.3f}s, triples equal | {card_tag(card)}",
            flush=True)
        return {"launches": launches, "fork": fork_c, "remote": {
            "pull_bytes": train_c["pull"]["bytes"],
            "factors": (model.user_factors.cpu().numpy(),
                        model.item_factors.cpu().numpy()),
            "ids": (model.user_ids.to_dict(), model.item_ids.to_dict())}}
    finally:
        for proc in (deploy and deploy["proc"], localfs, inproc, server):
            if proc is not None and proc.poll() is None:
                proc.terminate()
                end_process(proc, 30)
        for st_ in (pod, seg, sqlite_st):
            if st_ is not None:
                st_.close()
        if bucket is not None:
            bucket.shutdown()
        shutil.rmtree(work, ignore_errors=True)


def storage_threads_left(before: set, wait_s: float = 10.0) -> list:
    """Threads started since ``before`` (a set of idents) that are still
    alive after up to ``wait_s``: a server's connection threads end once
    their clients have closed."""
    deadline = time.perf_counter() + wait_s
    while True:
        left = [t.name for t in threading.enumerate()
                if t.ident not in before]
        if not left or time.perf_counter() > deadline:
            return left
        time.sleep(0.05)


def phase_batchpredict(data, dev, home: str, pio: dict) -> int:
    """``cli batchpredict`` on the card from the ``pio`` phase's store:
    one query line ``{"user", "num": 10}`` for each of the store's users,
    the ``fused_topk`` count zeroed just before and read just after, every
    output line's query and answer checked against the plain top-k on
    the trained f32 tables."""
    from predictionio_tpu_torch import cli
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.workflow.persistence import loads_models

    users = data[0]
    store_users = np.unique(users[users % PIO_USER_STRIDE == 0])
    queries = [{"user": f"u{u}", "num": 10} for u in store_users]
    qpath, opath = Path(home) / "queries.jsonl", Path(home) / "out.jsonl"
    qpath.write_text("".join(json.dumps(q) + "\n" for q in queries))
    storage = Storage(env={"PIO_HOME": home})
    try:
        # -- the batch-predict job, counted ------------------------------
        ft.LAUNCHES = 0
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["batchpredict", "--engine-json",
                           pio["engine_json"], "--input", str(qpath),
                           "--output", str(opath)], storage=storage)
        job_s = time.perf_counter() - t
        launches = ft.LAUNCHES
        # ----------------------------------------------------------------
        (inst,) = storage.engine_instances().get_all()
        (model,) = loads_models(storage.models().get(inst.id).models)
    finally:
        storage.close()
    check(rc == 0, f"cli batchpredict returned {rc}: {out.getvalue()}")
    check(f"Wrote {len(queries)} prediction(s)" in out.getvalue(),
          f"cli batchpredict said {out.getvalue()!r}")
    check(launches > 0, "cli batchpredict launched fused_topk no time")
    lines = [json.loads(ln) for ln in opath.read_text().splitlines()]
    check(len(lines) == len(queries),
          f"batchpredict wrote {len(lines)} lines for {len(queries)}")
    check(all(ln["query"] == q for ln, q in zip(lines, queries)),
          "a batchpredict line carries another query")
    check(all(len(ln["prediction"]["itemScores"]) == 10 for ln in lines),
          "a batchpredict answer has not 10 items")
    ud = model.user_factors.to(dev)
    vd = model.item_factors.to(dev)
    U64, V64 = ud.double(), vd.double()
    rows = np.array([model.user_ids[q["user"]] for q in queries])
    worst = 0.0
    for s0 in range(0, len(rows), BATCH):
        idx = torch.from_numpy(rows[s0:s0 + BATCH].astype(np.int32)).to(dev)
        ps, _ = ft.fused_topk_reference(ud, idx, vd, k=16,
                                        n_items=model.n_items)
        part = lines[s0:s0 + BATCH]
        got_i = torch.tensor([[model.item_ids[s["item"]]
                               for s in ln["prediction"]["itemScores"]]
                              for ln in part], device=dev)
        got_s = torch.tensor([[s["score"]
                               for s in ln["prediction"]["itemScores"]]
                              for ln in part], dtype=torch.float64,
                             device=dev)
        want = ps[:, :10].double()
        tol = RTOL["f32"] * (1 + want.abs())
        err = (got_s - want).abs()
        worst = max(worst, err.max().item())
        check(bool((err <= tol).all()),
              "batchpredict: scores off the plain version")
        own = torch.einsum("br,bkr->bk", U64[idx.long()], V64[got_i])
        check(bool(((own - got_s).abs() <= tol).all()),
              "batchpredict: an item does not score what was returned")
        srt = torch.sort(got_i, dim=1).values
        check(bool((srt[:, 1:] != srt[:, :-1]).all()),
              "batchpredict: an item appears twice in one answer")
    print(f"phase batchpredict: {len(lines)} lines (every store user, num "
          f"10) in {job_s:.3f}s = {len(lines) / job_s:.1f} rows/s (the "
          f"command: instance load, placing the tables, 1,024-query "
          f"flushes, output) | fused_topk launches={launches} | scores "
          f"within {worst:.3e} of the plain top-k", flush=True)
    return launches


def eval_answers(seen: dict, dev, tag: str) -> tuple:
    """Every answer of a ``cli eval`` run (``seen["predicts"]``: model,
    queries, results of each ``batch_predict``) against the plain top-k
    in float64 on the card, held as ``verify_topk`` holds the kernel.
    Returns (largest score difference, queries, {id of a fold's first
    result: the plain item lists})."""
    worst, n_queries, plain_items = 0.0, 0, {}
    for model, queries, results in seen["predicts"]:
        U64 = model.user_factors.to(dev).double()
        V64 = model.item_factors.to(dev).double()[:model.n_items]
        inv = model.item_ids.inverse
        rows = np.array([model.user_ids[q.user] for q in queries])
        plain = []
        for s0 in range(0, len(rows), BATCH):
            idx = torch.from_numpy(rows[s0:s0 + BATCH].astype(np.int32)
                                   ).to(dev)
            ps, pi = torch.sort(U64[idx.long()] @ V64.T, dim=1,
                                descending=True, stable=True)
            ps, pi = ps[:, :EVAL_QUERY_NUM], pi[:, :EVAL_QUERY_NUM]
            part = results[s0:s0 + BATCH]
            check(all(len(r.item_scores) == EVAL_QUERY_NUM for r in part),
                  f"{tag}: an answer has not {EVAL_QUERY_NUM} items")
            got_i = torch.tensor([[model.item_ids[x.item]
                                   for x in r.item_scores] for r in part],
                                 device=dev)
            got_s = torch.tensor([[x.score for x in r.item_scores]
                                  for r in part], dtype=torch.float32,
                                 device=dev)
            worst = max(worst, verify_topk(tag, got_s, got_i, ps, U64, V64,
                                           idx, RTOL["f32"]))
            plain += [[inv[j] for j in row] for row in pi.tolist()]
        plain_items[id(results[0])] = plain
        n_queries += len(queries)
    return worst, n_queries, plain_items


def phase_eval(dev, home: str) -> dict:
    """``cli eval chip_smoke:EVALUATION chip_smoke:GRID`` on the card
    from the ``pio`` phase's store, then the same with ``--parallelism
    2``. Each run: the launch counts of all four kernels zeroed just
    before and read just after; packings and trainings counted by
    wrapping ``models.als.pack_ratings`` and ``ALSAlgorithm.train``;
    every answer held against the plain top-k in float64 on the card;
    the optimized metric recomputed from the plain answers; the
    EVALCOMPLETED instance and its ``bestIndex``. The two runs must give
    the same scores bit for bit and the same launch counts."""
    from predictionio_tpu_torch import cli
    from predictionio_tpu_torch.data.storage.base import STATUS_EVALCOMPLETED
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops import fused_gram as fg
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.ops import gram
    from predictionio_tpu_torch.ops import solve as sv
    from predictionio_tpu_torch.templates import recommendation as prec

    # the module the CLI loads the evaluation from (when this file runs
    # as a script, a second copy of it beside ``__main__``)
    evaluation = importlib.import_module("chip_smoke").EVALUATION
    metric = evaluation.metric
    originals = dict(pack=als.pack_ratings, train=prec.ALSAlgorithm.train,
                     predict=prec.ALSAlgorithm.batch_predict,
                     read=prec.RecommendationDataSource.read_eval)

    def instrument() -> dict:
        seen = {"packs": 0, "trains": 0, "predicts": [], "metric": [],
                "read_s": 0.0, "predict_s": 0.0, "metrics_s": 0.0}
        lock = threading.Lock()

        def counted_pack(*a, **k):
            with lock:
                seen["packs"] += 1
            return originals["pack"](*a, **k)

        def counted_train(self, ctx, td):
            with lock:
                seen["trains"] += 1
            return originals["train"](self, ctx, td)

        def kept_predict(self, model, queries):
            t0 = time.perf_counter()
            out = originals["predict"](self, model, queries)
            with lock:
                seen["predict_s"] += time.perf_counter() - t0
                seen["predicts"].append((model, queries, out))
            return out

        def timed_read(self, ctx):
            t0 = time.perf_counter()
            folds = originals["read"](self, ctx)
            with lock:
                seen["read_s"] += time.perf_counter() - t0
            return folds

        def timed_calculate(m):
            def calculate(eval_data):
                t0 = time.perf_counter()
                score = type(m).calculate(m, eval_data)
                with lock:
                    seen["metrics_s"] += time.perf_counter() - t0
                    if m is metric:
                        seen["metric"].append((eval_data, score))
                return score
            return calculate

        als.pack_ratings = counted_pack
        prec.ALSAlgorithm.train = counted_train
        prec.ALSAlgorithm.batch_predict = kept_predict
        prec.RecommendationDataSource.read_eval = timed_read
        for m in evaluation.metrics:
            m.calculate = timed_calculate(m)
        return seen

    def restore() -> None:
        als.pack_ratings = originals["pack"]
        prec.ALSAlgorithm.train = originals["train"]
        prec.ALSAlgorithm.batch_predict = originals["predict"]
        prec.RecommendationDataSource.read_eval = originals["read"]
        for m in evaluation.metrics:
            m.__dict__.pop("calculate", None)

    storage = Storage(env={"PIO_HOME": home})
    runs = []
    try:
        for extra in ([], ["--parallelism", "2"]):
            tag = "eval " + (" ".join(extra) or "serial")
            before = {i.id for i in storage.evaluation_instances().get_all()}
            seen = instrument()
            try:
                # -- the eval path, counted ------------------------------
                fg.LAUNCHES = sv.LAUNCHES = ft.LAUNCHES = gram.LAUNCHES = 0
                out = io.StringIO()
                t = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    rc = cli.main(["eval", "chip_smoke:EVALUATION",
                                   "chip_smoke:GRID", *extra],
                                  storage=storage)
                cmd_s = time.perf_counter() - t
                launches = {"fused_gram": fg.LAUNCHES,
                            "chol_solve": sv.LAUNCHES,
                            "fused_topk": ft.LAUNCHES,
                            "gram_table": gram.LAUNCHES}
                # ------------------------------------------------------
            finally:
                restore()
            check(rc == 0, f"{tag}: cli eval returned {rc}: "
                  f"{out.getvalue()}")
            for name in ("fused_gram", "chol_solve", "fused_topk"):
                check(launches[name] > 0, f"{tag} launched {name} no time")
            check(launches["gram_table"] == 0,
                  f"{tag} launched gram_table {launches['gram_table']} "
                  f"times")
            n_sets = len(GRID.engine_params_list)
            check(seen["packs"] == EVAL_K,
                  f"{tag}: {seen['packs']} packings, not one a fold")
            check(seen["trains"] == EVAL_K * n_sets,
                  f"{tag}: {seen['trains']} trainings, not one a fold and "
                  f"params set")
            (inst,) = [i for i in storage.evaluation_instances().get_all()
                       if i.id not in before]
            check(inst.status == STATUS_EVALCOMPLETED,
                  f"{tag}: evaluation instance {inst.id} is {inst.status}")
            result = json.loads(inst.evaluator_results_json)
            scores = result["metricScoresList"]
            best = 0
            for k in range(1, len(scores)):
                if metric.compare(scores[k]["score"],
                                  scores[best]["score"]) > 0:
                    best = k
            check(result["bestIndex"] == best and len(scores) == n_sets,
                  f"{tag}: bestIndex {result['bestIndex']}, argmax {best}")
            check(out.getvalue().strip().splitlines()[-1]
                  == inst.evaluator_results,
                  f"{tag}: printed {out.getvalue()!r}, recorded "
                  f"{inst.evaluator_results!r}")

            worst, n_queries, plain_items = eval_answers(seen, dev, tag)
            n_diff = 0
            for eval_data, score in seen["metric"]:
                plain_data, diff = [], 0
                for ei, qpas in eval_data:
                    lists = plain_items[id(qpas[0][1])]
                    diff += sum([x.item for x in p.item_scores] != items
                                for (_, p, _), items in zip(qpas, lists))
                    plain_data.append((ei, [
                        (q, prec.PredictedResult(tuple(
                            prec.ItemScore(item=it, score=0.0)
                            for it in items)), a)
                        for (q, _, a), items in zip(qpas, lists)]))
                again = metric.calculate(plain_data)
                counted = len(metric._scores(plain_data))
                check(again == score or abs(again - score) <= diff / counted,
                      f"{tag}: {metric.header} from the plain answers "
                      f"{again!r}, reported {score!r} ({diff} lists differ "
                      f"inside a near-tie)")
                n_diff += diff
            runs.append(dict(tag=tag, cmd_s=cmd_s, launches=launches,
                             scores=scores, seen=seen, n_queries=n_queries,
                             worst=worst, n_diff=n_diff, best=best))
            per_set = " | ".join(
                f"iters={it} trainS={s['trainS']:.3f} evalS="
                f"{s['evalS']:.3f} score={s['score']!r}"
                for it, s in zip(EVAL_ITERS, scores))
            rank = GRID.engine_params_list[0].algorithms[0][1].rank
            print(f"phase {tag}: cli eval {cmd_s:.3f}s ({EVAL_K} folds x "
                  f"{n_sets} params sets at rank {rank}) | read_eval "
                  f"{seen['read_s']:.3f}s | {per_set} | {n_queries} "
                  f"held-out queries scored = {n_queries / cmd_s:.1f} "
                  f"queries/s of the command ({seen['predict_s']:.3f}s in "
                  f"batch_predict) | {len(evaluation.metrics)} metrics "
                  f"{seen['metrics_s']:.3f}s | packings={seen['packs']} "
                  f"trainings="
                  f"{seen['trains']} | launches fused_gram="
                  f"{launches['fused_gram']} chol_solve="
                  f"{launches['chol_solve']} fused_topk="
                  f"{launches['fused_topk']} gram_table="
                  f"{launches['gram_table']} | best variant {best} | "
                  f"answers within {worst:.3e} of the plain float64 top-"
                  f"{EVAL_QUERY_NUM}, {n_diff} item lists differ inside a "
                  f"near-tie | instance {inst.id} {inst.status}", flush=True)
            seen.clear()
    finally:
        storage.close()
    serial, parallel = runs
    for key in ("score", "otherScores"):
        check([s[key] for s in serial["scores"]]
              == [s[key] for s in parallel["scores"]],
              f"eval: the parallel run's {key} differ from the serial run's")
    check(serial["launches"] == parallel["launches"],
          f"eval: launches serial {serial['launches']} parallel "
          f"{parallel['launches']}")
    return serial["launches"]


#: the stream phase: bursts, and the events of one burst by kind
STREAM_BURSTS = 3
#: 16 users a burst: each pass is its users' history reads (the 3
#: bursts, each a canary check, are the phase's depth)
STREAM_USERS, STREAM_USER_EVENTS = 16, 14      # 224 on existing users
STREAM_COLD, STREAM_COLD_EVENTS = 4, 12        # 48 from cold users
STREAM_NEW_ITEMS, STREAM_NEW_ITEM_RATERS = 2, 8  # 16 on new items


def stream_bursts(data, seed: int) -> list:
    """The stream phase's traffic, from the surrogate: each burst is 288
    ``rate`` events as (users, items, stars) arrays. 224 come from 16
    users in the store (48 distinct over the bursts) on items outside
    their history, drawn by the store's item popularity, with stars from
    its rating histogram; 48 from 4 cold users (surrogate users with id
    % 10 == 1: 12 of their real ratings on items in the store); 16 on 2
    item ids new in that burst, each rated by 8 of the burst's 16
    users."""
    users, items, stars, _, n_items = data
    rng = np.random.default_rng(seed + 21)
    store = users % PIO_USER_STRIDE == 0
    s_users, s_items, s_stars = users[store], items[store], stars[store]
    pop = np.bincount(s_items, minlength=n_items).astype(np.float64)
    pop /= pop.sum()
    star_vals, star_n = np.unique(s_stars, return_counts=True)
    star_p = star_n / star_n.sum()
    picked = rng.choice(np.unique(s_users), STREAM_BURSTS * STREAM_USERS,
                        replace=False)
    cold_pool = rng.permutation(np.unique(users[users % PIO_USER_STRIDE
                                                == 1]))
    bursts, cold_at = [], 0
    for b in range(STREAM_BURSTS):
        bu, bi, bs = [], [], []
        mine = picked[b * STREAM_USERS:(b + 1) * STREAM_USERS]
        for u in mine:
            seen = set(s_items[s_users == u].tolist())
            got = []
            while len(got) < STREAM_USER_EVENTS:
                for i in rng.choice(n_items, 4 * STREAM_USER_EVENTS,
                                    p=pop).tolist():
                    if i not in seen and len(got) < STREAM_USER_EVENTS:
                        seen.add(i)
                        got.append(i)
            bu += [int(u)] * STREAM_USER_EVENTS
            bi += got
            bs += rng.choice(star_vals, STREAM_USER_EVENTS,
                             p=star_p).tolist()
        taken = 0
        while taken < STREAM_COLD:  # real ratings, on items in the store
            u = int(cold_pool[cold_at])
            cold_at += 1
            rows = np.flatnonzero(users == u)
            rows = rows[pop[items[rows]] > 0]
            if len(rows) < STREAM_COLD_EVENTS:
                continue
            rows = rng.choice(rows, STREAM_COLD_EVENTS, replace=False)
            bu += [u] * STREAM_COLD_EVENTS
            bi += items[rows].tolist()
            bs += stars[rows].tolist()
            taken += 1
        for k in range(STREAM_NEW_ITEMS):
            raters = mine[k * STREAM_NEW_ITEM_RATERS:
                          (k + 1) * STREAM_NEW_ITEM_RATERS]
            bu += raters.tolist()
            bi += [n_items + STREAM_NEW_ITEMS * b + k] * len(raters)
            bs += rng.choice(star_vals, len(raters), p=star_p).tolist()
        bursts.append((np.array(bu, np.int64), np.array(bi, np.int64),
                       np.array(bs, np.float32)))
    return bursts


def f64_fold_check(storage, app_id, model, user_keys) -> float:
    """Each user's bound row against a float64 solve of its normal
    equations, built from its deduplicated store history (the most
    recent 512 of the items the bound model knows, read through the
    columnar path, not the fold-in's) and the bound item table; returns
    the largest normwise relative difference. An item the store holds
    but the model does not (one an earlier stream session inserted into
    another binding of the same instance) is left out, as the fold-in
    leaves it out."""
    from predictionio_tpu_torch.data.storage.base import EventFilter
    from predictionio_tpu_torch.models.als import dequantize_table

    batch = storage.events().find_columnar(
        app_id, None, EventFilter(entity_type="user", event_names=["rate"],
                                  target_entity_type="item"),
        float_props=("rating",), ordered=True, with_props=False)
    d = batch.dicts
    V = dequantize_table(model.item_factors).double().cpu().numpy()
    U = dequantize_table(model.user_factors).double().cpu().numpy()
    p = model.params
    worst = 0.0
    for key in user_keys:
        code = d.entity_ids.index[key]
        rows = np.flatnonzero(batch.entity_id == code)
        rows = rows[np.argsort(batch.event_time[rows], kind="stable")]
        last = {}
        for j in rows:  # last write wins, in time order
            item = d.target_ids.values[int(batch.target_id[j])]
            last.pop(item, None)
            last[item] = float(batch.float_props["rating"][j])
        hist = [(i, v) for i, v in last.items()
                if i in model.item_ids][-512:]
        F = V[[model.item_ids[i] for i, _ in hist]]
        r = np.array([v for _, v in hist])
        reg = p.reg * max(len(hist), 1) if p.scale_reg_by_count else p.reg
        A = F.T @ F + (reg + 1e-6) * np.eye(F.shape[1])
        x = np.linalg.solve(A, F.T @ r)
        got = U[model.user_ids[key]]
        worst = max(worst, float(np.linalg.norm(got - x)
                                 / np.linalg.norm(x)))
    return worst


class CanaryProbeLog:
    """What each stream canary probe paid, recorded beside the trainer's
    own gate (which it leaves as it is): every ``recommend_products`` the
    canary calls is timed, every garbage-collector pause and every
    ``/queries.json`` the server answered is kept as a time span, and
    each canary check notes its verdict and the device and pinned-host
    allocator growth over it. A slow probe that overlaps a collection, a
    served query or one of this script's own polls (whose threads hold
    the interpreter lock in turn) shows which; the first launch on the
    candidate is marked. (The
    thread CPU clock is not used: on the card's host it ticks in 10 ms.)"""

    def __init__(self, trainer, qs, trainer_mod):
        self.trainer, self.qs, self.mod = trainer, qs, trainer_mod
        self.calls, self.probes, self.gc_spans, self.served = [], [], [], []
        #: this script's own /queries.json polls, client side (the whole
        #: request: its HTTP work in this process, and the server's)
        self.polls = []
        self._gc_t0 = None
        self._orig = (trainer_mod.recommend_products,
                      trainer._canary_check, qs.serve)

    def _gc(self, what, info) -> None:
        if what == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_spans.append((self._gc_t0, time.perf_counter(),
                                  info.get("generation")))

    @staticmethod
    def _alloc_counts() -> tuple:
        dev = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        host = getattr(torch.cuda, "host_memory_stats", lambda: {})()
        return dev, host.get("num_host_alloc", -1)

    def install(self) -> None:
        import gc

        rp, check_fn, serve = self._orig

        def probed(model, uidx, k):
            t0 = time.perf_counter()
            out = rp(model, uidx, k)
            self.probes.append((id(model), t0, time.perf_counter()))
            return out

        def canary(old, new, touched):
            start, a0 = len(self.probes), self._alloc_counts()
            verdict = check_fn(old, new, touched)
            a1 = self._alloc_counts()
            self.calls.append((id(old), id(new), start, len(self.probes),
                               verdict, a1[0] - a0[0], a1[1] - a0[1]))
            return verdict

        def timed_serve(body, **kw):
            t0 = time.perf_counter()
            try:
                return serve(body, **kw)
            finally:
                self.served.append((t0, time.perf_counter()))

        self.mod.recommend_products = probed
        self.trainer._canary_check = canary
        self.qs.serve = timed_serve
        gc.callbacks.append(self._gc)

    def remove(self) -> None:
        import gc

        self.mod.recommend_products = self._orig[0]
        self.trainer.__dict__.pop("_canary_check", None)
        self.qs.__dict__.pop("serve", None)
        if self._gc in gc.callbacks:
            gc.callbacks.remove(self._gc)

    def _overlaps(self, spans, t0, t1) -> float:
        return sum(max(0.0, min(t1, b) - max(t0, a)) for a, b, *_ in spans)

    def describe(self, n: int) -> str:
        """The ``n``-th canary check: verdict, the stable arm's samples,
        the candidate's (min of two a key), and what its slowest key's
        two samples overlapped."""
        old_id, new_id, lo, hi, verdict, dseg, dhost = self.calls[n]
        keys, first_new = [], None
        for mid, t0, t1 in self.probes[lo:hi]:
            if first_new is None and mid == new_id:
                first_new = t0
            if mid == old_id or not keys or len(keys[-1]["cand"]) == 2:
                keys.append({"stable": None, "cand": []})
            if mid == old_id:
                keys[-1]["stable"] = (t0, t1)
            else:
                keys[-1]["cand"].append((t0, t1))
        stable = [k["stable"][1] - k["stable"][0] for k in keys
                  if k["stable"] is not None]
        cands = [min(c[1] - c[0] for c in k["cand"]) for k in keys
                 if k["cand"]]
        if not cands:
            return f"canary check {n + 1}: no probes ({verdict})"
        worst = keys[int(np.argmax([min(c[1] - c[0] for c in k["cand"])
                                    if k["cand"] else -1 for k in keys]))]

        def sample(c) -> str:
            t0, t1 = c
            return (f"{(t1 - t0) * 1e3:.3f}ms (gc "
                    f"{self._overlaps(self.gc_spans, t0, t1) * 1e3:.3f}, "
                    f"a served query {self._overlaps(self.served, t0, t1) * 1e3:.3f}, "
                    f"a poll in flight {self._overlaps(self.polls, t0, t1) * 1e3:.3f}"
                    f"{', the first launch on the candidate' if t0 == first_new else ''})")

        action = "none" if verdict is None else verdict.action
        reason = "" if verdict is None else f" ({verdict.reason})"
        return (f"canary check {n + 1}: verdict={action}{reason} | stable "
                f"max {max(stable) * 1e3 if stable else float('nan'):.3f}ms "
                f"over {len(stable)} key(s), samples "
                f"{[round(s * 1e3, 3) for s in stable]} | candidate (min of "
                f"two) max {max(cands) * 1e3:.3f}ms over {len(cands)}, "
                f"samples {[round(c * 1e3, 3) for c in cands]} | slowest "
                f"candidate key: "
                + " / ".join(sample(c) for c in worst["cand"])
                + f" | device segments allocated +{dseg}, pinned host "
                f"blocks allocated +{dhost}")


#: events of the stream phase's traced burst (one /batch/events.json)
STREAM_TRACED_EVENTS = 48


def stream_traced_burst(ev_port: int, srv, q: str, users: list) -> str:
    """One burst through ``/batch/events.json`` with a ``traceparent``:
    the event server stamps the caller's context into each event, and the
    restarted trainer's pass over them must be retained as that trace's
    ``stream.foldin`` (parent: the caller's span) and launch
    ``fused_gram`` and ``chol_solve``. The stamp is the ingest request's
    own context (the caller's trace id, the request's span), so the pass's
    parent is the ingest request's span. Returns the line's summary."""
    from predictionio_tpu_torch.data.event import from_millis, isoformat_millis
    from predictionio_tpu_torch.obs.trace import parse_traceparent

    rng = np.random.default_rng(len(users))
    tp = f"00-{rng.bytes(16).hex()}-{rng.bytes(8).hex()}-01"
    trace_id = parse_traceparent(tp)[0]
    qs = srv.query_server
    model = qs.models[0]
    items = [k for k, _ in model.item_ids.items()]
    now_ms = int(time.time() * 1000)  # after every event consumed so far
    block = [{"event": "rate", "entityType": "user",
              "entityId": users[n % 4], "targetEntityType": "item",
              "targetEntityId": items[int(rng.integers(0, len(items)))],
              "properties": {"rating": float(rng.integers(1, 6))},
              "eventTime": isoformat_millis(from_millis(now_ms + n))}
             for n in range(STREAM_TRACED_EVENTS)]
    trainer = qs.stream
    applies0 = trainer.applies + trainer.rejects
    before = launch_counts()
    status, body, headers = http_status(
        ev_port, "POST", f"/batch/events.json{q}", block,
        {"traceparent": tp})
    check(status == 200 and all(r["status"] == 201 for r in body),
          f"the traced burst: {status} {body[:3]}")
    ingest_trace, parent = parse_traceparent(headers["traceparent"])
    check(ingest_trace == trace_id, "the ingest did not join the trace")
    deadline = time.perf_counter() + 120
    while trainer.applies + trainer.rejects == applies0:
        check(time.perf_counter() < deadline,
              "the traced burst was never folded")
        time.sleep(0.02)
    after = launch_counts()
    trace = qs.tracer.recorder.get(trace_id)
    check(trace is not None and trace.name == "stream.foldin"
          and trace.parent_span_id == parent
          and trace.retained_reason == "stream",
          f"the traced burst's pass was not retained as {trace_id}'s "
          f"stream.foldin: {trace and trace.summary()}")
    launched = {k: after[k] - before[k] for k in after}
    check(launched["fused_gram"] > 0 and launched["chol_solve"] > 0,
          f"the traced pass launched {launched}")
    return (f"traced burst of {STREAM_TRACED_EVENTS} through "
            f"/batch/events.json: stream.foldin {trace_id} retained "
            f"(parent {parent}, outcome {trace.attrs.get('outcome')}, "
            f"{trace.summary()['durationMs']} ms, spans "
            f"{[s.name for s in trace.spans]}), its pass launched "
            f"fused_gram={launched['fused_gram']} chol_solve="
            f"{launched['chol_solve']}")


def phase_stream(data, dev, home: str, pio: dict, seed: int) -> dict:
    """Streaming fold-in on the ``pio`` phase's store and model: deploy
    with the stream trainer through the CLI, post 3 bursts of 288
    ``rate`` events as column blocks, each after the previous pass has
    applied, and check what the server then holds."""
    from predictionio_tpu_torch import cli
    from predictionio_tpu_torch.data.event import from_millis
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models.als import _table_leaves
    from predictionio_tpu_torch.ops import fused_gram as fg
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.ops import gram
    from predictionio_tpu_torch.ops import solve as sv
    from predictionio_tpu_torch.streaming import EventCursor
    from predictionio_tpu_torch.streaming import foldin
    from predictionio_tpu_torch.streaming import trainer as trainer_mod

    bursts = stream_bursts(data, seed)
    storage = Storage(env={"PIO_HOME": home})
    wrapped, canary_log, servers = {}, None, []
    try:
        app = storage.apps().get_by_name(PIO_APP)
        key = storage.access_keys().get_by_app_id(app.id)[0].key
        # the trainer's cursor starts where the trained log ends
        cur = EventCursor(storage, app.id, "stream-trainer")
        cur.position = from_millis(pio["log_end_ms"])
        cur.save()
        evs = cli.build_eventserver(cli._parser().parse_args(
            ["eventserver", "--ip", "127.0.0.1", "--port", "0"]),
            storage).start_background()
        servers.append(evs)
        args = cli._parser().parse_args([
            "deploy", "--engine-json", pio["engine_json"], "--ip",
            "127.0.0.1", "--port", "0", "--batching", "--stream",
            "--stream-app", PIO_APP, "--stream-max-events", "512",
            "--stream-interval-ms", "100"])
        t = time.perf_counter()
        srv = cli.build_deploy(args, storage).start_background()
        servers.append(srv)
        deploy_s = time.perf_counter() - t
        warmed(srv)
        qs = srv.query_server
        trainer = qs.stream
        check(trainer is not None and trainer.running,
              "deploy --stream started no trainer")
        base = qs.models[0]
        U0 = _table_leaves(base.user_factors)[0].clone()
        V0 = _table_leaves(base.item_factors)[0].clone()
        n_users0, n_items0 = base.n_users, base.n_items

        # time the pass's stages by wrapping the fold-in's own calls
        spent = {"reads": 0.0, "solve": 0.0, "apply": 0.0}

        def timed(fn, stage, sync=False):
            def run(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                if sync:
                    torch.cuda.synchronize()
                spent[stage] += time.perf_counter() - t0
                return out
            return run

        for name, stage, sync in (("_entity_history", "reads", False),
                                  ("fold_in_rows", "solve", False),
                                  ("apply_row_updates", "apply", True),
                                  ("extend_factor_rows", "apply", True)):
            wrapped[name] = getattr(foldin, name)
            setattr(foldin, name, timed(wrapped[name], stage, sync))
        qs.apply_stream_delta = timed(qs.apply_stream_delta, "apply")
        canary_log = CanaryProbeLog(trainer, qs, trainer_mod)
        canary_log.install()

        q = f"?accessKey={key}"
        touched, cold_users, canary_printed = [], [], 0
        # -- the stream path, counted -----------------------------------
        fg.LAUNCHES = sv.LAUNCHES = ft.LAUNCHES = gram.LAUNCHES = 0
        t_next = pio["log_end_ms"]
        for b, (bu, bi, bs) in enumerate(bursts):
            for k in spent:
                spent[k] = 0.0
            before = (fg.LAUNCHES, sv.LAUNCHES, ft.LAUNCHES)
            # a burst's events end now; a cursor never reads an event
            # stamped before the last one it consumed
            t_first = max(int(time.time() * 1000) - len(bu) + 1, t_next)
            t_next = t_first + len(bu)
            raw = rating_block(bu, bi, bs, t_first)
            status, body = _http(evs.port, "POST",
                                 f"/columnar/events.npz{q}", raw=raw)
            t_201 = time.perf_counter()
            check(status == 201 and body["accepted"] == len(bu),
                  f"burst {b}: {status} {body}")
            cold = sorted({f"u{u}" for u in
                           bu[STREAM_USERS * STREAM_USER_EVENTS:
                              STREAM_USERS * STREAM_USER_EVENTS
                              + STREAM_COLD * STREAM_COLD_EVENTS]})
            polls = 0

            def report_canary():
                nonlocal canary_printed
                while canary_printed < len(canary_log.calls):
                    print(f"phase stream: pass {b + 1}: "
                          + canary_log.describe(canary_printed), flush=True)
                    canary_printed += 1

            while True:
                t_poll = time.perf_counter()
                answer, _ = _post(srv.port, {"user": cold[0], "num": 10})
                canary_log.polls.append((t_poll, time.perf_counter()))
                polls += 1
                report_canary()
                if len(answer["itemScores"]) == 10:
                    break
                # a refused delta never serves: fail now, not at 300 s
                check(trainer.rejects == 0,
                      f"burst {b}: the stream canary refused the fold-in")
                check(time.perf_counter() - t_201 < 300,
                      f"burst {b}: never servable")
                time.sleep(0.05)
            servable_s = time.perf_counter() - t_201
            deadline = time.perf_counter() + 60
            while trainer.applies < b + 1 and time.perf_counter() < deadline:
                time.sleep(0.01)
            report_canary()
            check(trainer.applies == b + 1,
                  f"burst {b}: {trainer.applies} applies")
            last = dict(trainer.status()["lastBatch"])
            launched = (fg.LAUNCHES - before[0], sv.LAUNCHES - before[1],
                        ft.LAUNCHES - before[2])
            fold_ms = last["foldinMs"]
            staged = sum(spent.values()) * 1e3
            print(f"phase stream: pass {b + 1}: events={last['events']} "
                  f"relevant={last['relevant']} usersUpdated="
                  f"{last['usersUpdated']} usersInserted="
                  f"{last['usersInserted']} itemsInserted="
                  f"{last['itemsInserted']} | foldinMs={fold_ms:.1f} = "
                  f"history reads {spent['reads'] * 1e3:.1f} (share "
                  f"{spent['reads'] * 1e3 / fold_ms:.3f}) + fold_in_rows "
                  f"on the card {spent['solve'] * 1e3:.1f} + apply and swap "
                  f"{spent['apply'] * 1e3:.1f} + the rest (canary, "
                  f"residual, cursor save) {fold_ms - staged:.1f} | "
                  f"event_to_servable_s={servable_s:.3f} ({polls} "
                  f"/queries.json polls) | launches fused_gram="
                  f"{launched[0]} chol_solve={launched[1]} fused_topk="
                  f"{launched[2]} (canary probes and the polls)", flush=True)
            check(last["events"] == len(bu) and last["relevant"] == len(bu),
                  f"burst {b}: the pass took {last['events']} events")
            check(last["usersUpdated"] == STREAM_USERS
                  and last["usersInserted"] == STREAM_COLD
                  and last["itemsInserted"] == STREAM_NEW_ITEMS,
                  f"burst {b}: pass {last}")
            touched += sorted({f"u{u}" for u in bu[:STREAM_USERS
                                                   * STREAM_USER_EVENTS]})
            cold_users += cold
        stream_l = {"fused_gram": fg.LAUNCHES, "chol_solve": sv.LAUNCHES,
                    "fused_topk": ft.LAUNCHES, "gram_table": gram.LAUNCHES}
        # ----------------------------------------------------------------
        for name in ("fused_gram", "chol_solve", "fused_topk"):
            check(stream_l[name] > 0,
                  f"the stream path launched {name} no time")

        model = qs.models[0]
        worst = f64_fold_check(storage, app.id, model, touched)
        check(worst <= 1e-3, f"a folded row is off its float64 solve by "
              f"{worst:.3e} (normwise relative)")
        U1 = _table_leaves(model.user_factors)[0]
        V1 = _table_leaves(model.item_factors)[0]
        keep = torch.ones(n_users0, dtype=torch.bool, device=dev)
        keep[[base.user_ids[u] for u in touched]] = False
        check(torch.equal(U1[:n_users0][keep], U0[:n_users0][keep])
              and torch.equal(V1[:n_items0], V0[:n_items0]),
              "a row no event touched changed")
        check(torch.equal(_table_leaves(base.user_factors)[0], U0)
              and torch.equal(_table_leaves(base.item_factors)[0], V0)
              and base.n_items == n_items0 and base.n_users == n_users0
              and len(base.user_ids) == n_users0,
              "the model bound before the first pass was written")
        check(model.n_items == n_items0 + STREAM_BURSTS * STREAM_NEW_ITEMS,
              f"n_items {n_items0} -> {model.n_items}")
        ud, us = _table_leaves(model.user_factors)
        vd, vs = _table_leaves(model.item_factors)
        U64 = ud.double() * (us.double() if us is not None else 1.0)
        V64 = vd.double() * (vs.double() if vs is not None else 1.0)
        for u in cold_users:
            query = {"user": u, "num": 10}
            answer, _ = _post(srv.port, query)
            check(len(answer["itemScores"]) == 10,
                  f"cold user {u}: {len(answer['itemScores'])} items")
            check_answer(query, answer, ud, us, vd, vs, U64, V64,
                         model.n_items, dev, model.user_ids, model.item_ids)
        deadline = time.perf_counter() + 30
        while time.perf_counter() < deadline:
            _, st = _http(srv.port, "GET", "/stream.json")
            if st["cursorLag"] == 0:
                break
            time.sleep(0.05)
        check(st["applies"] == STREAM_BURSTS and st["canaryRejects"] == 0
              and st["cursorLag"] == 0,
              f"/stream.json: applies={st['applies']} canaryRejects="
              f"{st['canaryRejects']} cursorLag={st['cursorLag']}")
        lineage = st["lineage"]
        # the pio_stream_* families hold the trainer's own counts
        fam, _ = parse_exposition(scrape(srv.port))
        want = {
            "pio_stream_applies_total": {"": trainer.applies},
            "pio_stream_events_consumed_total": {
                "": trainer.events_consumed},
            "pio_stream_rows_updated_total": {
                '{kind="updated"}': STREAM_BURSTS * STREAM_USERS,
                '{kind="user_cold"}': STREAM_BURSTS * STREAM_COLD,
                '{kind="item_cold"}': STREAM_BURSTS * STREAM_NEW_ITEMS},
            "pio_stream_cursor_lag": {"": st["cursorLag"]},
            "pio_stream_running": {"": 1.0},
            "pio_stream_foldin_seconds_count": {"": trainer.applies},
            "pio_stream_freshness_seconds_count": {
                "": trainer.events_consumed}}
        for name, value in want.items():
            check(fam.get(name) == value,
                  f"{name} {fam.get(name)} against the trainer's {value}")
        check(not any(fam.get("pio_stream_canary_rejects_total",
                              {}).values()), "pio_stream_canary_rejects")
        check(_http(srv.port, "POST", "/stream/stop")[0] == 200,
              "/stream/stop refused")
        status, _ = _http(srv.port, "POST", "/stream/start",
                          {"appName": PIO_APP, "consumer": "stream-trainer",
                           "intervalMs": 100})
        check(status == 200, f"/stream/start answered {status}")
        time.sleep(0.5)
        _, again = _http(srv.port, "GET", "/stream.json")
        check(again["running"] and again["eventsConsumed"] == 0
              and again["cursor"]["consumed"]
              == STREAM_BURSTS * len(bursts[0][0]),
              f"a restart with the same consumer consumed "
              f"{again['eventsConsumed']} events")
        traced = stream_traced_burst(evs.port, srv, q, touched)
        srv.close()
        evs.close()
        alive = [th.name for th in threading.enumerate()
                 if th.name == "stream-trainer" and th.is_alive()]
        check(not alive, f"srv.close() left {alive}")
        print(f"phase stream: {STREAM_BURSTS} bursts of {len(bursts[0][0])} "
              f"rate events through /columnar/events.npz on the pio store "
              f"| deploy --stream to serving {deploy_s:.3f}s | "
              f"{len(touched)} folded users within {worst:.3e} of their "
              f"float64 solves, untouched rows and the first bound model "
              f"bit-identical, {len(cold_users)} cold users answer 10 items "
              f"each, n_items {n_items0} -> {model.n_items} | /stream.json "
              f"applies={st['applies']} canaryRejects={st['canaryRejects']} "
              f"cursorLag={st['cursorLag']} lineage generation="
              f"{lineage['incrementalGeneration']} rows="
              f"{lineage['incrementalRows']} | stop then start with the "
              f"same consumer consumed 0 | launches on the stream path "
              f"fused_gram={stream_l['fused_gram']} chol_solve="
              f"{stream_l['chol_solve']} fused_topk={stream_l['fused_topk']}"
              f" gram_table={stream_l['gram_table']} | pio_stream_* equal "
              f"to the trainer's counts | {traced}", flush=True)
        return stream_l
    finally:
        for name, fn in wrapped.items():
            setattr(foldin, name, fn)
        if canary_log is not None:
            canary_log.remove()
        for server in reversed(servers):  # a failed check left them up
            server.close()
        storage.close()



# -- the e-commerce and similar-product templates -----------------------------

TEMPLATES_APP = "TemplatesApp"
#: every TEMPLATES_USER_STRIDE-th surrogate user, on the most-rated
#: TEMPLATES_ITEMS items (the dense co-occurrence path holds up to
#: sqrt(64 M) = 8,192 items). The e-commerce point reads scan the app's
#: whole table (the shared schema indexes only event_time) against a
#: 200 ms deadline: at every 100th user (463,198 events) they ran past it,
#: so the store is cut to every 200th
TEMPLATES_USER_STRIDE = 200
TEMPLATES_ITEMS = 8_000
TEMPLATES_CATEGORIES = 20
#: |d| <= TEMPLATES_RTOL * (1 + |plain|): an e-commerce answer's scores
#: (sums of f32 products in numpy) against the float64 recomputation, and
#: how close two plain scores must be to be a near-tie that either may
#: order its own way
TEMPLATES_RTOL = 1e-5
#: the relative error allowed an f32 cosine sum of the similar-product
#: ALS lists (f32 rounding is ~6e-8 of it); a z-score divides it by the
#: list's spread, so each ALS list adds 2 * SP_COSINE_RTOL * (1 + max|s|)
#: / std to the tolerance of the summed z-scores (the co-occurrence
#: counts are exact)
SP_COSINE_RTOL = 1e-6


def template_event_lines(data, seed: int, t0_ms: int) -> tuple:
    """The templates' store as API JSON lines: ``$set`` for every user and
    for every item (1-3 of 20 categories), then, for each rating of s
    stars, a ``view``, a second ``view`` where s >= 4, a ``buy`` where
    s >= 4.5, a ``like`` where s >= 4 and a ``dislike`` where s <= 2,
    then the ``unavailableItems`` (50 items) and ``weightedItems`` (2
    groups) constraints. Each event has its own millisecond."""
    from predictionio_tpu_torch.data.event import from_millis, isoformat_millis

    users, items, stars, _, n_items = data
    top = np.argsort(-np.bincount(items, minlength=n_items),
                     kind="stable")[:TEMPLATES_ITEMS]
    keep = (users % TEMPLATES_USER_STRIDE == 0) & np.isin(items, top)
    u, i, s = users[keep], items[keep], stars[keep]
    rng = np.random.default_rng(seed + 9)
    cats = {int(x): sorted(rng.choice(TEMPLATES_CATEGORIES,
                                      int(rng.integers(1, 4)),
                                      replace=False).tolist())
            for x in np.sort(top)}
    lines = []
    t = [t0_ms]

    def add(event: dict) -> None:
        event["eventTime"] = isoformat_millis(from_millis(t[0]))
        t[0] += 1
        lines.append(json.dumps(event))

    for x in np.unique(u).tolist():
        add({"event": "$set", "entityType": "user", "entityId": f"u{x}"})
    for x, c in cats.items():
        add({"event": "$set", "entityType": "item", "entityId": f"i{x}",
             "properties": {"categories": [f"c{k}" for k in c]}})
    names = [("view", s >= 0), ("view", s >= 4), ("buy", s >= 4.5),
             ("like", s >= 4), ("dislike", s <= 2)]
    for k, (uu, ii) in enumerate(zip(u.tolist(), i.tolist())):
        for name, mask in names:
            if mask[k]:
                add({"event": name, "entityType": "user",
                     "entityId": f"u{uu}", "targetEntityType": "item",
                     "targetEntityId": f"i{ii}"})
    pick = rng.choice(top, 130, replace=False)
    add({"event": "$set", "entityType": "constraint",
         "entityId": "unavailableItems",
         "properties": {"items": [f"i{x}" for x in pick[:50]]}})
    add({"event": "$set", "entityType": "constraint",
         "entityId": "weightedItems", "properties": {"weights": [
             {"items": [f"i{x}" for x in pick[50:90]], "weight": 2.0},
             {"items": [f"i{x}" for x in pick[90:]], "weight": 0.5}]}})
    return lines, u, i, np.sort(top), t[0]


def plain_top(scores, mask, num: int, positive_only: bool) -> list:
    """(index, score) of the ``num`` best candidates, descending: the
    templates' selection rule, recomputed here in numpy."""
    s = np.where(mask, scores, -np.inf)
    if positive_only:
        s = np.where(s > 0, s, -np.inf)
    k = min(num, len(s))
    if k <= 0:
        return []
    idx = np.argpartition(-s, k - 1)[:k] if k < len(s) else np.argsort(-s)
    idx = idx[np.argsort(-s[idx], kind="stable")]
    return [(int(j), float(s[j])) for j in idx if np.isfinite(s[j])]


def plain_mask(n: int, item_ids, item_cats: list, q: dict,
               black=(), exclude=()) -> np.ndarray:
    """The candidate filter: white list, black list and the query's own
    items out, then the categories and the category black list."""
    mask = np.ones(n, bool)
    if q.get("whiteList") is not None:
        white = np.zeros(n, bool)
        white[[item_ids[x] for x in q["whiteList"] if x in item_ids]] = True
        mask &= white
    for x in list(black) + list(q.get("blackList") or ()):
        if x in item_ids:
            mask[item_ids[x]] = False
    mask[list(exclude)] = False
    if q.get("categories") is not None:
        want = set(q["categories"])
        mask &= np.array([bool(c) and bool(set(c) & want)
                          for c in item_cats])
    if q.get("categoryBlackList") is not None:
        bad = set(q["categoryBlackList"])
        mask &= np.array([not (set(c or ()) & bad) for c in item_cats])
    return mask


def near(a: float, b: float, rtol: float = TEMPLATES_RTOL,
         atol: float = 0.0) -> bool:
    return abs(a - b) <= rtol * (1 + abs(b)) + atol


def held_to(answer: list, ref: list, score_of, tag: str,
            atol: float = 0.0) -> bool:
    """An answer's (item, score) list against the plain one: equal ids
    but inside a near-tie (the answered item's plain score within the
    tolerance of the plain list's at that place), each score near its
    item's plain score; ``atol`` widens the tolerance. Returns whether a
    near-tie reordered it."""
    check(len(answer) == len(ref),
          f"{tag}: {len(answer)} items, the plain recomputation "
          f"{len(ref)}: {answer} vs {ref}")
    tied = False
    for (item, score), (ritem, rscore) in zip(answer, ref):
        plain = score_of(item)
        check(plain is not None and near(score, plain, atol=atol),
              f"{tag}: {item} scored {score}, plain {plain}")
        if item != ritem:
            check(near(plain, rscore, atol=atol),
                  f"{tag}: {item} ({plain}) where the plain list has "
                  f"{ritem} ({rscore})")
            tied = True
    return tied


def ecomm_plain(model, q: dict, reads: dict, params: dict) -> tuple:
    """The e-commerce answer recomputed in float64 on the host from the
    persisted model and the store's reads: ``(list, score_of)``."""
    n = len(model.item_ids)
    w = np.ones(n)
    for items, weight in reads["weights"]:
        w[[model.item_ids[x] for x in items if x in model.item_ids]] = weight
    black = set(reads["unavailable"])
    if params["unseen_only"]:
        black |= reads["seen"]
    cats = [model.items[j].categories for j in range(n)]
    mask = plain_mask(n, model.item_ids, cats, q, black=black)
    U = model.user_factors.astype(np.float64)
    V = model.item_factors.astype(np.float64)
    u = model.user_ids.get(q["user"])
    positive = True
    if u is not None and model.has_user[u]:
        scores = V @ U[u] * w
    else:
        recent = sorted({model.item_ids[x] for x in reads["recent"]
                         if x in model.item_ids})
        recent = [j for j in recent if model.has_item[j]]
        if recent:
            Vn = V / np.maximum(np.linalg.norm(V, axis=1, keepdims=True),
                                1e-12)
            scores = Vn[recent].sum(0) @ Vn.T * w
        else:
            scores = model.popular_count.astype(np.float64) * w
            positive = False
    if positive:
        scores = np.where(model.has_item, scores, 0.0)
    ok = mask & (scores > 0 if positive else True)
    inv = model.item_ids.inverse
    ref = [(inv[j], s) for j, s in plain_top(scores, mask, q["num"],
                                              positive)]

    def score_of(item):
        j = model.item_ids.get(item)
        return float(scores[j]) if j is not None and ok[j] else None

    return ref, score_of


def sp_plain(models: list, q: dict) -> tuple:
    """The similar-product answer recomputed in float64: both ALS
    variants' summed cosine, the co-occurrence counts, each list's
    z-scores (none at num == 1) summed per item. Returns ``(list,
    score_of, atol, cut_tied)``: ``atol`` is what the ALS lists' f32
    rounding may add to a summed score; ``cut_tied`` is True where an
    ALS list's last place and the next candidate are a near-tie (which
    changes the members and so every z-score)."""
    lists, cut_tied, errs = [], False, []
    for m in models:
        if isinstance(m, tuple):
            cooc, ids, items = m
            n = cooc.n_items
            qidx = sorted({ids[x] for x in q["items"] if x in ids})
            scores = np.zeros(n)
            for a in qidx:
                keep = cooc.indices[a] >= 0
                np.add.at(scores, cooc.indices[a][keep],
                          cooc.counts[a][keep].astype(np.float64))
        else:
            ids, items, n = m.item_ids, m.items, len(m.item_ids)
            qidx = sorted({ids[x] for x in q["items"] if x in ids})
            V = m.item_factors.astype(np.float64)
            Vn = V / np.maximum(np.linalg.norm(V, axis=1, keepdims=True),
                                1e-12)
            qf = [j for j in qidx if m.has_factors[j]]
            if not qf:
                lists.append([])
                continue
            scores = np.where(m.has_factors, Vn[qf].sum(0) @ Vn.T, 0.0)
        cats = [items[j].categories for j in range(n)]
        mask = plain_mask(n, ids, cats, q, exclude=qidx)
        if isinstance(m, tuple):
            # integer counts tie exactly: the template's selection on the
            # same array picks the same members
            top = plain_top(scores, mask, q["num"], True)
        else:
            top = plain_top(scores, mask, q["num"] + 1, True)
            if len(top) > q["num"]:
                cut_tied |= near(top[q["num"]][1], top[q["num"] - 1][1],
                                 SP_COSINE_RTOL)
        inv = ids.inverse
        lists.append([(inv[j], s) for j, s in top[:q["num"]]])
        errs.append(0.0 if isinstance(m, tuple) else SP_COSINE_RTOL * (
            1 + max((abs(s) for _, s in top), default=0.0)))
    if q["num"] != 1:
        std_lists = []
        for k, lst in enumerate(lists):
            vals = np.array([s for _, s in lst])
            if vals.size and vals.std() > 0:
                mean, std = vals.mean(), vals.std(ddof=1)
                errs[k] *= 2 / std
            else:
                mean, std = 0.0, 0.0
            std_lists.append([(x, 0.0 if std == 0 else (s - mean) / std)
                              for x, s in lst])
        lists = std_lists
    combined: dict = {}
    for lst in lists:
        for x, s in lst:
            combined[x] = combined.get(x, 0.0) + s
    ref = sorted(combined.items(), key=lambda kv: -kv[1])[:q["num"]]
    return ref, combined.get, sum(errs), cut_tied


def store_reads(storage, app_id: int, user: str, params: dict) -> dict:
    """What the e-commerce serving reads, read from the store with no
    deadline."""
    from predictionio_tpu_torch.data.storage.base import EventFilter

    def find(**kw):
        return list(storage.events().find(app_id, filter=EventFilter(**kw)))

    latest = {}
    for name, key in (("unavailableItems", "items"),
                      ("weightedItems", "weights")):
        evs = find(entity_type="constraint", entity_id=name,
                   event_names=["$set"], limit=1, reversed=True)
        latest[name] = (evs[0].properties.get(key) or ()) if evs else ()
    return {
        "seen": {e.target_entity_id for e in find(
            entity_type="user", entity_id=user,
            event_names=list(params["seen_events"]),
            target_entity_type="item") if e.target_entity_id},
        "recent": {e.target_entity_id for e in find(
            entity_type="user", entity_id=user,
            event_names=list(params["similar_events"]),
            target_entity_type="item", limit=10, reversed=True)
            if e.target_entity_id},
        "unavailable": set(latest["unavailableItems"]),
        "weights": [(set(g["items"]), float(g["weight"]))
                    for g in latest["weightedItems"]],
    }


def cooc_plain(storage, app_id: int, model, user_ids) -> tuple:
    """The co-occurrence top-N from a numpy count of the stored views'
    distinct (user, item) pairs: every ordered pair of distinct items in
    a user's basket counted with ``np.bincount``, each item's top N by
    (-count, index), pads -1 with count 0."""
    from predictionio_tpu_torch.data.storage.base import EventFilter

    cooc, item_ids, _ = model
    n = cooc.n_items
    baskets: dict = {}
    for e in storage.events().find(app_id, filter=EventFilter(
            entity_type="user", event_names=["view"],
            target_entity_type="item")):
        if e.entity_id in user_ids and e.target_entity_id in item_ids:
            baskets.setdefault(e.entity_id, set()).add(
                item_ids[e.target_entity_id])
    pairs = []
    for b in baskets.values():
        b = np.array(sorted(b), np.int64)
        pairs.append((b[:, None] * n + b[None, :]).ravel())
    C = np.bincount(np.concatenate(pairs), minlength=n * n).reshape(n, n)
    np.fill_diagonal(C, 0)
    k = cooc.indices.shape[1]
    key = C * n + (n - 1 - np.arange(n))
    part = np.argpartition(-key, k - 1, axis=1)[:, :k]
    top = -np.sort(-np.take_along_axis(key, part, 1), axis=1)
    counts = (top // n).astype(np.float32)
    idx = np.where(counts > 0, n - 1 - top % n, -1).astype(np.int32)
    return idx, np.where(counts > 0, counts, 0).astype(np.float32)


def templates_over_mesh(trained: dict, storage, als_walls: dict,
                        current: list, dev, card: dict) -> dict:
    """Both shipped variants again through ``Engine.train``, over a mesh
    of MESH_TRAIN_SHARDS positions on the one card (the context's mesh),
    on the training data ``cli train`` read (kept by phase templates'
    data sources): every ALS table within MESH_IMPLICIT_RTOL (1 +
    |x|) of the one-card training ``cli train`` stored, ``fused_gram``
    and ``chol_solve`` counted and positive, each ALS training's
    iteration time (``als_walls``, from the timed ``train_als``) beside
    the one card's."""
    from predictionio_tpu_torch import cli
    from predictionio_tpu_torch.controller.context import Context

    mesh = forced_mesh(MESH_TRAIN_SHARDS, dev)
    total = {"fused_gram": 0, "chol_solve": 0}
    for name in ("ecommerce", "similarproduct"):
        _, variant, one_card = trained[name]
        engine, ep = cli.engine_from_variant(variant)
        current[0] = name
        zero_launch_counts()
        models = engine.train(Context(device=dev, mesh=mesh,
                                      _storage=storage), ep).models
        torch.cuda.synchronize()
        launched = launch_counts()
        check(launched["fused_gram"] > 0 and launched["chol_solve"] > 0,
              f"{name} over a mesh launched {launched}")
        worst, tables = 0.0, 0
        for got, want in zip(models, one_card):
            for attr in ("user_factors", "item_factors"):
                if not hasattr(want, attr):
                    continue  # co-occurrence: no factor table
                g = np.asarray(getattr(got, attr))
                w = np.asarray(getattr(want, attr))
                check(g.shape == w.shape, f"{name} {attr}: {g.shape} over "
                      f"a mesh, {w.shape} on one card")
                rel = np.abs(g - w) / (1 + np.abs(w))
                check(bool((rel <= MESH_IMPLICIT_RTOL).all()),
                      f"{name} {attr} over a mesh: {rel.max():.3e} (1 + "
                      f"|x|) off the one card's")
                worst = max(worst, float(rel.max()))
                tables += 1
        iters = [a["params"]["num_iterations"] for a in variant["algorithms"]
                 if "num_iterations" in a["params"]]
        one_ms = [w / n * 1e3 for w, n in zip(als_walls[(name, False)],
                                               iters)]
        mesh_ms = [w / n * 1e3 for w, n in zip(als_walls[(name, True)],
                                                iters)]
        print(f"phase templates over a mesh: {name} through Engine.train "
              f"over {MESH_TRAIN_SHARDS} positions on the one card | "
              f"{tables} factor tables within {worst:.3e} (1 + |x|) of the "
              f"one card's (limit {MESH_IMPLICIT_RTOL:g}) | launches "
              f"fused_gram={launched['fused_gram']} chol_solve="
              f"{launched['chol_solve']} | ALS iteration ms, each ALS "
              f"algorithm: mesh {[round(x, 3) for x in mesh_ms]} one card "
              f"{[round(x, 3) for x in one_ms]} | {card_tag(card)}",
              flush=True)
        for k in total:
            total[k] += launched[k]
    return total


def phase_templates(data, dev, home: str, seed: int,
                    card: Optional[dict] = None) -> dict:
    """The shipped e-commerce and similar-product variants end to end in
    an app of their own: ``cli import``, ``cli train`` (launches counted),
    ``cli deploy`` and 32 HTTP queries each, every answer held against
    its float64 recomputation, the co-occurrence model against a numpy
    count. Every serving-time point read is timed and none may raise."""
    from predictionio_tpu_torch import cli
    from predictionio_tpu_torch.data import store as pstore
    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.data.event import Event, from_millis
    from predictionio_tpu_torch.data.storage.base import STATUS_COMPLETED
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.ops import fused_gram as fg
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.ops import gram
    from predictionio_tpu_torch.ops import solve as sv
    from predictionio_tpu_torch.templates import _common
    from predictionio_tpu_torch.templates import ecommerce as pec
    from predictionio_tpu_torch.templates import similarproduct as psp
    from predictionio_tpu_torch.workflow.persistence import loads_models

    root = Path(__file__).resolve().parent
    t0_ms = 1_750_000_000_000
    t = time.perf_counter()
    lines, u, i, top, t_end = template_event_lines(data, seed, t0_ms)
    events_path = Path(home) / "templates_events.jsonl"
    events_path.write_text("\n".join(lines) + "\n")
    build_s = time.perf_counter() - t
    storage = Storage(env={"PIO_HOME": home})
    reads = {"s": [], "errors": []}
    plain_find = pstore.EventStoreFacade.find_by_entity

    def timed_find(self, *args, **kwargs):
        t = time.perf_counter()
        try:
            return plain_find(self, *args, **kwargs)
        except Exception as e:  # counted, then the template's handling
            reads["errors"].append(repr(e))
            raise
        finally:
            reads["s"].append(time.perf_counter() - t)

    fg.LAUNCHES = sv.LAUNCHES = ft.LAUNCHES = gram.LAUNCHES = 0
    per_algo = []
    plain_sp_train = psp.SPALSAlgorithm.train

    def counted_sp_train(self, ctx, td):
        before = (fg.LAUNCHES, sv.LAUNCHES)
        model = plain_sp_train(self, ctx, td)
        per_algo.append((type(self).__name__, fg.LAUNCHES - before[0],
                         sv.LAUNCHES - before[1]))
        return model

    # each template ALS training's wall, by (template, over a mesh)
    als_walls: dict = {}
    current = [""]
    plain_train_als = _common.train_als

    def timed_train_als(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = plain_train_als(*args, **kwargs)
        torch.cuda.synchronize()
        als_walls.setdefault((current[0], kwargs.get("mesh") is not None),
                             []).append(time.perf_counter() - t)
        return out

    # the trainings over a mesh read what cli train read (the store is
    # untouched in between): each data source's first read is kept
    sources = (pec.ECommerceDataSource, psp.SimilarProductDataSource)
    plain_reads = {cls: cls.read_training for cls in sources}
    kept_reads: dict = {}

    def kept_read(cls):
        def read_training(self, ctx):
            if cls not in kept_reads:
                kept_reads[cls] = plain_reads[cls](self, ctx)
            return kept_reads[cls]
        return read_training

    pstore.EventStoreFacade.find_by_entity = timed_find
    psp.SPALSAlgorithm.train = counted_sp_train
    _common.train_als = timed_train_als
    for cls in sources:
        cls.read_training = kept_read(cls)
    try:
        check(cli.main(["app", "new", TEMPLATES_APP], storage=storage) == 0,
              "app new failed")
        app_id = storage.apps().get_by_name(TEMPLATES_APP).id
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["import", "--app", TEMPLATES_APP, "--input",
                           str(events_path)], storage=storage)
        import_s = time.perf_counter() - t
        check(rc == 0 and f"Imported {len(lines)} event(s)." in
              out.getvalue(), f"cli import: {rc} {out.getvalue()}")

        trained = {}
        for name in ("ecommerce", "similarproduct"):
            variant = json.loads((root / "examples" / name /
                                  "engine.json").read_text())
            variant["datasource"]["params"]["app_name"] = TEMPLATES_APP
            for algo in variant["algorithms"]:
                if "app_name" in algo["params"]:
                    algo["params"]["app_name"] = TEMPLATES_APP
            path = Path(home) / f"{name}.json"
            path.write_text(json.dumps(variant))
            before = (fg.LAUNCHES, sv.LAUNCHES)
            out = io.StringIO()
            current[0] = name
            t = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["train", "--engine-json", str(path)],
                              storage=storage)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t
            check(rc == 0, f"cli train {name}: {rc} {out.getvalue()}")
            launched = (fg.LAUNCHES - before[0], sv.LAUNCHES - before[1])
            check(launched[0] > 0 and launched[1] > 0,
                  f"cli train {name} launched fused_gram {launched[0]} and "
                  f"chol_solve {launched[1]} times")
            stages = json.loads(next(
                ln for ln in out.getvalue().splitlines()
                if ln.startswith("Train stages: "))[len("Train stages: "):])
            (inst,) = [x for x in storage.engine_instances().get_all()
                       if x.engine_id == variant["id"]]
            check(inst.status == STATUS_COMPLETED,
                  f"{name}: instance {inst.id} is {inst.status}")
            models = loads_models(storage.models().get(inst.id).models)
            trained[name] = (path, variant, models)
            print(f"phase templates: cli train {name} {train_s:.3f}s stages "
                  f"{stages} | launches fused_gram={launched[0]} "
                  f"chol_solve={launched[1]}", flush=True)
        for algo, g, c in per_algo:
            print(f"phase templates: similarproduct {algo} launches "
                  f"fused_gram={g} chol_solve={c}", flush=True)
            check(g > 0 and c > 0, f"{algo} trained without the kernels")
        train_launches = {"fused_gram": fg.LAUNCHES,
                          "chol_solve": sv.LAUNCHES}
        t = time.perf_counter()
        mesh_launches = templates_over_mesh(trained, storage, als_walls,
                                            current, dev, card or {})
        mesh_s = time.perf_counter() - t
        fg.LAUNCHES = sv.LAUNCHES = ft.LAUNCHES = gram.LAUNCHES = 0

        (ecm,) = trained["ecommerce"][2]
        sp_models = trained["similarproduct"][2]
        for m in [ecm] + [m for m in sp_models if not isinstance(m, tuple)]:
            check(bool(np.isfinite(m.item_factors).all()),
                  "a template model has non-finite item factors")
        user_ids = BiMap.string_int(
            storage.events().aggregate_properties(
                app_id, entity_type="user"))
        t = time.perf_counter()
        idx, counts = cooc_plain(storage, app_id, sp_models[1], user_ids)
        cooc = sp_models[1][0]
        check(np.array_equal(idx, cooc.indices)
              and np.array_equal(counts, cooc.counts),
              f"co-occurrence: {int((idx != cooc.indices).sum())} indices "
              f"and {int((counts != cooc.counts).sum())} counts off the "
              f"numpy count")
        print(f"phase templates: co-occurrence {cooc.n_items} items x top "
              f"{cooc.indices.shape[1]} equal to the numpy count bit for "
              f"bit ({int((cooc.indices >= 0).sum())} neighbours, checked "
              f"in {time.perf_counter() - t:.2f}s)", flush=True)

        # views of users unknown to the model, posted after training
        rng = np.random.default_rng(seed + 10)
        t_ms = t_end + 1000
        fresh = []
        for k in range(8):
            for x in rng.choice(top, 5, replace=False).tolist():
                fresh.append(Event(
                    event="view", entity_type="user", entity_id=f"nu{k}",
                    target_entity_type="item", target_entity_id=f"i{x}",
                    event_time=from_millis(t_ms)))
                t_ms += 1
        storage.events().insert_batch(fresh, app_id)

        ec_params = trained["ecommerce"][1]["algorithms"][0]["params"]
        known = [x for x, j in ecm.user_ids.items() if ecm.has_user[j]]
        picks = rng.choice(known, 18, replace=False).tolist()
        ec_queries = [{"user": x, "num": 10} for x in picks[:12]]
        ec_queries += [{"user": x, "num": 10, "categories": [
            f"c{k}" for k in rng.choice(TEMPLATES_CATEGORIES, 2,
                                        replace=False).tolist()]}
            for x in picks[12:15]]
        ec_queries += [{"user": x, "num": 10, "whiteList": [
            f"i{y}" for y in rng.choice(top, len(top) // 20,
                                        replace=False).tolist()]}
            for x in picks[15:]]
        ec_queries += [{"user": f"nu{k}", "num": 10} for k in range(8)]
        ec_queries += [{"user": f"stranger{k}", "num": 10} for k in range(6)]
        ec_queries[1]["blackList"] = [f"i{y}" for y in top[:5].tolist()]
        sp_queries = []
        for k in range(32):
            q = {"items": [f"i{y}" for y in rng.choice(
                top, 1 + k % 3, replace=False).tolist()], "num": 10}
            if k % 4 == 1:
                q["categories"] = [f"c{k % TEMPLATES_CATEGORIES}"]
            if k % 3 == 2:
                q["blackList"] = [f"i{y}" for y in rng.choice(
                    top, 5, replace=False).tolist()]
            if k == 5:
                q["num"] = 1
            sp_queries.append(q)

        http, answered = {}, {}
        for name, queries in (("ecommerce", ec_queries),
                              ("similarproduct", sp_queries)):
            args = cli._parser().parse_args([
                "deploy", "--engine-json", str(trained[name][0]), "--ip",
                "127.0.0.1", "--port", "0"])
            srv = cli.build_deploy(args, storage).start_background()
            try:
                answered[name] = [_post(srv.port, q) for q in queries]
            finally:
                srv.close()
            http[name] = np.array([s for _, s in answered[name]]) * 1e3
        read_ms = np.array(reads["s"]) * 1e3
        # seen items, unavailableItems and weightedItems for every query
        check(len(read_ms) >= 3 * len(ec_queries),
              f"{len(read_ms)} point reads for {len(ec_queries)} e-commerce "
              f"queries")
        print(f"phase templates: {len(read_ms)} serving-time point reads ms "
              f"p50/p99 {np.percentile(read_ms, 50):.3f}/"
              f"{np.percentile(read_ms, 99):.3f} max {read_ms.max():.3f}, "
              f"{len(reads['errors'])} raised", flush=True)
        check(not reads["errors"],
              f"{len(reads['errors'])} serving-time reads raised: "
              f"{reads['errors'][:3]}")
        tied = {}
        for name, queries in (("ecommerce", ec_queries),
                              ("similarproduct", sp_queries)):
            tied[name] = 0
            for q, (a, _) in zip(queries, answered[name]):
                got = [(x["item"], x["score"]) for x in a["itemScores"]]
                tag = f"{name} {q}"
                if name == "ecommerce":
                    ref, score_of = ecomm_plain(
                        ecm, q, store_reads(storage, app_id, q["user"],
                                            ec_params), ec_params)
                    check(bool(got) or not ref, f"{tag}: empty answer")
                    tied[name] += held_to(got, ref, score_of, tag)
                    continue
                ref, score_of, atol, cut_tied = sp_plain(sp_models, q)
                if cut_tied and [x for x, _ in got] != [x for x, _ in ref]:
                    tied[name] += 1  # an ALS list's members differ at a tie
                    continue
                tied[name] += held_to(got, ref, score_of, tag, atol)
        check(ft.LAUNCHES == 0 and gram.LAUNCHES == 0,
              f"the templates launched fused_topk {ft.LAUNCHES} and "
              f"gram_table {gram.LAUNCHES} times")
        print(f"phase templates: {len(lines)} events ({len(np.unique(u))} "
              f"users x {len(np.unique(i))} items, 1 user in "
              f"{TEMPLATES_USER_STRIDE}, the {TEMPLATES_ITEMS} most-rated "
              f"items) built in {build_s:.2f}s, cli import {import_s:.3f}s "
              f"= {len(lines) / import_s:.1f} events/s | HTTP ms p50/p99: "
              f"ecommerce {np.percentile(http['ecommerce'], 50):.3f}/"
              f"{np.percentile(http['ecommerce'], 99):.3f} similarproduct "
              f"{np.percentile(http['similarproduct'], 50):.3f}/"
              f"{np.percentile(http['similarproduct'], 99):.3f} | "
              f"{len(read_ms)} point reads ms p50/p99 "
              f"{np.percentile(read_ms, 50):.3f}/"
              f"{np.percentile(read_ms, 99):.3f} max {read_ms.max():.3f}, "
              f"errors {len(reads['errors'])} | {len(ec_queries)} + "
              f"{len(sp_queries)} answers held to the float64 "
              f"recomputation, {tied['ecommerce']} + "
              f"{tied['similarproduct']} reordered inside a near-tie | "
              f"launches fused_gram={train_launches['fused_gram']} "
              f"chol_solve={train_launches['chol_solve']} fused_topk="
              f"{ft.LAUNCHES} (these templates score on the host) "
              f"gram_table={gram.LAUNCHES} | over a mesh {mesh_s:.2f}s",
              flush=True)
        return {"fused_gram": train_launches["fused_gram"],
                "chol_solve": train_launches["chol_solve"],
                "fused_topk": ft.LAUNCHES, "gram_table": gram.LAUNCHES,
                "mesh": mesh_launches}
    finally:
        pstore.EventStoreFacade.find_by_entity = plain_find
        psp.SPALSAlgorithm.train = plain_sp_train
        _common.train_als = plain_train_als
        for cls, read in plain_reads.items():
            cls.read_training = read
        storage.close()


# -- the sequential and classification templates ------------------------------

#: the shipped sequential variant's epochs cut to 2 (20 shipped)
SEQ_EPOCHS = 2
#: one card step against the float64 CPU step: |d loss| <= SEQ_STEP_RTOL
#: * (1 + |loss|); each gradient's ||g - g64|| <= SEQ_GRAD_RTOL * ||g64||
#: (a gradient is a sum of B * (L - 1) = 12,544 per-position terms that
#: largely cancel on the surrogate's windows of popular items: the host's
#: own f32 step sits 2e-4 to 5e-4 off float64 there, normwise, and the
#: card is held to 10x that); after the Adam update each weight within
#: 1e-6 of the float64 update, or within 2 * lr where |g64| <
#: SEQ_GRAD_FLOOR (there Adam's m / sqrt(v) is about +-1 whatever the
#: gradient's size, so the f32 gradient's rounding may flip it)
SEQ_STEP_RTOL = 1e-5
SEQ_GRAD_RTOL = 5e-3
SEQ_GRAD_FLOOR = 1e-5
#: a served score against its float64 recomputation (two f32 attention
#: blocks and three layer norms deep): |d| <= SEQ_RTOL * (1 + |s64|), and
#: how close two float64 scores must be for either order to pass
SEQ_RTOL = 1e-4
SEQ_APP = "SeqApp"
SEQ_USER_STRIDE = 200
CLS_USERS = 100_000
#: class-dependent Poisson means of attr0..attr2 for plan 0 and plan 1
CLS_MEANS = ((6.0, 2.0, 1.0), (1.0, 2.0, 6.0))
#: a naive-Bayes label served from the card's f32 scores may differ from
#: the host float64 ``predict`` only where the two classes' float64
#: scores lie within this of each other
CLS_TIE_ATOL = 1e-4


def launch_counts() -> dict:
    from predictionio_tpu_torch.ops import fused_gram as fg
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.ops import gram
    from predictionio_tpu_torch.ops import solve as sv

    return {"fused_topk": ft.LAUNCHES, "fused_gram": fg.LAUNCHES,
            "chol_solve": sv.LAUNCHES, "gram_table": gram.LAUNCHES}


def zero_launch_counts() -> None:
    from predictionio_tpu_torch.ops import fused_gram as fg
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.ops import gram
    from predictionio_tpu_torch.ops import solve as sv

    fg.LAUNCHES = sv.LAUNCHES = ft.LAUNCHES = gram.LAUNCHES = 0


def card_tag(card: dict) -> str:
    return f"card={card['name']} power_limit={card['power_limit']}"


def seq_f64_scores(model, histories) -> torch.Tensor:
    """[B, I] float64 scores of ``histories`` recomputed on the host from
    the model's weights."""
    from predictionio_tpu_torch.models import seqrec

    w64 = {k: v.detach().double().cpu() for k, v in model.weights.items()}
    seq = torch.from_numpy(seqrec.window(histories, model.params.max_len))
    ctx = seqrec._encode(w64, seq, model.params)[:, -1]
    return ctx @ w64["item_emb"][:-1].T


def seq_held(tag: str, answer: list, scores64, known=()) -> bool:
    """A served (item index, score) list against the float64 top of
    ``scores64`` (one row, ``known`` indices out): the templates'
    ``held_to`` with the sequential tolerance."""
    s = scores64.numpy().copy()
    s[list(known)] = -np.inf
    order = np.argsort(-s, kind="stable")[:len(answer)]
    ref = [(int(j), float(s[j])) for j in order]
    score_of = lambda j: float(s[j]) if np.isfinite(s[j]) else None
    return held_to(answer, ref, score_of, tag,
                   atol=SEQ_RTOL * (1 + float(np.abs(s[order]).max())))


def seq_step_check(model, seqs, seed: int, dev) -> dict:
    """One step of the trained model on the card against the float64
    step on the host: the same weights, batch and negatives."""
    from predictionio_tpu_torch.models import seqrec

    p = model.params
    rows = np.random.default_rng(seed + 31).choice(len(seqs), p.batch_size,
                                                   replace=False)
    xb = torch.from_numpy(seqs[rows].astype(np.int64))
    negs = torch.randint(0, model.n_items, (p.batch_size, p.max_len - 1,
                                            p.n_negatives),
                         generator=torch.Generator().manual_seed(seed))
    w = {k: v.detach().clone() for k, v in model.weights.items()}
    w64 = {k: v.double().cpu() for k, v in w.items()}
    loss, grads = seqrec.loss_and_grads(w, xb.to(dev), negs.to(dev), p)
    t = time.perf_counter()
    loss64, grads64 = seqrec.loss_and_grads(w64, xb, negs, p)
    host_s = time.perf_counter() - t
    check(abs(float(loss) - float(loss64))
          <= SEQ_STEP_RTOL * (1 + abs(float(loss64))),
          f"sequential: card loss {float(loss)} vs float64 {float(loss64)}")
    worst_g = 0.0
    for k, g in grads.items():
        g64 = grads64[k]
        rel = float((g.double().cpu() - g64).norm()
                    / g64.norm().clamp_min(1e-30))
        worst_g = max(worst_g, rel)
        check(rel <= SEQ_GRAD_RTOL, f"sequential: gradient {k} off the "
              f"float64 step by {rel:.3e} (normwise)")
    zeros = lambda ws: {k: torch.zeros_like(v) for k, v in ws.items()}
    seqrec.adam_update(w, zeros(w), zeros(w), grads, 1, p.learning_rate)
    seqrec.adam_update(w64, zeros(w64), zeros(w64), grads64, 1,
                       p.learning_rate)
    worst_w, flips = 0.0, 0
    for k, x in w.items():
        err = (x.double().cpu() - w64[k]).abs()
        small = grads64[k].abs() < SEQ_GRAD_FLOOR
        tol = 1e-6 + 2 * p.learning_rate * small.double()
        check(bool((err <= tol).all()), f"sequential: weight {k} off the "
              f"float64 Adam step by {err.max().item():.3e}")
        worst_w = max(worst_w, float(err[~small].max()) if (~small).any()
                      else 0.0)
        flips += int((err[small] > 1e-6).sum())
    return {"loss": float(loss), "loss64": float(loss64), "grad_rel": worst_g,
            "w_err": worst_w, "flips": flips, "host_s": host_s}


def phase_sequential(data, times, dev, card: dict) -> dict:
    """The shipped sequential variant at ML-20M width on the card: every
    user's 50 latest ratings as a window, ``train_seqrec`` for 2 epochs,
    one step held against the float64 host step, one step profiled,
    ``recommend_next_batch`` timed at B = 1 and 256 and every served list
    held against its float64 recomputation."""
    from predictionio_tpu_torch.models import seqrec

    users, items, _, n_users, n_items = data
    root = Path(__file__).resolve().parent
    variant = json.loads((root / "examples" / "sequential" /
                          "engine.json").read_text())
    params = seqrec.SeqRecParams(**{**variant["algorithms"][0]["params"],
                                    "num_epochs": SEQ_EPOCHS})
    t = time.perf_counter()
    seqs = seqrec.sequences_from_ratings(users, items, times, n_users,
                                         params.max_len)
    seq_s = time.perf_counter() - t
    seqs = seqs[(seqs >= 0).sum(axis=1) >= 2]
    steps = SEQ_EPOCHS * max(len(seqs) // params.batch_size, 1)
    # -- the main path, counted --------------------------------------------
    zero_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    model, losses = seqrec.train_seqrec(seqs, n_items, params, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    launches = launch_counts()
    # ----------------------------------------------------------------------
    check(all(bool(torch.isfinite(v).all()) for v in model.weights.values()),
          "sequential: a trained weight is not finite")
    check(losses[-1] < losses[0], f"sequential: epoch losses {losses} do "
          f"not fall")
    check(not any(launches.values()),
          f"sequential: the attention path launched a kernel: {launches}")
    step = seq_step_check(model, seqs, 11, dev)

    # one step profiled: forward, backward and Adam by CUDA events
    w = {k: v.detach().clone() for k, v in model.weights.items()}
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v_ = {k: torch.zeros_like(v) for k, v in w.items()}
    xb = torch.from_numpy(seqs[:params.batch_size].astype(np.int64)).to(dev)
    negs = torch.randint(0, n_items, (params.batch_size, params.max_len - 1,
                                      params.n_negatives), device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    def one_step():
        ev[0].record()
        leaves = {k: x.detach().requires_grad_(True) for k, x in w.items()}
        loss = seqrec.sampled_softmax_loss(leaves, xb, negs, params)
        ev[1].record()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        ev[2].record()
        seqrec.adam_update(w, m, v_, dict(zip(leaves, grads)), 1,
                           params.learning_rate)
        ev[3].record()

    one_step()  # warm
    _, bd = profile_device("phase sequential profile, one train step",
                           one_step)
    split = [ev[n].elapsed_time(ev[n + 1]) for n in range(3)]

    # serving
    rng = np.random.default_rng(13)
    hist = [r[r >= 0].tolist() for r in seqs[rng.choice(len(seqs), 256,
                                                        replace=False)]]
    lat = {}
    for B, reps in ((1, 200), (256, 40)):
        seqrec.recommend_next_batch(model, hist[:B], 10)
        times_ms = []
        for _ in range(reps):
            t = time.perf_counter()
            seqrec.recommend_next_batch(model, hist[:B], 10)
            times_ms.append((time.perf_counter() - t) * 1e3)
        lat[B] = (np.percentile(times_ms, 50), np.percentile(times_ms, 99))
    ids, scores = seqrec.recommend_next_batch(model, hist, 10)
    s64 = seq_f64_scores(model, hist)
    tied = sum(seq_held(f"sequential row {b}",
                        list(zip(ids[b].tolist(), scores[b].tolist())),
                        s64[b]) for b in range(len(hist)))
    i1, sc1 = seqrec.recommend_next(model, hist[0], 10)
    tied += seq_held("sequential B = 1", list(zip(i1.tolist(),
                                                  sc1.tolist())), s64[0])
    print(f"phase sequential: {len(seqs)} windows of {params.max_len} over "
          f"{n_items} items (sequences_from_ratings {seq_s:.3f}s, host) | "
          f"dim {params.dim} heads {params.heads} blocks "
          f"{params.num_blocks} batch {params.batch_size} negatives "
          f"{params.n_negatives}, {SEQ_EPOCHS} epochs = {steps} steps in "
          f"{train_s:.3f}s = {steps / train_s:.1f} steps/s "
          f"{steps * params.batch_size / train_s:.1f} sequences/s | epoch "
          f"losses {[round(x, 6) for x in losses]} | one card step vs the "
          f"float64 host step ({step['host_s']:.2f}s): loss "
          f"{step['loss']:.6f}/{step['loss64']:.6f}, gradients within "
          f"{step['grad_rel']:.3e} normwise, Adam within {step['w_err']:.3e} "
          f"({step['flips']} sign flips below |g| {SEQ_GRAD_FLOOR}) | "
          f"profiled step ms: wall {bd['wall_ms']:.3f} device "
          f"{bd['device_ms']:.3f} idle_share "
          f"{1 - bd['device_ms'] / bd['wall_ms']:.5f}; event spans forward "
          f"{split[0]:.3f} backward {split[1]:.3f} adam {split[2]:.3f} | "
          f"recommend_next_batch ms p50/p99: B=1 {lat[1][0]:.3f}/"
          f"{lat[1][1]:.3f} B=256 {lat[256][0]:.3f}/{lat[256][1]:.3f}; "
          f"{len(hist) + 1} lists held to float64 ({tied} reordered inside "
          f"a near-tie) | launches {launches} | {card_tag(card)}", flush=True)
    seq_over_mesh(seqs, n_items, params, dev, card)
    return launches


#: data-parallel seqrec: positions on the one card, steps (one epoch of
#: SEQ_MESH_STEPS batches), the losses' tolerance against the one card,
#: and the weights' after SEQ_MESH_STEPS steps: those whose one-card
#: gradient stayed at least SEQ_GRAD_FLOOR at every step within
#: SEQ_MESH_SURE_ATOL, and at least SEQ_MESH_NEAR_SHARE of all within
#: 1e-4 (measured on an H100: 1.236e-04 and 0.99966)
SEQ_MESH_POSITIONS = 4
SEQ_MESH_STEPS = 64
SEQ_MESH_RTOL = 1e-4
SEQ_MESH_SURE_ATOL = 5e-4
SEQ_MESH_NEAR_SHARE = 0.995


def seq_over_mesh(seqs, n_items, params, dev, card: dict) -> None:
    """``train_seqrec`` over SEQ_MESH_POSITIONS positions on the one card
    against the one card: SEQ_MESH_STEPS steps on the same windows, from
    the same initial weights and negatives (both runs' defaults: the
    params' seed, a generator on the card).

    - The first step, from the same weights, batch and negatives, under
      ``tests/test_torch_sequential.py``'s sign rule: every weight within
      1e-5 of the one card's where the one card's gradient is at least
      SEQ_GRAD_FLOOR, elsewhere within 2 * lr (Adam's m / sqrt(v) is about
      +-1 where a gradient is tiny, so one rounding can flip the step).
    - After SEQ_MESH_STEPS steps: the epoch's loss within SEQ_MESH_RTOL;
      the sign rule over all the steps (the weights whose one-card
      gradient stayed at least the floor at every step) within
      SEQ_MESH_SURE_ATOL, and at least SEQ_MESH_NEAR_SHARE of every
      weight within 1e-4. Rounding apart, two runs drift as the steps go
      on, so these limits sit a few times past the drift measured on the
      card; a wrong gradient scale or divisor moves the weights by about
      lr a step, far past them.

    The one card's gradients come from a replay of its steps
    (``loss_and_grads`` and ``adam_update``, what ``train_step`` runs),
    held bitwise to its ``train_seqrec``."""
    from predictionio_tpu_torch.models import seqrec

    p = dataclasses.replace(params, num_epochs=1)
    rows = seqs[:SEQ_MESH_STEPS * p.batch_size]
    mesh = forced_mesh(SEQ_MESH_POSITIONS, dev)
    runs = {}
    for tag, kw in (("one card", {"device": dev}), ("mesh", {"mesh": mesh})):
        zero_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        model, losses = seqrec.train_seqrec(rows, n_items, p, **kw)
        torch.cuda.synchronize()
        runs[tag] = (model, losses, time.perf_counter() - t,
                     launch_counts())
    (m1, l1, s1, c1), (mm, lm, sm, cm) = runs["one card"], runs["mesh"]

    def fresh():
        w = {k: v.to(dev) for k, v in seqrec._init_weights(n_items,
                                                            p).items()}
        return (w, {k: torch.zeros_like(v) for k, v in w.items()},
                {k: torch.zeros_like(v) for k, v in w.items()})

    # the one card's steps again, keeping where each gradient stayed large
    w, opt_m, opt_v = fresh()
    sure = {k: torch.ones_like(v, dtype=torch.bool) for k, v in w.items()}
    sample = seqrec.default_negatives(n_items, p.seed, dev)
    order = torch.from_numpy(np.random.default_rng(p.seed).permutation(
        len(rows))).to(dev)
    xs = torch.from_numpy(rows.astype(np.int64)).to(dev)
    shape = (p.batch_size, rows.shape[1] - 1, p.n_negatives)
    for step in range(SEQ_MESH_STEPS):
        xb = xs[order[step * p.batch_size:(step + 1) * p.batch_size]]
        negs = sample(step, shape)
        _, grads = seqrec.loss_and_grads(w, xb, negs, p)
        for k, g in grads.items():
            sure[k] &= g.abs() >= SEQ_GRAD_FLOOR
        seqrec.adam_update(w, opt_m, opt_v, grads, step + 1,
                           p.learning_rate)
        if step == 0:
            first = ({k: x.clone() for k, x in w.items()},
                     {k: g.abs() >= SEQ_GRAD_FLOOR for k, g in grads.items()},
                     xb, negs)
    check(all(torch.equal(w[k], m1.weights[k]) for k in w),
          "sequential over a mesh: the replayed steps are not the one "
          "card's train_seqrec")
    # the first step over the mesh, from the same weights and inputs
    w1, big1, xb, negs = first
    wm, mm1, vm1 = fresh()
    seqrec._MeshStep(wm, mm1, vm1, mesh).step(0, xb, negs, p)
    step1, step1_sure = 0.0, 0.0
    for name, x in w1.items():
        err = (wm[name] - x).abs()
        e_big = float(err[big1[name]].max()) if big1[name].any() else 0.0
        step1, step1_sure = max(step1, float(err.max())), max(step1_sure,
                                                               e_big)
        check(e_big <= 1e-5 and float(err.max()) <= 2 * p.learning_rate,
              f"sequential over a mesh, first step: weight {name} off the "
              f"one card's by {e_big:.3e} where |g| >= {SEQ_GRAD_FLOOR} "
              f"(limit 1e-5), {float(err.max()):.3e} in all (limit "
              f"{2 * p.learning_rate})")
    check(all(bool(torch.isfinite(x).all()) for x in mm.weights.values()),
          "sequential over a mesh: a trained weight is not finite")
    check(bool(np.allclose(lm, l1, rtol=SEQ_MESH_RTOL, atol=0.0)),
          f"sequential over a mesh: losses {lm} against the one card's "
          f"{l1} (rtol {SEQ_MESH_RTOL})")
    worst_sure, worst, n_sure, n_all, n_near = 0.0, 0.0, 0, 0, 0
    for name, x in m1.weights.items():
        err = (mm.weights[name] - x).abs()
        if sure[name].any():
            worst_sure = max(worst_sure, float(err[sure[name]].max()))
        worst = max(worst, float(err.max()))
        n_sure += int(sure[name].sum())
        n_near += int((err <= 1e-4).sum())
        n_all += err.numel()
    check(n_sure > 0 and worst_sure <= SEQ_MESH_SURE_ATOL,
          f"sequential over a mesh, after {SEQ_MESH_STEPS} steps: the "
          f"{n_sure} weights whose gradient stayed >= {SEQ_GRAD_FLOOR} "
          f"are off the one card's by {worst_sure:.3e} (limit "
          f"{SEQ_MESH_SURE_ATOL})")
    check(n_near >= SEQ_MESH_NEAR_SHARE * n_all,
          f"sequential over a mesh, after {SEQ_MESH_STEPS} steps: "
          f"{n_near / n_all:.5f} of the weights within 1e-4 of the one "
          f"card's (limit {SEQ_MESH_NEAR_SHARE})")
    check(not any(c1.values()) and not any(cm.values()),
          f"sequential over a mesh: a kernel launched: {c1} {cm}")
    print(f"phase sequential mesh: train_seqrec over "
          f"{SEQ_MESH_POSITIONS} positions on one card, {SEQ_MESH_STEPS} "
          f"steps of batch {p.batch_size} ({len(rows)} windows): one card "
          f"{s1:.3f}s = {SEQ_MESH_STEPS / s1:.1f} steps/s, mesh {sm:.3f}s = "
          f"{SEQ_MESH_STEPS / sm:.1f} steps/s | first step: within "
          f"{step1_sure:.3e} where |g| >= {SEQ_GRAD_FLOOR} (limit 1e-5), "
          f"{step1:.3e} in all (limit {2 * p.learning_rate}) | after "
          f"{SEQ_MESH_STEPS} steps: epoch loss one card {l1[0]:.7f} mesh "
          f"{lm[0]:.7f} (rtol {SEQ_MESH_RTOL}); {n_near / n_all:.5f} of "
          f"{n_all} weights within 1e-4 (limit {SEQ_MESH_NEAR_SHARE}), the "
          f"{n_sure} whose gradient stayed >= {SEQ_GRAD_FLOOR} at every "
          f"step within {worst_sure:.3e} (limit {SEQ_MESH_SURE_ATOL}), all "
          f"within {worst:.3e} | "
          f"launches {cm} | {card_tag(card)}", flush=True)


#: the ring: positions on the one card, the batch and sequence, the
#: left padding of each row's keys, and the tolerances against the
#: one-card path
RING_POSITIONS = 4
RING_B, RING_S = 4, 16384
RING_PADS = (0, 1000, 5000, 12000)
RING_RTOL, RING_ATOL = 1e-5, 1e-6
RING_BF16_STEP = 2.0 ** -7


def phase_ring(seed: int, dev, card: dict) -> dict:
    """``ring_attention`` over RING_POSITIONS positions on the one card
    against its ``mesh=None`` path on the card, at the shipped sequential
    variant's heads and head width, causal, with left-padded keys: f32
    and bf16, each path's ms (median of 3) and peak memory."""
    from predictionio_tpu_torch.ops.ring_attention import ring_attention

    root = Path(__file__).resolve().parent
    variant = json.loads((root / "examples" / "sequential" /
                          "engine.json").read_text())
    ap = variant["algorithms"][0]["params"]
    H, D = ap["heads"], ap["dim"] // ap["heads"]
    g = torch.Generator(device=dev).manual_seed(seed + 71)
    q, k, v = (torch.randn((RING_B, RING_S, H, D), generator=g, device=dev)
               for _ in range(3))
    pos = torch.arange(RING_S, device=dev)[None, :]
    kv = pos >= torch.tensor(RING_PADS, device=dev)[:, None]
    dead = ~kv  # causal + left padding: these query rows see no key
    mesh = forced_mesh(RING_POSITIONS, dev)
    out = {}
    for wire, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        qq, kk, vv = (x.to(dt) for x in (q, k, v))
        res = {}
        for tag, m in (("one card", None), ("ring", mesh)):
            def run(m=m):
                return ring_attention(qq, kk, vv, mesh=m, causal=True,
                                      key_valid=kv)

            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            got = run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev)
            res[tag] = (got.float(), median_ms(run, 3), peak)
            del got
        want, got = res["one card"][0], res["ring"][0]
        check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
              f"ring {wire}: a non-finite output")
        d = (got - want).abs()
        if wire == "f32":
            bad = d > RING_ATOL + RING_RTOL * want.abs()
            tol = f"rtol {RING_RTOL}, atol {RING_ATOL}"
        else:
            bad = d > RING_BF16_STEP * (1 + want.abs())
            tol = f"one bf16 step, {RING_BF16_STEP} (1 + |x|)"
        check(not bool(bad.any()),
              f"ring {wire}: {int(bad.sum())} outputs off the one card's "
              f"({tol}; max |d| {float(d.max()):.3e})")
        check(bool((got[dead] == 0).all() and (want[dead] == 0).all()),
              f"ring {wire}: a row that sees no key is not 0")
        out[wire] = {"max_abs": float(d.max()), "tol": tol,
                     "ms": {t: r[1] for t, r in res.items()},
                     "peak": {t: r[2] for t, r in res.items()}}
        del res, want, got, d, bad, qq, kk, vv
    torch.cuda.empty_cache()
    parts = []
    for wire, o in out.items():
        parts.append(
            f"{wire}: max |d| {o['max_abs']:.3e} ({o['tol']}); ms one card "
            f"{o['ms']['one card']:.3f} ring {o['ms']['ring']:.3f}; "
            f"max_memory_allocated one card {o['peak']['one card']} ring "
            f"{o['peak']['ring']} bytes")
    print(f"phase ring: ring_attention over {RING_POSITIONS} positions on "
          f"one card against mesh=None, B {RING_B} S {RING_S} heads {H} "
          f"head width {D}, causal, key padding {list(RING_PADS)} "
          f"({int(dead.sum())} query rows see no key: 0 on both) | "
          + " | ".join(parts) + f" | {card_tag(card)}", flush=True)
    return out


def seq_event_lines(data, times, t_shift_ms: int = 0) -> tuple:
    """Every ``SEQ_USER_STRIDE``-th surrogate user's ratings as timed
    ``view`` events (its k-th rating k ms after its surrogate second, so
    no two of a user's events share a time)."""
    from predictionio_tpu_torch.data.event import from_millis, isoformat_millis

    users, items = data[0], data[1]
    keep = np.flatnonzero(users % SEQ_USER_STRIDE == 0)
    u, i, ts = users[keep], items[keep], times[keep]
    order = np.lexsort((ts, u))
    u, i, ts = u[order], i[order], ts[order]
    first = np.r_[0, np.flatnonzero(np.diff(u)) + 1]
    rank = np.arange(len(u)) - np.repeat(first, np.diff(np.r_[first,
                                                              len(u)]))
    ms = ts * 1000 + rank + t_shift_ms
    lines = [json.dumps({"event": "view", "entityType": "user",
                         "entityId": f"u{a}", "targetEntityType": "item",
                         "targetEntityId": f"i{b}",
                         "eventTime": isoformat_millis(from_millis(int(c)))})
             for a, b, c in zip(u.tolist(), i.tolist(), ms.tolist())]
    return lines, u, i


def phase_sequential_pio(data, times, dev, home: str, card: dict) -> dict:
    """The shipped sequential variant through the CLI on SQLite: ``cli
    import``, ``cli train``, ``cli deploy``, 32 user and 32 item queries
    over HTTP (the users' histories read at serving time, timed), each
    answer held to its float64 recomputation; then ``cli eval`` of the
    port's shipped sequential evaluation."""
    from predictionio_tpu_torch import cli
    from predictionio_tpu_torch.data import store as pstore
    from predictionio_tpu_torch.data.storage.base import (
        STATUS_COMPLETED, STATUS_EVALCOMPLETED)
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.workflow.persistence import loads_models

    root = Path(__file__).resolve().parent
    t = time.perf_counter()
    lines, u, i = seq_event_lines(data, times)
    events_path = Path(home) / "sequential_events.jsonl"
    events_path.write_text("\n".join(lines) + "\n")
    build_s = time.perf_counter() - t
    storage = Storage(env={"PIO_HOME": home})
    reads = {"s": [], "errors": []}
    plain_find = pstore.EventStoreFacade.find_by_entity

    def timed_find(self, *args, **kwargs):
        t = time.perf_counter()
        try:
            return plain_find(self, *args, **kwargs)
        except Exception as e:  # counted, then the template's handling
            reads["errors"].append(repr(e))
            raise
        finally:
            reads["s"].append(time.perf_counter() - t)

    eval_mod = "predictionio_tpu_torch.examples.sequential_evaluation"
    env_app = os.environ.get("PTPU_EVAL_APP")
    try:
        check(cli.main(["app", "new", SEQ_APP], storage=storage) == 0,
              "app new failed")
        app_id = storage.apps().get_by_name(SEQ_APP).id
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["import", "--app", SEQ_APP, "--input",
                           str(events_path)], storage=storage)
        import_s = time.perf_counter() - t
        check(rc == 0 and f"Imported {len(lines)} event(s)." in
              out.getvalue(), f"cli import: {rc} {out.getvalue()}")
        variant = json.loads((root / "examples" / "sequential" /
                              "engine.json").read_text())
        variant["datasource"]["params"]["app_name"] = SEQ_APP
        path = Path(home) / "sequential.json"
        path.write_text(json.dumps(variant))
        # -- the main path, counted ----------------------------------------
        zero_launch_counts()
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["train", "--engine-json", str(path)],
                          storage=storage)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        check(rc == 0, f"cli train sequential: {rc} {out.getvalue()}")
        stages = json.loads(next(
            ln for ln in out.getvalue().splitlines()
            if ln.startswith("Train stages: "))[len("Train stages: "):])
        (inst,) = [x for x in storage.engine_instances().get_all()
                   if x.engine_id == variant["id"]]
        check(inst.status == STATUS_COMPLETED,
              f"sequential: instance {inst.id} is {inst.status}")
        (model,) = loads_models(storage.models().get(inst.id).models)
        check(all(bool(torch.isfinite(v).all())
                  for v in model.weights.values()),
              "sequential: a persisted weight is not finite")
        params = model.params
        check(params.num_epochs == 20 and params.dim == 64
              and params.num_blocks == 2, f"sequential: params {params}")

        rng = np.random.default_rng(17)
        app_users = np.unique(u)
        picks = rng.choice(app_users, 64, replace=False)
        user_q = [{"user": f"u{x}", "num": 10} for x in picks[:32].tolist()]
        item_q = []
        for x in picks[32:].tolist():
            mine = i[u == x]
            n = int(rng.integers(3, 11))
            item_q.append({"items": [f"i{y}" for y in mine[-n:].tolist()],
                           "num": 10})
        pstore.EventStoreFacade.find_by_entity = timed_find
        args = cli._parser().parse_args([
            "deploy", "--engine-json", str(path), "--ip", "127.0.0.1",
            "--port", "0"])
        srv = cli.build_deploy(args, storage).start_background()
        try:
            answered = [_post(srv.port, q) for q in user_q + item_q]
        finally:
            srv.close()
            pstore.EventStoreFacade.find_by_entity = plain_find
        launches = launch_counts()
        # ------------------------------------------------------------------
        check(not any(launches.values()),
              f"sequential-pio launched a kernel: {launches}")
        facade = pstore.EventStoreFacade(storage)
        ids = model.item_ids
        late, tied, hists = 0, 0, []
        for q in user_q + item_q:
            if "user" in q:
                evs = facade.find_by_entity(
                    SEQ_APP, "user", q["user"], target_entity_type="item",
                    event_names=list(model.events),
                    limit=params.max_len, latest=True)
                hists.append([ids[e.target_entity_id] for e in reversed(evs)
                              if e.target_entity_id in ids])
            else:
                hists.append([ids[x] for x in q["items"] if x in ids])
        s64 = seq_f64_scores(model, hists)
        for n, (q, (a, _)) in enumerate(zip(user_q + item_q, answered)):
            got = [(ids[x["item"]], x["score"]) for x in a["itemScores"]]
            if not got and hists[n]:
                late += 1  # a read past its deadline: an empty 200
                continue
            tied += seq_held(f"sequential-pio {q}", got, s64[n],
                             known=set(hists[n]))
        http = np.array([s for _, s in answered]) * 1e3
        read_ms = np.array(reads["s"]) * 1e3
        check(len(read_ms) == len(user_q),
              f"{len(read_ms)} history reads for {len(user_q)} user queries")
        check(not reads["errors"] and late == 0,
              f"sequential-pio: {len(reads['errors'])} history reads raised "
              f"{reads['errors'][:3]}, {late} answers empty")

        # cli eval of the port's shipped sequential evaluation
        os.environ["PTPU_EVAL_APP"] = SEQ_APP
        sys.modules.pop(eval_mod, None)
        before = {x.id for x in storage.evaluation_instances().get_all()}
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["eval", f"{eval_mod}:evaluation",
                           f"{eval_mod}:engine_params_generator"],
                          storage=storage)
        eval_s = time.perf_counter() - t
        check(rc == 0, f"cli eval sequential: {rc} {out.getvalue()}")
        (ev_inst,) = [x for x in storage.evaluation_instances().get_all()
                      if x.id not in before]
        check(ev_inst.status == STATUS_EVALCOMPLETED,
              f"sequential eval: instance {ev_inst.id} is {ev_inst.status}")
        result = json.loads(ev_inst.evaluator_results_json)
        scores = [x["score"] for x in result["metricScoresList"]]
        check(len(scores) == 4 and all(0.0 <= x <= 1.0 for x in scores)
              and result["bestIndex"] == int(np.argmax(scores)),
              f"sequential eval: scores {scores}, best "
              f"{result['bestIndex']}")
        print(f"phase sequential-pio: {len(lines)} view events (1 user in "
              f"{SEQ_USER_STRIDE}: {len(app_users)} users, "
              f"{len(np.unique(i))} items) built in {build_s:.2f}s, cli "
              f"import {import_s:.3f}s = {len(lines) / import_s:.1f} "
              f"events/s | cli train (dim 64, 2 blocks, 20 epochs as "
              f"shipped) {train_s:.3f}s stages {stages} | HTTP ms p50/p99: "
              f"user {np.percentile(http[:32], 50):.3f}/"
              f"{np.percentile(http[:32], 99):.3f} items "
              f"{np.percentile(http[32:], 50):.3f}/"
              f"{np.percentile(http[32:], 99):.3f} | {len(read_ms)} history "
              f"reads ms p50/p99 {np.percentile(read_ms, 50):.3f}/"
              f"{np.percentile(read_ms, 99):.3f} max {read_ms.max():.3f}, "
              f"{len(reads['errors'])} raised, {late} empty answers | "
              f"{len(answered)} answers held to float64 ({tied} reordered "
              f"inside a near-tie) | cli eval {eval_s:.3f}s HitRate@10 "
              f"{[round(x, 6) for x in scores]} best {result['bestIndex']} "
              f"| launches {launches} | {card_tag(card)}", flush=True)
        return launches
    finally:
        pstore.EventStoreFacade.find_by_entity = plain_find
        if env_app is None:
            os.environ.pop("PTPU_EVAL_APP", None)
        else:
            os.environ["PTPU_EVAL_APP"] = env_app
        storage.close()


def forest_votes_numpy(m, X) -> np.ndarray:
    """[B, C] votes of a forest traversed in numpy from its per-node
    arrays (the plain version of ``RandomForestModel.votes``)."""
    X = np.asarray(X, np.float32)
    B, T = len(X), m.feature.shape[0]
    trees = np.broadcast_to(np.arange(T), (B, T))
    node = np.zeros((B, T), np.int64)
    for _ in range(m.max_depth + 1):
        f = m.feature[trees, node]
        xv = np.take_along_axis(X, np.maximum(f, 0), axis=1)
        nxt = np.where(xv <= m.threshold[trees, node], m.left[trees, node],
                       m.right[trees, node])
        node = np.where(f < 0, node, nxt)
    votes = np.zeros((B, len(m.classes)), np.float32)
    np.add.at(votes, (np.arange(B)[:, None], m.leaf[trees, node]), 1.0)
    return votes


def phase_classification(dev, home: str, seed: int, card: dict) -> dict:
    """The shipped classification variant (naive Bayes, as shipped) and a
    random-forest variant (the JAX package's default params) through the
    CLI on SQLite: 100,000 users ``$set`` with ``plan`` and attr0..2,
    ``cli train`` and ``cli deploy`` of each, 64 queries over HTTP held to
    the host float64 ``predict`` (naive Bayes) and to a numpy traversal
    (the forest); every user's point scored on the card in one call and
    held the same way."""
    from predictionio_tpu_torch import cli
    from predictionio_tpu_torch.data.event import from_millis, isoformat_millis
    from predictionio_tpu_torch.data.storage.base import STATUS_COMPLETED
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.workflow.persistence import loads_models

    root = Path(__file__).resolve().parent
    rng = np.random.default_rng(seed + 41)
    plan = rng.integers(0, 2, CLS_USERS)
    attrs = rng.poisson(np.asarray(CLS_MEANS)[plan]).astype(np.float64)
    t0 = 1_760_000_000_000
    lines = [json.dumps({"event": "$set", "entityType": "user",
                         "entityId": f"u{k}", "properties": {
                             "plan": float(plan[k]), "attr0": a[0],
                             "attr1": a[1], "attr2": a[2]},
                         "eventTime": isoformat_millis(from_millis(t0 + k))})
             for k, a in enumerate(attrs.tolist())]
    events_path = Path(home) / "classification_events.jsonl"
    events_path.write_text("\n".join(lines) + "\n")
    shipped = root / "examples" / "classification" / "engine.json"
    variant = json.loads(shipped.read_text())
    app = variant["datasource"]["params"]["app_name"]
    rf_variant = dict(variant, id="classification-rf", algorithms=[
        {"name": "randomforest", "params": {}}])
    rf_path = Path(home) / "classification_rf.json"
    rf_path.write_text(json.dumps(rf_variant))
    # the points in the data source's order: sorted by entity id
    order = sorted(range(CLS_USERS), key=lambda k: f"u{k}")
    X = attrs[order]
    storage = Storage(env={"PIO_HOME": home})
    try:
        check(cli.main(["app", "new", app], storage=storage) == 0,
              "app new failed")
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["import", "--app", app, "--input",
                           str(events_path)], storage=storage)
        import_s = time.perf_counter() - t
        check(rc == 0, f"cli import: {rc} {out.getvalue()}")
        queries = [{"attr0": float(a[0]), "attr1": float(a[1]),
                    "attr2": float(a[2])}
                   for a in rng.poisson(np.asarray(CLS_MEANS)[
                       rng.integers(0, 2, 64)]).tolist()]
        report, launches = [], None
        # -- the main path, counted ----------------------------------------
        zero_launch_counts()
        for name, path, vid in (("naive", shipped, variant["id"]),
                                ("randomforest", rf_path, rf_variant["id"])):
            out = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["train", "--engine-json", str(path)],
                              storage=storage)
            train_s = time.perf_counter() - t
            check(rc == 0, f"cli train {name}: {rc} {out.getvalue()}")
            stages = json.loads(next(
                ln for ln in out.getvalue().splitlines()
                if ln.startswith("Train stages: "))[len("Train stages: "):])
            (inst,) = [x for x in storage.engine_instances().get_all()
                       if x.engine_id == vid]
            check(inst.status == STATUS_COMPLETED,
                  f"{name}: instance {inst.id} is {inst.status}")
            (model,) = loads_models(storage.models().get(inst.id).models)
            args = cli._parser().parse_args([
                "deploy", "--engine-json", str(path), "--ip", "127.0.0.1",
                "--port", "0", "--batching"])
            srv = cli.build_deploy(args, storage).start_background()
            try:
                answered = [_post(srv.port, q) for q in queries]
            finally:
                srv.close()
            Q = np.array([[q["attr0"], q["attr1"], q["attr2"]]
                          for q in queries])
            got = np.array([a["label"] for a, _ in answered])
            model.predict_batch(X[:64], device=dev)  # places the arrays
            torch.cuda.synchronize()
            t = time.perf_counter()
            if name == "naive":
                bulk = model.predict_batch(X, device=dev)
                bulk_s = time.perf_counter() - t
                s64 = model.log_priors + X @ model.log_likelihoods.T
                q64 = model.log_priors + Q @ model.log_likelihoods.T
                ties = 0
                for tag, labels, want, s in (
                        ("HTTP", got, np.array([model.predict(q)
                                                for q in Q]), q64),
                        ("bulk", bulk, model.classes[np.argmax(s64, 1)],
                         s64)):
                    for r in np.flatnonzero(labels != want):
                        ties += 1
                        pick = int(np.flatnonzero(model.classes
                                                  == labels[r])[0])
                        check(s[r].max() - s[r, pick] <= CLS_TIE_ATOL,
                              f"naive {tag} point {r}: label {labels[r]} "
                              f"where the float64 predict gives {want[r]}")
                held = (f"labels equal to the float64 predict but {ties} "
                        f"near-tie(s)")
            else:
                votes = model.votes(X, device=dev).cpu().numpy()
                bulk_s = time.perf_counter() - t
                plain = forest_votes_numpy(model, X)
                check(np.array_equal(votes, plain),
                      f"forest votes off the numpy traversal at "
                      f"{int((votes != plain).any(axis=1).sum())} points")
                qv = forest_votes_numpy(model, Q)
                check(np.array_equal(got, model.classes[np.argmax(qv, 1)]),
                      "forest: an HTTP label is not its votes' argmax")
                bulk = model.classes[np.argmax(votes, axis=1)]
                T, N = model.feature.shape
                held = (f"votes equal to the numpy traversal, {T} trees x "
                        f"{N} nodes")
            acc = float(np.mean(bulk == plan[order]))
            http = np.array([s for _, s in answered]) * 1e3
            report.append(
                f"{name}: cli train {train_s:.3f}s stages {stages}, HTTP ms "
                f"p50/p99 {np.percentile(http, 50):.3f}/"
                f"{np.percentile(http, 99):.3f}, {CLS_USERS} points on the "
                f"card in {bulk_s * 1e3:.3f} ms (training accuracy "
                f"{acc:.4f}), {held}")
        launches = launch_counts()
        # ------------------------------------------------------------------
        check(not any(launches.values()),
              f"classification launched a kernel: {launches}")
        print(f"phase classification: {CLS_USERS} users $set (plan, "
              f"attr0..2) by cli import in {import_s:.3f}s = "
              f"{CLS_USERS / import_s:.1f} events/s | " + " | ".join(report)
              + f" | launches {launches} | {card_tag(card)}", flush=True)
        return launches
    finally:
        storage.close()


#: phase release: the engine id of its two releases (over PIO_APP's
#: events, so no earlier phase's instance list sees them), the rollout
#: gate's window (the JAX package's thresholds otherwise), the users a
#: canary round sends from each cohort group, and how long the canary may
#: take to conclude
RELEASE_ENGINE_ID = "release"
#: the most ratings each rated catalogue item that no 10th user rated
#: gets from the surrogate before the releases train, so they span every item
#: the surrogate rates
RELEASE_FILL = 3
RELEASE_WINDOW_S = 1.0
RELEASE_ROUND = 24
RELEASE_TIMEOUT_S = 120.0


class ArmLaunches:
    """Attributes each ``fused_topk`` launch of the serving path to the
    release arm whose query made it: ``models.als.fused_topk`` (the
    wrapper the serving dispatch calls) is wrapped to count a launch on
    the arm of the calling thread, which is the candidate while a wrapped
    ``QueryServer.query_candidate`` runs (canary answers and shadow
    mirrors) and the stable arm otherwise; each candidate launch is
    bracketed by CUDA events (its device time at B = 1 under HTTP load).
    The wrapper's own count is untouched: the sum over arms must equal
    its delta."""

    def __init__(self, qs):
        from predictionio_tpu_torch.models import als

        self._als, self._qs = als, qs
        self._real_topk, self._real_qc = als.fused_topk, qs.query_candidate
        self._local = threading.local()
        self._lock = threading.Lock()
        self.counts = {"stable": 0, "candidate": 0}
        self.events: list = []

    def __enter__(self):
        local, real_topk, real_qc = (self._local, self._real_topk,
                                     self._real_qc)

        def topk(*a, **kw):
            cand = getattr(local, "candidate", False)
            if cand:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = real_topk(*a, **kw)
                e1.record()
            else:
                out = real_topk(*a, **kw)
            with self._lock:
                self.counts["candidate" if cand else "stable"] += 1
                if cand:
                    self.events.append((e0, e1))
            return out

        def query_candidate(query_json, **kw):
            local.candidate = True
            try:
                return real_qc(query_json, **kw)
            finally:
                local.candidate = False

        self._als.fused_topk = topk
        self._qs.query_candidate = query_candidate
        return self

    def __exit__(self, *exc):
        self._als.fused_topk = self._real_topk
        del self._qs.query_candidate  # the bound method again

    def take(self) -> tuple:
        """The counts and the candidate launches' device ms since the
        last take, and a reset."""
        torch.cuda.synchronize()
        with self._lock:
            counts, events = dict(self.counts), self.events
            self.counts = {"stable": 0, "candidate": 0}
            self.events = []
        return counts, [e0.elapsed_time(e1) for e0, e1 in events]


def phase_release(data, dev, home: str, pio: dict, card: dict) -> dict:
    """Releases on the ``pio`` store: the items the surrogate rates but no
    10th user did get up to ``RELEASE_FILL`` of their surrogate ratings
    each by ``cli import``, then two COMPLETED releases of one engine triple
    (engine id ``release`` over ``PIO_APP``'s events, rank 64, every rated
    item of the catalogue, the algorithm's seed 1 then 2) by ``cli
    train``; ``cli deploy --batching``
    binds the newer; ``cli release pin`` of the older and ``POST
    /reload``; a fresh ``cli deploy`` on the pinned store; a canary of
    the newer through ``POST /release/canary`` (gate window
    ``RELEASE_WINDOW_S``, the JAX package's thresholds) driven until the
    controller concludes, which must be ``promoted`` with 0 errors on
    either arm; a shadow rollout of the older (answers from stable,
    mirrors counted on ``/metrics``), ended by ``POST /release/rollback``;
    then ``POST /release/rollback`` with no candidate, which rebinds the
    older. Every answer is held to the float64 top-k of the factors of
    the release that served it (``check_answer``), the arm read from
    ``cohort_bucket``: the canary's queries come from users whose bucket
    is below the first ramp step (always the candidate) or at or past
    25% (the stable arm until the last step)."""
    from predictionio_tpu_torch import cli
    from predictionio_tpu_torch.data.event import from_millis, isoformat_millis
    from predictionio_tpu_torch.data.storage.base import STATUS_COMPLETED
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models.als import _table_leaves
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.rollout import cohort_bucket
    from predictionio_tpu_torch.workflow.persistence import loads_models

    users, items, stars, _, n_catalogue = data
    # the surrogate's popularity draw leaves some catalogue ids unrated:
    # those no store can hold
    rated = np.bincount(items, minlength=n_catalogue) > 0
    in_store = np.zeros(n_catalogue, bool)
    in_store[items[users % PIO_USER_STRIDE == 0]] = True
    missing = np.flatnonzero(rated & ~in_store)
    order = np.argsort(items, kind="stable")
    starts = np.searchsorted(items[order], missing)
    fill = [int(order[f + j]) for f, it in zip(starts, missing)
            for j in range(RELEASE_FILL)
            if f + j < len(order) and items[order[f + j]] == it]
    t_fill = pio["log_end_ms"] + 86_400_000
    fill_path = Path(home) / "release_fill.jsonl"
    fill_path.write_text("".join(json.dumps({
        "event": "rate", "entityType": "user", "entityId": f"u{users[k]}",
        "targetEntityType": "item", "targetEntityId": f"i{items[k]}",
        "properties": {"rating": float(stars[k])},
        "eventTime": isoformat_millis(from_millis(t_fill + n))}) + "\n"
        for n, k in enumerate(fill)))
    variant = json.loads(Path(pio["engine_json"]).read_text())
    variant["id"] = RELEASE_ENGINE_ID
    path = Path(home) / "release.json"
    release_args = ["--engine-id", RELEASE_ENGINE_ID, "--engine-json",
                    str(path)]
    storage = Storage(env={"PIO_HOME": home})
    srv = None
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["import", "--app", PIO_APP, "--input",
                           str(fill_path)], storage=storage)
        check(rc == 0, f"cli import of the fill: {rc} {out.getvalue()}")
        # -- the phase's path, counted -------------------------------------
        zero_launch_counts()
        train_s = []
        for seed in (1, 2):
            variant["algorithms"][0]["params"]["seed"] = seed
            path.write_text(json.dumps(variant))
            out = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["train", "--engine-json", str(path)],
                              storage=storage)
            torch.cuda.synchronize()
            train_s.append(time.perf_counter() - t)
            check(rc == 0, f"cli train seed {seed}: {rc} {out.getvalue()}")
        train_l = launch_counts()
        check(train_l["fused_gram"] > 0 and train_l["chol_solve"] > 0,
              f"the two trainings' launches: {train_l}")
        old, new = sorted((x for x in storage.engine_instances().get_all()
                           if x.engine_id == RELEASE_ENGINE_ID),
                          key=lambda x: x.start_time)
        for inst in (old, new):
            check(inst.status == STATUS_COMPLETED,
                  f"release {inst.id} is {inst.status}")
        refs = {}
        for inst in (old, new):
            (m,) = loads_models(storage.models().get(inst.id).models)
            ud, us = _table_leaves(m.user_factors.to(dev))
            vd, vs = _table_leaves(m.item_factors.to(dev))
            check(us is None and vs is None, "a stored table is quantized")
            refs[inst.id] = (ud, us, vd, vs, ud.double(), vd.double(),
                             m.n_items, dev, m.user_ids, m.item_ids)
        check(not torch.equal(refs[old.id][0], refs[new.id][0]),
              "the two seeds trained the same factors")
        n_items, rank = refs[new.id][6], refs[new.id][0].shape[1]
        known = refs[new.id][9]
        covered = sum(f"i{j}" in known for j in np.flatnonzero(rated))
        check(covered == int(rated.sum()),
              f"the releases know {covered} of the {int(rated.sum())} "
              f"rated catalogue items")

        def held(q, a, iid) -> None:
            try:
                check_answer(q, a, *refs[iid])
            except SystemExit as e:
                # name the release the answer was held to and where the
                # rollout stood, to tell a rollback from a mis-route
                try:
                    rel = _http(srv.port, "GET", "/release.json")[1]
                    where = (f"rollout {rel['rollout']}, state "
                             f"{rel['state']}")
                except (OSError, KeyError, NameError) as why:
                    where = f"unread: {why!r}"
                which = "newer" if iid == new.id else "older"
                raise SystemExit(f"{e} (held to the {which} release; "
                                 f"/release.json: {where})") from None

        def held_either(q, a, first, second) -> None:
            try:
                check_answer(q, a, *refs[first])
            except SystemExit:
                check_answer(q, a, *refs[second])

        def status(port):
            return _http(port, "GET", "/status.json")[1]

        def rollout(port):
            return _http(port, "GET", "/release.json")[1]["rollout"]

        # the cohort groups, over users both releases know
        rng = np.random.default_rng(23)
        keys = sorted(set(refs[old.id][8].keys())
                      & set(refs[new.id][8].keys()))
        bucket = {u: cohort_bucket(f"user={u}") for u in keys}
        always_cand = [u for u in keys if bucket[u] < 0.01]
        until_last = [u for u in keys if bucket[u] >= 0.25]
        check(bool(always_cand) and bool(until_last),
              f"cohort groups of {len(always_cand)} and "
              f"{len(until_last)} users")
        qn = lambda u: {"user": u, "num": 10}  # noqa: E731

        args = cli._parser().parse_args(
            ["deploy", "--engine-json", str(path), "--ip", "127.0.0.1",
             "--port", "0", "--batching"])
        srv = cli.build_deploy(args, storage).start_background()
        qs = srv.query_server
        check(status(srv.port)["engineInstanceId"] == new.id,
              "deploy did not bind the newer release")
        for u in rng.choice(keys, 8, replace=False):
            held(qn(u), _post(srv.port, qn(u))[0], new.id)

        # pin the older and reload
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["release", "pin", old.id, *release_args],
                          storage=storage)
        check(rc == 0, f"cli release pin: {rc} {out.getvalue()}")
        u = str(rng.choice(keys))
        t = time.perf_counter()
        code, body = _http(srv.port, "POST", "/reload")
        first, _ = _post(srv.port, qn(u))
        reload_s = time.perf_counter() - t
        check(code == 200 and body["engineInstanceId"] == old.id,
              f"/reload: {code} {body}")
        held(qn(u), first, old.id)
        st = status(srv.port)
        check(st["engineInstanceId"] == old.id
              and st["release"]["pinned"] == old.id,
              f"/status.json after the reload: {st['release']}")

        # the cold case: a fresh deploy on the pinned store
        t = time.perf_counter()
        cold = cli.build_deploy(args, storage).start_background()
        try:
            cold_first, _ = _post(cold.port, qn(u))
            cold_s = time.perf_counter() - t
            check(status(cold.port)["engineInstanceId"] == old.id,
                  "a fresh deploy on the pinned store bound another "
                  "release")
            held(qn(u), cold_first, old.id)
        finally:
            cold.close()
        warmed(srv)  # the reload's re-warm, before the arms are counted

        with ArmLaunches(qs) as arms:
            # -- canary ----------------------------------------------------
            real_bind = qs.bind_candidate
            bind_s = []

            def timed_bind(*a, **kw):
                t0 = time.perf_counter()
                real_bind(*a, **kw)
                torch.cuda.synchronize()
                bind_s.append(time.perf_counter() - t0)

            qs.bind_candidate = timed_bind
            gen0 = qs._warm_gen
            try:
                ft0 = ft.LAUNCHES
                code, body = _http(srv.port, "POST", "/release/canary", {
                    "instanceId": new.id, "windowSec": RELEASE_WINDOW_S,
                    "reason": "chip_smoke canary"})
                check(code == 200 and body["rollout"]["fraction"] == 0.01,
                      f"/release/canary: {code} {body}")
            finally:
                del qs.bind_candidate
            t_canary = time.perf_counter()
            lat = {"stable": [], "candidate": []}
            rounds = ambiguous = 0
            while True:
                before = rollout(srv.port)
                if not before["active"]:
                    break
                check(time.perf_counter() - t_canary < RELEASE_TIMEOUT_S,
                      f"the canary did not conclude: {before}")
                sent = []
                for c, s in zip(rng.choice(always_cand, RELEASE_ROUND),
                                rng.choice(until_last, RELEASE_ROUND)):
                    for u, group in ((str(c), "cand"), (str(s), "late")):
                        a, dt = _post(srv.port, qn(u))
                        sent.append((u, group, a, dt))
                after = rollout(srv.port)
                for u, group, a, dt in sent:
                    if group == "cand":
                        held(qn(u), a, new.id)
                        lat["candidate"].append(dt)
                    elif after["active"] and after["fraction"] < 1.0:
                        held(qn(u), a, old.id)
                        lat["stable"].append(dt)
                    else:  # the last ramp step or the promotion
                        ambiguous += 1
                        held_either(qn(u), a, new.id, old.id)
                rounds += 1
            canary_s = time.perf_counter() - t_canary
            # the promotion re-warms the new stable binding on a thread of
            # its own (the controller marks the rollout done before it
            # rebinds): its ladder's launches are the stable arm's, so
            # they finish before the arms and the wrapper are read
            while qs._warm_gen == gen0:
                check(time.perf_counter() - t_canary < RELEASE_TIMEOUT_S,
                      "the promotion did not re-warm the stable binding")
                time.sleep(0.01)
            warmed(srv)
            canary_arms, cand_ms = arms.take()
            canary_ft = ft.LAUNCHES - ft0
            rel = _http(srv.port, "GET", "/release.json")[1]
            ro = rel["rollout"]
            check(ro["outcome"] == "promoted",
                  f"the healthy canary ended {ro['outcome']!r}: "
                  f"{ro['lastDecision']}")
            errors = {a: rel["arms"][a]["errors"] for a in rel["arms"]}
            check(not any(errors.values()),
                  f"errors on the arms: {errors}")
            actions = [e["action"] for e in rel["history"]]
            check("canary" in actions and "promote"
                  in actions[actions.index("canary"):],
                  f"history {actions}")
            check(rel["state"]["stable"] == new.id
                  and rel["state"]["pinned"] == new.id,
                  f"state after promote: {rel['state']}")
            check(status(srv.port)["engineInstanceId"] == new.id,
                  "the promoted release does not serve")
            check(canary_arms["candidate"] > 0 and canary_arms["stable"] > 0
                  and sum(canary_arms.values()) == canary_ft,
                  f"fused_topk launches by arm {canary_arms}, "
                  f"{canary_ft} counted by the wrapper")
            pct = {a: (rel["arms"][a]["latency"]["p50"] * 1e3,
                       rel["arms"][a]["latency"]["p99"] * 1e3)
                   for a in ("stable", "candidate")}

            # -- shadow ----------------------------------------------------
            ft0 = ft.LAUNCHES
            code, body = _http(srv.port, "POST", "/release/canary", {
                "instanceId": old.id, "shadow": True,
                "windowSec": RELEASE_WINDOW_S})
            check(code == 200, f"shadow start: {code} {body}")
            t = time.perf_counter()
            shadow_q = 0
            while rollout(srv.port)["windowsEvaluated"] < 2:
                check(time.perf_counter() - t < RELEASE_TIMEOUT_S,
                      "the shadow gate evaluated no window")
                for u in rng.choice(keys, RELEASE_ROUND):
                    held(qn(str(u)), _post(srv.port, qn(str(u)))[0], new.id)
                    shadow_q += 1
            with _LOCAL.open(f"http://127.0.0.1:{srv.port}/metrics",
                             timeout=30) as resp:
                text = resp.read().decode()
            mirrors = float(next(
                ln.split()[1] for ln in text.splitlines()
                if ln.startswith("pio_release_shadow_mirrors_total ")))
            check(mirrors > 0, "no shadow mirror on /metrics")
            code, body = _http(srv.port, "POST", "/release/rollback")
            check(code == 200 and body["engineInstanceId"] == new.id,
                  f"shadow rollback: {code} {body}")
            # let the mirrors in flight finish before they are counted
            # (the next mirror would start a new pool)
            qs._mirror_pool.shutdown(wait=True)
            qs._mirror_pool = None
            shadow_arms, mirror_ms = arms.take()
            shadow_ft = ft.LAUNCHES - ft0
            check(shadow_arms["candidate"] > 0
                  and sum(shadow_arms.values()) == shadow_ft,
                  f"shadow launches by arm {shadow_arms}, {shadow_ft} "
                  f"counted by the wrapper")
            rel = _http(srv.port, "GET", "/release.json")[1]
            check(rel["rollout"]["outcome"] == "rolled_back"
                  and rel["state"]["candidate"] == "",
                  f"after the shadow: {rel['rollout']['outcome']}")

        # -- rollback with no candidate: the previous release --------------
        code, body = _http(srv.port, "POST", "/release/rollback")
        check(code == 200 and body["engineInstanceId"] == old.id,
              f"/release/rollback: {code} {body}")
        check(status(srv.port)["engineInstanceId"] == old.id,
              "rollback did not rebind the previous release")
        for u in rng.choice(keys, 16, replace=False):
            held(qn(str(u)), _post(srv.port, qn(str(u)))[0], old.id)
        srv.close()
        srv = None
        launches = launch_counts()
        # ------------------------------------------------------------------
        check(launches["fused_topk"] > 0, "the release path launched "
              "fused_topk no time")
        cms = np.array(cand_ms)
        print(f"phase release: {len(fill)} fill ratings of "
              f"{len(missing)} items no 10th user rated | 2 releases of "
              f"({RELEASE_ENGINE_ID}, {variant.get('version', '1')}, "
              f"{path.name}) at rank {rank} x {n_items} items (every "
              f"rated item: {covered} of the catalogue's {n_catalogue} "
              f"ids), cli train {train_s[0]:.3f}s and "
              f"{train_s[1]:.3f}s (launches fused_gram="
              f"{train_l['fused_gram']} chol_solve={train_l['chol_solve']})"
              f" | POST /reload to the first answer from the pinned "
              f"release {reload_s * 1e3:.3f} ms; a fresh deploy to its "
              f"first answer {cold_s:.3f}s | bind_candidate "
              f"{bind_s[0] * 1e3:.3f} ms | canary promoted in "
              f"{canary_s:.3f}s, {rounds} rounds, "
              f"{len(lat['candidate']) + len(lat['stable']) + ambiguous} "
              f"queries ({ambiguous} across the last step), 0 errors | "
              f"fused_topk launches by arm: stable="
              f"{canary_arms['stable']} candidate="
              f"{canary_arms['candidate']} | /release.json latency ms "
              f"p50/p99: stable {pct['stable'][0]:.3f}/"
              f"{pct['stable'][1]:.3f} candidate "
              f"{pct['candidate'][0]:.3f}/{pct['candidate'][1]:.3f} | "
              f"candidate fused_topk at B = 1 under HTTP load, device ms "
              f"p50/p99 {np.percentile(cms, 50):.4f}/"
              f"{np.percentile(cms, 99):.4f} over {len(cms)} | shadow "
              f"{shadow_q} queries, {int(mirrors)} mirrors, launches "
              f"stable={shadow_arms['stable']} mirrored="
              f"{shadow_arms['candidate']} | rollback rebound {old.id} | "
              f"launches {launches} | {card_tag(card)}", flush=True)
        return launches
    finally:
        if srv is not None:
            srv.close()
        storage.close()

CONSOLE_QUERIES = 32
CONSOLE_DRAIN_QUERIES = 16
#: the longest a console command or a deploy's start may take
CONSOLE_TIMEOUT_S = 300.0
CONSOLE_APP = "ConsoleApp"


def ladder_calls(n_items: int, max_batch: int) -> int:
    """The serving ladder's calls (``ALSAlgorithm.warm_serving``): one
    ``recommend_products`` a k, then one ``recommend_batch`` a k a batch
    size, k = 8, 16, ... up to min(128, n_items), the batch sizes the
    powers of two up to the power-of-two ceiling of ``max_batch``."""
    ks = len([k for k in (8, 16, 32, 64, 128) if k <= min(128, n_items)]) \
        or 1
    bs = 1
    while 1 << (bs - 1) < max_batch:
        bs += 1
    return ks + ks * bs


def cli_process(args: list, env: dict, log: Path) -> subprocess.Popen:
    """``python -m predictionio_tpu_torch.cli ARGS`` with its output in
    ``log``."""
    root = Path(__file__).resolve().parent
    with open(log, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli", *args],
            stdout=f, stderr=subprocess.STDOUT, cwd=root, env=env)


def end_process(proc: subprocess.Popen, timeout: float = 60.0) -> int:
    """Wait for ``proc``, killing it past ``timeout``; its exit code."""
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        return -9


def run_cli(args: list, env: dict, log: Path) -> tuple:
    """One console command to its end: (exit code, output, seconds)."""
    t = time.perf_counter()
    proc = cli_process(args, env, log)
    rc = end_process(proc, CONSOLE_TIMEOUT_S)
    return rc, log.read_text(), time.perf_counter() - t


def console_deploy(tag: str, engine_json: str, artifact_dir, env: dict,
                   logs: Path, storage, dev,
                   queries: int = CONSOLE_QUERIES,
                   procs: list = None) -> dict:
    """``cli deploy --batching --artifact-dir`` as a fresh process (no
    ``--artifact-dir`` when it is None): the seconds from its start to
    the first correct answer (asked as soon as the port answers) and to
    ``servingWarm`` (polled beside it), then ``queries`` answers held to
    the float64 top-k of the bound tables, whose model is read back from
    ``storage``. Returns the server's port, process and numbers; the
    caller undeploys it. The process joins ``procs`` as it starts, so
    that the caller ends it should this fail."""
    from predictionio_tpu_torch.models.als import _table_leaves
    from predictionio_tpu_torch.workflow.persistence import loads_models

    log = logs / f"deploy_{tag}.log"
    device = [] if dev.type == "cuda" else ["--device", "cpu"]
    t0 = time.perf_counter()
    art = [] if artifact_dir is None else ["--artifact-dir", artifact_dir]
    proc = cli_process(["deploy", "--engine-json", engine_json, "--ip",
                        "127.0.0.1", "--port", "0", "--batching", *art,
                        *device], env, log)
    if procs is not None:
        procs.append(proc)
    out = {"proc": proc}
    port = None
    while port is None:
        check(proc.poll() is None and time.perf_counter() - t0
              < CONSOLE_TIMEOUT_S,
              f"deploy {tag} did not start: {log.read_text()[-2000:]}")
        for line in log.read_text().splitlines():
            if " is listening at http://" in line:
                port = int(line.rsplit(":", 1)[1].rstrip("."))
        time.sleep(0.01)
    out["port"] = port
    warm_at = []

    def poll_warm():
        while time.perf_counter() - t0 < CONSOLE_TIMEOUT_S:
            try:
                if _http(port, "GET", "/status.json")[1]["servingWarm"]:
                    warm_at.append(time.perf_counter() - t0)
                    return
            except OSError:
                pass
            time.sleep(0.005)

    poller = threading.Thread(target=poll_warm, name="warm-poll")
    poller.start()
    # user 0 rated (the surrogate's every user does) and is a 10th user
    first_q = {"user": "u0", "num": 10}
    first, _ = _post(port, first_q)
    out["first_s"] = time.perf_counter() - t0
    poller.join(CONSOLE_TIMEOUT_S)
    check(bool(warm_at), f"deploy {tag} never read servingWarm")
    out["warm_s"] = warm_at[0]
    status = _http(port, "GET", "/status.json")[1]
    out["status"] = status
    (model,) = loads_models(storage.models().get(
        status["engineInstanceId"]).models)
    ud, us = _table_leaves(model.user_factors.to(dev))
    vd, vs = _table_leaves(model.item_factors.to(dev))
    ref = (ud, us, vd, vs, ud.double(), vd.double(), model.n_items, dev,
           model.user_ids, model.item_ids)
    out["ref"], out["n_items"] = ref, model.n_items
    check("u0" in model.user_ids, "the bound model does not know u0")
    check_answer(first_q, first, *ref)
    rng = np.random.default_rng(len(tag))
    keys = [k for k, _ in model.user_ids.items()]
    for u in rng.choice(len(keys), queries, replace=False):
        q = {"user": keys[u], "num": 10}
        check_answer(q, _post(port, q)[0], *ref)
    return out


def phase_console(dev, home: str, pio: dict, card: dict) -> dict:
    """The console on phase 8's store (see the module's docstring, phase
    14). Returns ``fused_topk``'s launches in the two deploys, read from
    their ``/status.json``."""
    from predictionio_tpu_torch import cli
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.ops import _build

    root = Path(__file__).resolve().parent
    work = Path(tempfile.mkdtemp(prefix="console_", dir=Path(home)))
    env = dict(os.environ, PIO_HOME=home, PYTHONPATH=os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH", "")) if p))
    env.pop("PTPU_ARTIFACT_DIR", None)
    built_dir, cold_dir = work / "built", work / "cold"
    storage = Storage(env={"PIO_HOME": home})
    procs, pids = [], {}
    start_all = False
    try:
        # -- build, cold then built ----------------------------------------
        rc, log, build_s = run_cli(
            ["build", "--engine-json", pio["engine_json"], "--artifact-dir",
             str(built_dir)], env, work / "build1.log")
        check(rc == 0, f"cli build: {rc} {log[-2000:]}")
        nvcc = {}
        for name in _build.all_sources():
            line = next((ln for ln in log.splitlines()
                         if ln.startswith(f"  {name}: ")), "")
            check("compiled (" in line, f"cli build into an empty dir did "
                  f"not compile {name}: {line!r}")
            nvcc[name] = float(line.rsplit("(", 1)[1].rstrip("s)"))
        # the host codec builds beside the kernels (g++, not nvcc)
        codec = next((ln for ln in log.splitlines()
                      if ln.startswith("  native codec ")), "")
        check("compiled (" in codec, f"cli build into an empty dir did not "
              f"compile the native codec: {codec!r}")
        gxx_s = float(codec.rsplit("(", 1)[1].rstrip("s)"))
        rc, log2, rebuild_s = run_cli(
            ["build", "--engine-json", pio["engine_json"], "--artifact-dir",
             str(built_dir)], env, work / "build2.log")
        check(rc == 0 and "compiled (" not in log2
              and log2.count("already built (") == len(nvcc) + 1,
              f"the second cli build ran nvcc or g++: {log2[-2000:]}")

        # -- deploy, built and cold, side by side (to shorten the phase:
        # each measures its own start-up with the other's beside it) -----
        def deploy_one(tag: str, art: Path) -> dict:
            d = console_deploy(tag, pio["engine_json"], str(art), env, work,
                               storage, dev, procs=procs)
            st = d["status"]
            rep = st["warmReport"]
            check("error" not in rep, f"deploy {tag}: {rep.get('error')}")
            check(st["lifecycle"] == "ready", f"deploy {tag}: lifecycle "
                  f"{st['lifecycle']}")
            need = ladder_calls(d["n_items"], 128)
            check(rep["probeCalls"] == need,
                  f"deploy {tag}: {rep['probeCalls']} ladder calls, "
                  f"{need} expected")
            d["launches"] = st["kernels"]["fused_topk"]["launches"]
            check(dev.type != "cuda" or (
                d["launches"] >= need
                and rep["launches"]["fused_topk"] >= need),
                  f"deploy {tag}: fused_topk counted {d['launches']} "
                  f"(warm-up {rep['launches']}), the ladder makes {need}")
            if tag == "built":
                check(st["artifactWarm"] and rep["seconds"]["compile"] == 0,
                      f"the built deploy compiled: {rep}")
                d.update(console_status_page_drain(d, env, work, card))
            else:
                check(rep["seconds"]["compile"] > 0
                      and not st["artifactWarm"],
                      f"the cold deploy compiled nothing: {rep}")
            # every launch the process made: warm-up, first answer and
            # the answers held to float64 (and, built, the drain's)
            d["total_launches"] = _http(d["port"], "GET", "/status.json")[
                1]["kernels"]["fused_topk"]["launches"]
            rc = cli.main(["undeploy", "--ip", "127.0.0.1", "--port",
                           str(d["port"])], storage=storage)
            check(rc == 0, f"cli undeploy of the {tag} deploy: {rc}")
            check(end_process(d["proc"]) == 0,
                  f"the {tag} deploy did not exit cleanly: "
                  f"{(work / f'deploy_{tag}.log').read_text()[-2000:]}")
            return d

        t_deploys = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            running = {tag: pool.submit(deploy_one, tag, art) for tag, art
                       in (("built", built_dir), ("cold", cold_dir))}
        deploys = {tag: f.result() for tag, f in running.items()}
        deploys_s = time.perf_counter() - t_deploys

        # -- start-all: the admin API and the dashboard --------------------
        pid_dir = work / "pids"
        ports = {}
        for name in ("eventserver", "adminserver", "dashboard"):
            with contextlib.closing(socket.socket()) as sk:
                sk.bind(("127.0.0.1", 0))
                ports[name] = sk.getsockname()[1]
        saved = {k: os.environ.get(k) for k in ("PIO_HOME", "PYTHONPATH")}
        os.environ.update(PIO_HOME=home, PYTHONPATH=env["PYTHONPATH"])
        try:
            start_all = True
            out = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main([
                    "start-all", "--ip", "127.0.0.1", "--pid-dir",
                    str(pid_dir), "--eventserver-port",
                    str(ports["eventserver"]), "--adminserver-port",
                    str(ports["adminserver"]), "--dashboard-port",
                    str(ports["dashboard"]), "--start-timeout", "120"],
                    storage=storage)
            start_s = time.perf_counter() - t
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        pids = {p.stem: int(p.read_text()) for p in pid_dir.glob("*.pid")}
        check(rc == 0 and len(pids) == 3,
              f"cli start-all: {rc} {out.getvalue()} pids {pids}")
        admin = ports["adminserver"]
        code, body = _http(admin, "GET", "/cmd/app")
        listed = {a["name"] for a in body["apps"]}
        check(code == 200 and PIO_APP in listed, f"admin list: {code}")
        code, body = _http(admin, "POST", "/cmd/app",
                           {"name": CONSOLE_APP})
        check(code == 200 and body["status"] == 1 and body["key"],
              f"admin create: {code} {body}")
        for path in (f"/cmd/app/{CONSOLE_APP}/data",
                     f"/cmd/app/{CONSOLE_APP}"):
            code, body = _http(admin, "DELETE", path)
            check(code == 200 and body["status"] == 1,
                  f"admin DELETE {path}: {code} {body}")
        check(storage.apps().get_by_name(CONSOLE_APP) is None,
              "the admin API did not delete the app")
        evals = storage.evaluation_instances().get_completed()
        check(bool(evals), "no EVALCOMPLETED instance to list")
        with _LOCAL.open(f"http://127.0.0.1:{ports['dashboard']}/",
                         timeout=60) as resp:
            page = resp.read().decode()
        check(all(e.id in page for e in evals),
              "the dashboard does not list the eval phase's instances")
        for suffix in ("html", "json"):
            with _LOCAL.open(
                    f"http://127.0.0.1:{ports['dashboard']}/engine_instances"
                    f"/{evals[0].id}/evaluator_results.{suffix}",
                    timeout=60) as resp:
                body = resp.read()
            check(resp.status == 200 and body, f"dashboard .{suffix}")
            if suffix == "json":
                json.loads(body)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["stop-all", "--pid-dir", str(pid_dir)],
                          storage=storage)
        start_all = False
        left = [n for n, pid in pids.items() if cli._pid_alive(pid)]
        check(rc == 0 and not left, f"stop-all: {rc} left {left}")

        # -- export and import ---------------------------------------------
        exported = work / "export.jsonl"
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["export", "--app", SEQ_APP, "--output",
                           str(exported)], storage=storage)
        export_s = time.perf_counter() - t
        check(rc == 0, f"cli export: {rc} {out.getvalue()}")
        n_out = int(out.getvalue().split()[1])
        app_id = storage.apps().get_by_name(SEQ_APP).id
        n_store = sum(1 for _ in storage.events().find(app_id))
        check(n_out == n_store == sum(1 for _ in open(exported)),
              f"exported {n_out} of {n_store} events")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["app", "new", CONSOLE_APP], storage=storage)
            t = time.perf_counter()
            rc2 = cli.main(["import", "--app", CONSOLE_APP, "--input",
                            str(exported)], storage=storage)
            import_s = time.perf_counter() - t
        check(rc == 0 and rc2 == 0, f"cli import: {out.getvalue()}")
        new_id = storage.apps().get_by_name(CONSOLE_APP).id
        n_in = sum(1 for _ in storage.events().find(new_id))
        check(n_in == n_out, f"imported {n_in} of {n_out} events")
        b, c = deploys["built"], deploys["cold"]
        launches = b["total_launches"] + c["total_launches"]
        print(f"phase console: cli build into an empty dir "
              f"{build_s:.3f}s (nvcc " + " ".join(
                  f"{k}={v:.2f}s" for k, v in sorted(nvcc.items()))
              + f", native codec g++ {gxx_s:.2f}s), again "
              f"{rebuild_s:.3f}s (no nvcc, no g++) | deploy built: "
              f"servingWarm at {b['warm_s']:.3f}s, first answer at "
              f"{b['first_s']:.3f}s, warmReport "
              f"{json.dumps(b['status']['warmReport']['seconds'])} "
              f"artifactWarm={b['status']['artifactWarm']} | deploy cold: "
              f"servingWarm at {c['warm_s']:.3f}s, first answer at "
              f"{c['first_s']:.3f}s, warmReport "
              f"{json.dumps(c['status']['warmReport']['seconds'])} "
              f"artifactWarm={c['status']['artifactWarm']} | both deploys "
              f"side by side, start to exit {deploys_s:.3f}s | ladder "
              f"{ladder_calls(b['n_items'], 128)} calls, fused_topk "
              f"counted once warm built={b['launches']} cold="
              f"{c['launches']}, in all built={b['total_launches']} cold="
              f"{c['total_launches']} | "
              f"{CONSOLE_QUERIES} answers each held to float64 | status "
              f"{b['status_s']:.3f}s, drain: {CONSOLE_DRAIN_QUERIES} "
              f"answers, +{b['drain_launches']} launches | start-all "
              f"{start_s:.3f}s, admin and dashboard checked, stop-all left "
              f"none | export {n_out} events in {export_s:.3f}s = "
              f"{n_out / export_s:.1f} rows/s, import {import_s:.3f}s = "
              f"{n_in / import_s:.1f} rows/s | {card_tag(card)}",
              flush=True)
        return {"fused_topk": launches}
    finally:
        if start_all:
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["stop-all", "--pid-dir", str(work / "pids")],
                         storage=storage)
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
                end_process(proc, 30)
        storage.close()


def console_status_page_drain(d: dict, env: dict, work: Path,
                              card: dict) -> dict:
    """On a live deploy: ``cli status --ip --port`` names the card and its
    power limit, ``GET /`` names the instance, ``POST /drain`` flips the
    lifecycle and the answers after it stay correct."""
    port, inst = d["port"], d["status"]["engineInstanceId"]
    device = [] if card["name"] != "cpu" else ["--device", "cpu"]
    rc, log, status_s = run_cli(["status", "--ip", "127.0.0.1", "--port",
                                 str(port), *device], env,
                                work / "status.log")
    check(rc == 0 and f"card: {card['name']}" in log
          and f"power limit {card['power_limit'] or 'n/a'}" in log
          and f"base {inst}" in log,
          f"cli status: {rc} {log[-2000:]}")
    with _LOCAL.open(f"http://127.0.0.1:{port}/", timeout=60) as resp:
        page = resp.read().decode()
    check(resp.status == 200 and inst in page, "GET / lacks the instance")
    code, body = _http(port, "POST", "/drain")
    check(code == 200 and body == {"lifecycle": "draining"},
          f"POST /drain: {code} {body}")
    before = _http(port, "GET", "/status.json")[1]
    rng = np.random.default_rng(99)
    keys = [k for k, _ in d["ref"][8].items()]
    for u in rng.choice(len(keys), CONSOLE_DRAIN_QUERIES, replace=False):
        q = {"user": keys[u], "num": 10}
        check_answer(q, _post(port, q)[0], *d["ref"])
    after = _http(port, "GET", "/status.json")[1]
    grown = (after["kernels"]["fused_topk"]["launches"]
             - before["kernels"]["fused_topk"]["launches"])
    check(after["lifecycle"] == "draining"
          and (card["name"] == "cpu" or grown > 0),
          f"after the drain: {after['lifecycle']}, +{grown} launches")
    return {"status_s": status_s, "drain_launches": grown}


# -- phase 15: checkpoint resume and the split layout -------------------------

#: phase 15's crash: the commit of step 6 fails, so steps up to 5 are
#: committed when the run dies
RESUME_FAULT = "checkpoint.commit=error,after=5,times=1"
RESUME_STEP = 5
#: one split iteration held to one bucket iteration from the same
#: factors (the same normal equations summed in another order): phase
#: 6's kernel-against-plain limits
SPLIT_ATOL, SPLIT_RTOL = 2e-4, 2e-3


def timed_saves(ckpt_mod):
    """Wrap ``Checkpointer.save`` to record each save's seconds and bytes
    (the host copy of the factors included); returns the record list and
    the undo."""
    orig = ckpt_mod.Checkpointer.save
    record = []

    def save(self, step, state):
        t0 = time.perf_counter()
        n = orig(self, step, state)
        record.append((time.perf_counter() - t0, n))
        return n

    ckpt_mod.Checkpointer.save = save
    return record, lambda: setattr(ckpt_mod.Checkpointer, "save", orig)


def phase_resume(data, dev, work: Path, card: dict) -> dict:
    """``train_als(checkpoint_dir=...)`` at ML-20M width: an uninterrupted
    run, a run killed after step 5 and resumed past a torn step 6 (its
    factors bitwise those of the uninterrupted run and of a run without
    checkpoints, its kernels launched only for the iterations left), a
    foreign run refused, and the split layout trained twice (bitwise
    equal) and held to the bucket layout. Returns the counted launches of
    the resumed run."""
    import warnings

    from predictionio_tpu_torch.faults import FaultError, inject_spec
    from predictionio_tpu_torch.faults import registry as fault_registry
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops.ragged import SplitHistories
    from predictionio_tpu_torch.workflow import checkpoint as ckpt_mod

    users, items, stars, n_users, n_items = data
    ratings = als.RatingsCOO(users, items, stars, n_users, n_items)
    params = als.ALSParams(rank=RANK, num_iterations=TRAIN_ITERS)
    packed = als.pack_ratings(ratings, params, device=dev)

    def train(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        U, V = als.train_als(ratings, params, device=dev, packed=packed, **kw)
        torch.cuda.synchronize()
        return U, V, time.perf_counter() - t0

    U0, V0, plain_s = train()
    saves, undo = timed_saves(ckpt_mod)
    try:
        # (a) uninterrupted, saving every iteration
        Ua, Va, ckpt_s = train(checkpoint_dir=str(work / "a"))
        a_saves = list(saves)
        # (b) the same run dies as step 6 commits, a torn step 6 is left
        # beside the committed ones, and a fresh call resumes
        inject_spec(RESUME_FAULT)
        try:
            train(checkpoint_dir=str(work / "b"))
            fail("the checkpoint.commit fault did not stop the run")
        except FaultError:
            pass
        finally:
            fault_registry().clear("checkpoint.commit")
        kept = ckpt_mod.Checkpointer(str(work / "b")).all_steps()
        check(kept[-1] == RESUME_STEP,
              f"after the crash the steps on disk are {kept}")
        (work / "b" / f"step_{RESUME_STEP + 1}.npz").write_bytes(
            b"PK\x03\x04torn")
        zero_launch_counts()
        Ub, Vb, resume_s = train(checkpoint_dir=str(work / "b"))
        counted = launch_counts()
    finally:
        undo()
    per_iter = {k: counted[k] // (TRAIN_ITERS - RESUME_STEP)
                for k in ("fused_gram", "chol_solve")}
    zero_launch_counts()
    train()
    full = launch_counts()
    for k in ("fused_gram", "chol_solve"):
        check(counted[k] > 0 and full[k] == counted[k] * TRAIN_ITERS
              // (TRAIN_ITERS - RESUME_STEP),
              f"the resumed run launched {k} {counted[k]} times, a whole "
              f"run {full[k]}: not the {TRAIN_ITERS - RESUME_STEP} "
              f"iterations left")
    for tag, (U, V) in (("uninterrupted", (Ua, Va)),
                        ("without checkpoints", (U0, V0))):
        check(torch.equal(Ub, U) and torch.equal(Vb, V),
              f"the resumed factors differ from the {tag} run's "
              f"(max |dU| {(Ub - U).abs().max().item():.3e})")
    # (c) a run of other params is refused, before any iteration
    try:
        als.train_als(ratings, dataclasses.replace(params, seed=4),
                      device=dev, packed=packed,
                      checkpoint_dir=str(work / "a"))
        fail("a foreign checkpoint directory was not refused")
    except ValueError as e:
        check("different ALS run" in str(e), f"the refusal said: {e}")
    save_s = np.array([t for t, _ in a_saves])
    save_bytes = a_saves[0][1]

    # (d) the split layout
    split_params = dataclasses.replace(params, history_mode="split")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        t0 = time.perf_counter()
        sp = als.pack_ratings(ratings, split_params, device=dev)
        torch.cuda.synchronize()
        split_pack_s = time.perf_counter() - t0
    check(isinstance(sp.user_h, SplitHistories)
          and isinstance(sp.item_h, SplitHistories),
          "history_mode='split' did not pack the split layout")
    init = als.draw_initial_factors(
        params.seed, n_users, als._rows_padded(sp.user_h), n_items,
        als._rows_padded(sp.item_h), RANK)
    init = tuple(t.numpy() for t in init)
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Us1, Vs1 = als.train_als(ratings, split_params, device=dev, packed=sp,
                             init=init)
    torch.cuda.synchronize()
    split_s = time.perf_counter() - t0
    split_l = launch_counts()
    Us2, Vs2 = als.train_als(ratings, split_params, device=dev, packed=sp,
                             init=init)
    check(torch.equal(Us1, Us2) and torch.equal(Vs1, Vs2),
          "two split trainings differ: the accumulation is not "
          "deterministic")
    check(split_l["fused_gram"] > 0 and split_l["chol_solve"] > 0,
          f"split training launched {split_l}")
    # one iteration of each layout from the same factors
    one = dataclasses.replace(params, num_iterations=1)
    Ub1, Vb1 = als.train_als(ratings, one, device=dev, packed=packed,
                             init=init)
    Us_1, Vs_1 = als.train_als(ratings, dataclasses.replace(
        split_params, num_iterations=1), device=dev, packed=sp, init=init)
    for name, got, want in (("U", Us_1, Ub1), ("V", Vs_1, Vb1)):
        bad = (got - want).abs() > SPLIT_ATOL + SPLIT_RTOL * want.abs()
        check(not bool(bad.any()),
              f"one split iteration: {name} off the bucket layout's at "
              f"{int(bad.sum())} entries (max "
              f"{(got - want).abs().max().item():.3e})")
    u_t = torch.from_numpy(users.astype(np.int64)).to(dev)
    i_t = torch.from_numpy(items.astype(np.int64)).to(dev)
    s_t = torch.from_numpy(stars).to(dev)
    rmse_split = rmse(Us1, Vs1, u_t, i_t, s_t)
    rmse_bucket = rmse(U0, V0, u_t, i_t, s_t)
    check(abs(rmse_split - rmse_bucket) <= 1e-3 * rmse_bucket,
          f"split RMSE {rmse_split:.5f} against the bucket layout's "
          f"{rmse_bucket:.5f}")

    def split_iteration():
        U = als._update_side_split(torch.from_numpy(init[1]).to(dev),
                                   sp.user_h, split_params)
        return U, als._update_side_split(U, sp.item_h, split_params)

    split_iteration()
    iter_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        split_iteration()
        torch.cuda.synchronize()
        iter_times.append(time.perf_counter() - t0)
    _, bd = profile_device("phase resume split profile, one iteration",
                           split_iteration)
    sm = split_over_mesh(ratings, split_params, sp, init, split_iteration,
                         dev, card)
    print(f"phase resume: train_als rank {RANK} x {TRAIN_ITERS} at ML-20M "
          f"width: without checkpoints {plain_s:.3f}s, saving every "
          f"iteration {ckpt_s:.3f}s | a save: {save_bytes} bytes, median "
          f"{np.median(save_s) * 1e3:.3f} ms (min {save_s.min() * 1e3:.3f} "
          f"max {save_s.max() * 1e3:.3f}) | killed at step "
          f"{RESUME_STEP + 1}'s commit ({RESUME_FAULT}), torn step_"
          f"{RESUME_STEP + 1}.npz skipped, resumed from {RESUME_STEP} in "
          f"{resume_s:.3f}s: U and V bitwise equal to the uninterrupted "
          f"run's and the checkpoint-free run's | resumed launches "
          f"fused_gram={counted['fused_gram']} chol_solve="
          f"{counted['chol_solve']} ({per_iter} an iteration, a whole run "
          f"{full['fused_gram']}/{full['chol_solve']}) | a foreign run "
          f"refused | {card_tag(card)}", flush=True)
    print(f"phase resume split: L user={sp.user_h.max_len} "
          f"item={sp.item_h.max_len}, virtual rows user="
          f"{sp.user_h.n_virtual} item={sp.item_h.n_virtual} (real "
          f"{n_users} / {n_items}), pack {split_pack_s:.3f}s | "
          f"{TRAIN_ITERS} iterations {split_s:.3f}s, one iteration median "
          f"{np.median(iter_times) * 1e3:.3f} ms (runs "
          f"{', '.join(f'{t * 1e3:.3f}' for t in iter_times)}); profiled: "
          f"fused_gram={bd['fused_gram']:.3f} chol_solve="
          f"{bd['chol_solve']:.3f} other_kernels="
          f"{bd['device_ms'] - bd['fused_gram'] - bd['chol_solve']:.3f} "
          f"device_idle={bd['wall_ms'] - bd['device_ms']:.3f} | launches "
          f"fused_gram={split_l['fused_gram']} chol_solve="
          f"{split_l['chol_solve']} | two trainings bitwise equal | one "
          f"iteration held to the bucket layout's (atol {SPLIT_ATOL}, rtol "
          f"{SPLIT_RTOL}), RMSE after {TRAIN_ITERS} split={rmse_split:.5f} "
          f"bucket={rmse_bucket:.5f} | {card_tag(card)}", flush=True)
    return {"fused_gram": counted["fused_gram"],
            "chol_solve": counted["chol_solve"],
            "fused_topk": counted["fused_topk"],
            "gram_table": counted["gram_table"],
            "split_fused_gram": split_l["fused_gram"],
            "split_chol_solve": split_l["chol_solve"],
            "split_mesh_fused_gram": sm["fused_gram"],
            "split_mesh_chol_solve": sm["chol_solve"]}


#: the split layout over a mesh: positions on the one card
SPLIT_MESH_POSITIONS = 4


def split_over_mesh(ratings, split_params, sp, init, split_iteration, dev,
                    card: dict) -> dict:
    """The split layout over SPLIT_MESH_POSITIONS positions on the one
    card from phase resume's initial factors: 2 explicit iterations and 1
    implicit, each bitwise the one card's split training (``sp``), the
    ``fused_gram`` and ``chol_solve`` launches counted and held to the
    pieces and the positions the mesh cut; then one iteration's ms on each
    path."""
    import warnings

    from predictionio_tpu_torch.models import als

    n_users, n_items = ratings.n_users, ratings.n_items
    mesh = forced_mesh(SPLIT_MESH_POSITIONS, dev)
    t_all = t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        spm = als.pack_ratings(ratings, split_params, mesh=mesh)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    us = spm.mesh_side("user", split_params)
    its = spm.mesh_side("item", split_params)
    init_real = (init[0][:n_users], init[1][:n_items])
    counted = {"fused_gram": 0, "chol_solve": 0}
    iters = 0
    for tag, prm in (
            ("explicit", dataclasses.replace(split_params, num_iterations=2)),
            ("implicit", dataclasses.replace(
                split_params, num_iterations=1, implicit_prefs=True,
                alpha=1.0))):
        U1, V1 = als.train_als(ratings, prm, device=dev, packed=sp,
                               init=init)
        zero_launch_counts()
        Um, Vm = als.train_als(ratings, prm, mesh=mesh, packed=spm,
                               init=init_real)
        torch.cuda.synchronize()
        got = launch_counts()
        iters += prm.num_iterations
        for k in counted:
            counted[k] += got[k]
        for name, m, one, n in (("U", Um, U1, n_users),
                                ("V", Vm, V1, n_items)):
            whole = als.unshard_table(m)[:n]
            check(torch.equal(whole, one[:n]),
                  f"split over {SPLIT_MESH_POSITIONS} positions, {tag}: "
                  f"{name} is not the one card's bit for bit (max |d| "
                  f"{(whole - one[:n]).abs().max().item():.3e})")
    want = {"fused_gram": (us.launches + its.launches) * iters,
            "chol_solve": (us.solves + its.solves) * iters}
    check(counted == want and all(counted.values()),
          f"split over a mesh launched {counted}, its pieces and "
          f"positions make {want}")
    Vr = als._replicate(als._initial_tables(
        split_params, init_real, n_users, us.n_rows_padded, n_items,
        its.n_rows_padded)[1], mesh)

    def mesh_iteration():
        Ur = als._mesh_half_step(Vr, us, split_params, mesh, n_items)
        return als._mesh_half_step(Ur, its, split_params, mesh, n_users)

    one_ms = mesh_iteration_ms(split_iteration)
    mesh_ms = mesh_iteration_ms(mesh_iteration)
    print(f"phase resume split mesh: the split layout over "
          f"{SPLIT_MESH_POSITIONS} positions on one card, pack_ratings(mesh) "
          f"{pack_s:.3f}s | 2 explicit and 1 implicit iteration bitwise "
          f"the one card's split training | launches fused_gram="
          f"{counted['fused_gram']} chol_solve={counted['chol_solve']} "
          f"({us.launches + its.launches} and {us.solves + its.solves} an "
          f"iteration: pieces, and positions holding rows) | one iteration "
          f"ms: one card {one_ms:.3f}, {SPLIT_MESH_POSITIONS} positions "
          f"{mesh_ms:.3f} ({mesh_ms / one_ms:.3f}x) | this check "
          f"{time.perf_counter() - t_all:.2f}s | {card_tag(card)}",
          flush=True)
    return counted


# -- phase 16: a model blob the JAX package wrote -------------------------------

JAX_FACTORY = "predictionio_tpu.templates.recommendation:recommendation_engine"
JAXBLOB_QUERIES = 64


@dataclasses.dataclass
class JaxALSParams:
    """Stand-in for the JAX package's ``ALSParams``: its fields, pickled
    under its module path (:class:`JaxLayoutPickler`)."""

    JAX_NAME = ("predictionio_tpu.models.als", "ALSParams")
    rank: int = 10
    num_iterations: int = 10
    reg: float = 0.01
    alpha: float = 1.0
    implicit_prefs: bool = False
    seed: int = 3
    max_history: object = None
    scale_reg_by_count: bool = True
    block_rows: object = None
    matmul_dtype: str = "float32"
    gather_dtype: str = "float32"
    gram_mode: str = "auto"
    history_mode: str = "auto"


class JaxBiMap:
    """Stand-in for the JAX package's ``BiMap``: its ``_fwd``/``_rev``
    state."""

    JAX_NAME = ("predictionio_tpu.data.bimap", "BiMap")

    def __init__(self, forward: dict):
        self._fwd = dict(forward)
        self._rev = {v: k for k, v in self._fwd.items()}


@dataclasses.dataclass
class JaxALSModel:
    """Stand-in for the JAX package's host ``ALSModel`` as its blob holds
    it (numpy factors, no mesh)."""

    JAX_NAME = ("predictionio_tpu.models.als", "ALSModel")
    user_factors: np.ndarray
    item_factors: np.ndarray
    n_users: int
    n_items: int
    user_ids: object = None
    item_ids: object = None
    params: object = dataclasses.field(default_factory=JaxALSParams)
    mesh: object = None


class JaxLayoutPickler(pickle._Pickler):
    """The pure-Python pickler, writing each stand-in class under the JAX
    package's module path and name: the bytes the JAX package's
    ``dumps_models`` writes, without the JAX package."""

    def save_global(self, obj, name=None):
        jax_name = getattr(obj, "JAX_NAME", None) \
            if isinstance(obj, type) else None
        if jax_name is None:
            return super().save_global(obj, name)
        module, qualname = jax_name
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def jax_layout_blob(models: list) -> bytes:
    """``pickle.dump(models, protocol=4)`` as the JAX package writes its
    MODELDATA blob, stand-ins under the JAX package's names."""
    buf = io.BytesIO()
    JaxLayoutPickler(buf, protocol=4).dump(models)
    return buf.getvalue()


class _WritesAMarker:
    """Pickles as a call that would create ``path``: what the reader must
    refuse before anything runs."""

    def __init__(self, path: str):
        self.path = path

    def __reduce__(self):
        return (open, (self.path, "w"))


def phase_jaxblob(uv, dev, home: str, card: dict) -> dict:
    """A full-width model blob in the JAX package's layout, stored under
    an engine instance with the JAX package's factory name, deployed by
    ``cli deploy`` and held to the same factors served from the port's
    own blob; a blob naming another global refused with nothing run."""
    from predictionio_tpu_torch import cli
    from predictionio_tpu_torch.data.event import utcnow
    from predictionio_tpu_torch.data.storage.base import (
        STATUS_COMPLETED,
        EngineInstance,
        Model,
    )
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models.convert import als_model_from_numpy
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.server.engineserver import (
        ServerConfig,
        deploy_models,
    )
    from predictionio_tpu_torch.workflow.persistence import (
        dumps_models,
        loads_models,
    )

    U, V = uv
    user_ids = {f"u{n}": n for n in range(N_USERS)}
    item_ids = {f"i{n}": n for n in range(N_ITEMS)}
    t0 = time.perf_counter()
    blob = jax_layout_blob([JaxALSModel(
        U, V, N_USERS, N_ITEMS, JaxBiMap(user_ids), JaxBiMap(item_ids),
        JaxALSParams(rank=RANK, num_iterations=TRAIN_ITERS))])
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (decoded,) = loads_models(blob)
    decode_s = time.perf_counter() - t0
    check(torch.equal(decoded.user_factors, torch.from_numpy(U))
          and torch.equal(decoded.item_factors, torch.from_numpy(V))
          and decoded.user_ids.to_dict() == user_ids,
          "the JAX-layout blob decoded to other factors or ids")

    work = Path(home) / "jaxblob"
    work.mkdir()
    marker = work / "marker"
    bad = pickle.dumps([_WritesAMarker(str(marker))], protocol=4)
    try:
        loads_models(bad)
        fail("a blob naming builtins.open was not refused")
    except ValueError as e:
        check("refused" in str(e), f"the refusal said: {e}")
    check(not marker.exists(), "the refused blob ran its reduce")

    variant = {
        "id": "jaxblob", "version": "1", "engineFactory": JAX_FACTORY,
        "datasource": {"params": {"app_name": PIO_APP}},
        "algorithms": [{"name": "als", "params": {
            "rank": RANK, "num_iterations": TRAIN_ITERS}}]}
    engine_json = work / "engine.json"
    engine_json.write_text(json.dumps(variant))
    storage = Storage(env={"PIO_HOME": home})
    try:
        iid = storage.engine_instances().insert(EngineInstance(
            id="", status=STATUS_COMPLETED, start_time=utcnow(),
            end_time=utcnow(), engine_id="jaxblob", engine_version="1",
            engine_variant=str(engine_json), engine_factory=JAX_FACTORY))
        storage.models().insert(Model(iid, blob))
        rng = np.random.default_rng(23)
        queries = [{"user": f"u{u}", "num": 10}
                   for u in rng.integers(0, N_USERS, JAXBLOB_QUERIES)]
        queries[0]["blackList"] = ["i1", "i2", "i3"]

        # -- the JAX blob's deploy, counted ------------------------------
        ft.LAUNCHES = 0
        args = cli._parser().parse_args([
            "deploy", "--engine-json", str(engine_json), "--ip",
            "127.0.0.1", "--port", "0", "--batching"])
        t0 = time.perf_counter()
        srv = cli.build_deploy(args, storage).start_background()
        try:
            check(srv.query_server.warm_done.wait(WARM_TIMEOUT_S),
                  "the JAX-blob deploy never warmed")
            warm_s = time.perf_counter() - t0
            answers = [_post(srv.port, queries[0])[0]]
            first_s = time.perf_counter() - t0
            answers += [_post(srv.port, q)[0] for q in queries[1:]]
            status = _http(srv.port, "GET", "/status.json")[1]
        finally:
            srv.close()
        launches = ft.LAUNCHES
        # ------------------------------------------------------------------
        check(launches > 0, "the JAX-blob deploy launched fused_topk no "
              "time")
        check(status["engineInstanceId"] == iid,
              f"deploy bound {status['engineInstanceId']}, not {iid}")
    finally:
        storage.close()
    engine, ep = cli.engine_from_variant(variant)
    (own,) = loads_models(dumps_models([als_model_from_numpy(
        U, V, N_USERS, N_ITEMS, user_ids, item_ids,
        {"rank": RANK, "num_iterations": TRAIN_ITERS}, device="cpu")]))
    ref_srv = deploy_models(engine, ep, [own], ServerConfig(batching=True),
                            host="127.0.0.1", port=0).start_background()
    try:
        warmed(ref_srv)
        refs = [_post(ref_srv.port, q)[0] for q in queries]
    finally:
        ref_srv.close()
    rtol = RTOL["f32"]
    for q, got, want in zip(queries, answers, refs):
        g = got["itemScores"]
        w = want["itemScores"]
        check([x["item"] for x in g] == [x["item"] for x in w] and all(
            abs(a["score"] - b["score"]) <= rtol * (1 + abs(b["score"]))
            for a, b in zip(g, w)),
            f"user {q['user']}: the JAX blob answered {g[:3]}..., the "
            f"port's blob {w[:3]}...")
    print(f"phase jaxblob: a {len(blob)}-byte JAX-layout ALSModel blob "
          f"({N_USERS} x {N_ITEMS}, rank {RANK}) written in {write_s:.3f}s "
          f"by the stand-in pickler, decoded by the port's reader in "
          f"{decode_s:.3f}s | cli deploy (factory {JAX_FACTORY}): "
          f"servingWarm at {warm_s:.3f}s, first answer at {first_s:.3f}s | "
          f"{len(queries)} answers, top-k ids equal to the port's own "
          f"blob's and scores within {rtol} | fused_topk launches="
          f"{launches} | a blob naming builtins.open refused, its marker "
          f"never written | {card_tag(card)}", flush=True)
    return {"fused_topk": launches}


ROOT = Path(__file__).resolve().parent
#: phase fleet: the fresh process's replicas, the autoscaler's bounds, the
#: one-shot router fault, the spec file (its 150 ms latency spec), the
#: in-process latency fault and the longest wait for a fleet state
FLEET_REPLICAS, FLEET_MIN, FLEET_MAX = 3, 2, 4
FLEET_FAULT = "router.forward=error,times=1"
FLEET_SPECS = str(ROOT / "slo" / "specs" / "ci.json")
FLEET_BURN_DELAY_MS = 400.0
FLEET_TIMEOUT_S = 300.0


def fleet_f64_check(tag: str, queries, answers, U64, V64, dev) -> None:
    """Every answer (num 10) against the float64 top-10 of its user over
    the model's factors: each returned item's own float64 score is the
    score returned beside it, and the ten are the top ten (scores within
    1e-5 * (1 + |s|), so an id may differ only inside a near-tie)."""
    check(all(len(a["itemScores"]) == 10 for a in answers),
          f"{tag}: an answer has not 10 items")
    for lo in range(0, len(queries), 512):
        qs, ans = queries[lo:lo + 512], answers[lo:lo + 512]
        users = torch.tensor([int(q["user"][1:]) for q in qs], device=dev)
        scores = U64[users] @ V64.T
        want = torch.topk(scores, 10, dim=1).values
        got_i = torch.tensor([[int(s["item"][1:]) for s in a["itemScores"]]
                              for a in ans], device=dev)
        got_s = torch.tensor([[s["score"] for s in a["itemScores"]]
                              for a in ans], dtype=torch.float64,
                             device=dev)
        own = scores.gather(1, got_i)
        tol = RTOL["f32"] * (1 + want.abs())
        check(bool(((own - got_s).abs() <= tol).all()),
              f"{tag}: an item does not score what was returned")
        check(bool(((own - want).abs() <= tol).all()),
              f"{tag}: an answer is not its user's float64 top-10")
        srt = torch.sort(got_i, dim=1).values
        check(bool((srt[:, 1:] != srt[:, :-1]).all()),
              f"{tag}: an item appears twice in one answer")


def burst_stats(wall: float, results) -> tuple:
    """``(qps, p50 ms, p99 ms)`` of a burst."""
    lat = np.array([r[1] for r in results]) * 1000.0
    return (len(results) / wall, float(np.percentile(lat, 50)),
            float(np.percentile(lat, 99)))


def _children(metrics: dict, family: str) -> list:
    return (metrics.get(family) or {}).get("children") or []


def queries_served(metrics: dict) -> tuple:
    """``(/queries.json requests, of which 5xx, query-latency
    observations)`` of a ``/metrics.json`` body."""
    reqs = [c for c in _children(metrics, "pio_http_requests_total")
            if c["labels"].get("route") == "/queries.json"]
    total = sum(c["value"] for c in reqs)
    failed = sum(c["value"] for c in reqs
                 if int(c["labels"].get("status", "0")) >= 500)
    observed = sum(c["count"] for c in
                   _children(metrics, "pio_query_latency_seconds"))
    return total, failed, observed


def fleet_snapshot(agg: int) -> dict:
    """One quiescent view of the fleet: a synchronous scrape, then
    ``/fleet.json``, ``/route.json``, the merged ``/metrics.json``, and
    each serving replica's own ``/metrics.json`` and ``/status.json``."""
    t0 = time.perf_counter()
    _http(agg, "POST", "/scrape")
    scrape_ms = (time.perf_counter() - t0) * 1000.0
    fleet = _http(agg, "GET", "/fleet.json")[1]
    route = _http(agg, "GET", "/route.json")[1]
    merged = _http(agg, "GET", "/metrics.json")[1]
    own = {}
    for r in fleet["replicas"]:
        port = int(r["url"].rsplit(":", 1)[1])
        own[r["replica"]] = (_http(port, "GET", "/metrics.json")[1],
                             _http(port, "GET", "/status.json")[1])
    counter = {}
    for fam in ("pio_router_retries_total", "pio_router_spill_total",
                "pio_router_requests_total"):
        for c in _children(merged, fam):
            key = (fam, c["labels"].get("replica"),
                   c["labels"].get("outcome"))
            counter[key] = counter.get(key, 0.0) + c["value"]
    return dict(fleet=fleet, route=route, merged=merged, own=own,
                counter=counter, scrape_ms=scrape_ms,
                members=sorted(b["replica"] for b in route["replicas"]
                               if b["state"] == "ready"),
                count={r["replica"]: r["requestCount"]
                       for r in fleet["replicas"]},
                launches=max(st["kernels"]["fused_topk"]["launches"]
                             for _, st in own.values()))


def fleet_ring_report(snap: dict) -> str:
    """Why a replica left the ring: ``/route.json``'s state of each
    replica (failures in a row, seconds of ejection left), the router's
    ejections and transport errors by replica, and the lifecycle's and
    the autoscaler's decisions."""
    states = "; ".join(
        f"{b['replica']} {b['state']} failures={b['consecutiveFailures']} "
        f"ejectedForSec={b['ejectedForSec']} inflight={b['inflight']} "
        f"requests={b['requests']}" for b in snap["route"]["replicas"])
    ejections = {c["labels"].get("replica"): c["value"] for c in
                 _children(snap["merged"], "pio_router_ejections_total")}
    errors = {r: v for (f, r, o), v in snap["counter"].items()
              if f == "pio_router_requests_total" and o != "ok"}
    auto = snap["fleet"].get("autoscale") or {}
    return (f"route.json: {states} | ejections {ejections} | requests "
            f"not ok {errors} | lifecycle {auto.get('lifecycle')} "
            f"{json.dumps(auto.get('replicas'))} removed "
            f"{auto.get('removed')} | autoscaler decisions "
            f"{json.dumps(auto.get('decisions'))}")


def counter_sum(snap: dict, fam: str, outcome=None) -> float:
    return sum(v for (f, _, o), v in snap["counter"].items()
               if f == fam and (outcome is None or o == outcome))


def fleet_routed_burst(tag, agg, router, queries, U64, V64, dev,
                       card) -> dict:
    """One burst through the router with the membership held still:
    every answer held to float64; each replica's count (its
    ``/status.json`` through ``/fleet.json``) equal to the answers routed
    to it, and to the users ``HashRing.assign`` gives it less the ones
    placed elsewhere (spilled hot keys, the retried query) plus the ones
    placed on it; the merged query counters equal the sum over the
    replicas' own; no 5xx; the fused_topk counter grew."""
    from predictionio_tpu_torch.router import HashRing, RouterConfig

    fanout = RouterConfig().spill_fanout  # what deploy --fleet-of runs
    before = fleet_snapshot(agg)
    wall, res = finish_burst(start_burst(
        router, queries, keep=("X-Routed-To", "X-Routed-Retry")), tag)
    after = fleet_snapshot(agg)
    check(before["members"] == after["members"],
          f"{tag}: the ring changed during the burst "
          f"({before['members']} -> {after['members']}) | "
          f"{fleet_ring_report(after)}")
    fleet_f64_check(tag, queries, [r[0] for r in res], U64, V64, dev)
    ring = HashRing(before["members"])
    routed = [r[3] for r in res]
    retried = [r[4] is not None for r in res]
    users = [q["user"] for q in queries]
    assigned = {m: 0 for m in ring.members()}
    moved_in = {m: 0 for m in ring.members()}
    moved_out = {m: 0 for m in ring.members()}
    spilled = 0
    for user, to, retry in zip(users, routed, retried):
        home = ring.assign(user)
        assigned[home] += 1
        if to != home:
            moved_out[home] += 1
            moved_in[to] += 1
            if retry:
                check(to == ring.preference(user, 2)[1],
                      f"{tag}: user {user} retried off the ring order")
            else:
                spilled += 1
                check(to in ring.preference(user, fanout),
                      f"{tag}: user {user} placed on {to}, outside its "
                      f"spill set")
    spill_d = (counter_sum(after, "pio_router_spill_total")
               - counter_sum(before, "pio_router_spill_total"))
    retries_d = (counter_sum(after, "pio_router_retries_total")
                 - counter_sum(before, "pio_router_retries_total"))
    check(spilled <= spill_d, f"{tag}: {spilled} queries off their "
          f"replica but the router counted {spill_d} spills")
    check(retries_d == sum(retried), f"{tag}: {sum(retried)} answers "
          f"say retried, the router counted {retries_d} retries")
    for m in ring.members():
        got = after["count"][m] - before["count"][m]
        check(got == routed.count(m) == assigned[m] - moved_out[m]
              + moved_in[m], f"{tag}: replica {m} served {got}, "
              f"{routed.count(m)} answers name it, the ring gives it "
              f"{assigned[m]} -{moved_out[m]} +{moved_in[m]}")
    merged = [a - b for a, b in zip(queries_served(after["merged"]),
                                    queries_served(before["merged"]))]
    own = [sum(queries_served(after["own"][m][0])[i]
               - queries_served(before["own"][m][0])[i]
               for m in ring.members()) for i in range(3)]
    # the router's own HTTP series share the aggregator's registry and
    # the merged series' names: each routed query is counted once by its
    # replica and once by the router in pio_http_requests_total
    check(own == [len(queries), 0, len(queries)]
          and merged == [2 * len(queries), 0, len(queries)],
          f"{tag}: merged (requests, 5xx, latency count) {merged}, the "
          f"replicas' own sum {own}, {len(queries)} queries")
    launches = after["launches"] - before["launches"]
    check(launches > 0, f"{tag}: fused_topk launched no time")
    qps, p50, p99 = burst_stats(wall, res)
    print(f"phase fleet {tag}: {len(queries)} queries on {BURST_CLIENTS} "
          f"connections through the router to {len(ring)} replicas: "
          f"qps={qps:.1f} p50_ms={p50:.3f} p99_ms={p99:.3f} | per replica "
          f"(served / ring-assigned): "
          + ", ".join(f"{m}={after['count'][m] - before['count'][m]}/"
                      f"{assigned[m]}" for m in ring.members())
          + f" | spilled={spilled} (router spill count {spill_d:.0f}) "
          f"retries={retries_d:.0f} | merged latency count="
          f"{merged[2]:.0f} and 5xx={merged[1]:.0f} = the replicas' sum, "
          f"merged requests={merged[0]:.0f} = the replicas' "
          f"{own[0]:.0f} + the router's own | fused_topk launches="
          f"{launches} | all answers "
          f"held to float64 | scrape_ms={after['scrape_ms']:.3f} | "
          f"{card_tag(card)}", flush=True)
    return dict(qps=qps, p50=p50, p99=p99, launches=launches, after=after)


def fleet_cli(args: list, env: dict) -> str:
    """One ``python -m predictionio_tpu_torch.cli`` command; its stdout."""
    out = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cli {' '.join(args)} exit "
          f"{out.returncode}: {out.stderr[-500:]}")
    return out.stdout


def wait_until(cond, what: str, timeout: float = FLEET_TIMEOUT_S,
               every: float = 0.05):
    """Poll ``cond`` until it returns something true; fails after
    ``timeout`` seconds naming ``what``."""
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(every)


def fleet_process_phase(U64, V64, dev, home: str, engine_json: Path,
                        card: dict) -> dict:
    """(a): ``cli deploy --fleet-of 3 --autoscale`` in a fresh process,
    as a user runs it, with a one-shot router fault armed. ``fleet scale
    --to 4`` comes before the bursts: at the autoscaler's ceiling the
    ring holds still through them (on a 32-connection burst the spec
    file's 150 ms latency spec can burn, and below the ceiling the
    autoscaler would add a replica in the middle of a burst)."""
    work = Path(home) / "fleet"
    work.mkdir(exist_ok=True)
    env = dict(os.environ, PIO_HOME=home, PTPU_FAULTS=FLEET_FAULT)
    device = [] if dev.type == "cuda" else ["--device", "cpu"]
    out_log, err_log = work / "deploy.out", work / "deploy.err"
    rng = np.random.default_rng(29)
    uniform = [{"user": f"u{u}", "num": 10}
               for u in rng.integers(0, N_USERS, BURST_QUERIES)]
    zipf = [{"user": f"u{u}", "num": 10}
            for u in (rng.zipf(CACHE_ZIPF, BURST_QUERIES) - 1) % N_USERS]
    drain_q = [{"user": f"u{u}", "num": 10}
               for u in rng.integers(0, N_USERS, BURST_QUERIES)]
    t0 = time.perf_counter()
    with open(out_log, "w") as out, open(err_log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli", "deploy",
             "--engine-json", str(engine_json), "--ip", "127.0.0.1",
             "--port", "0", "--fleet-of", str(FLEET_REPLICAS),
             "--fleet-port", "0", "--router-port", "0", "--batching",
             "--autoscale", "--min-replicas", str(FLEET_MIN),
             "--max-replicas", str(FLEET_MAX), "--slo-specs", FLEET_SPECS,
             *device],
            cwd=ROOT, env=env, stdout=out, stderr=err)
    try:
        def ports():
            check(proc.poll() is None, f"the fleet deploy exited "
                  f"{proc.returncode}: {err_log.read_text()[-1500:]}")
            found = dict(re.findall(r"(Query router|Fleet aggregator) "
                                    r"live at http://127\.0\.0\.1:(\d+)",
                                    out_log.read_text()))
            return found if len(found) == 2 else None

        found = wait_until(ports, "the fleet's router and aggregator")
        router = int(found["Query router"])
        agg = int(found["Fleet aggregator"])

        def warm():
            _http(agg, "POST", "/scrape")
            fj = _http(agg, "GET", "/fleet.json")[1]
            return fj if fj["replicasUp"] == FLEET_REPLICAS and all(
                r["servingWarm"] for r in fj["replicas"]) else None

        fj = wait_until(warm, "3 warm replicas", every=0.2)
        ready_s = time.perf_counter() - t0
        check(fj["kneeQps"] is None and fj["capacityHeadroom"] == -1.0,
              "the fleet found a capacity knee: none may apply on the card")
        check("knee model ABSENT" in out_log.read_text(),
              "the deploy did not report the knee model absent")

        # scale out: the new replica warms (its ladder launches
        # fused_topk) before it joins the ring and before its first query
        before = fleet_snapshot(agg)
        check(len(before["members"]) == FLEET_REPLICAS,
              f"the ring before any traffic: {before['members']}")
        t1 = time.perf_counter()
        fleet_cli(["fleet", "scale", "--to", str(FLEET_MAX), "--port",
                   str(agg), "--reason", "chip smoke scale-out"], env)

        def joined():
            route = _http(agg, "GET", "/route.json")[1]
            names = [b["replica"] for b in route["replicas"]
                     if b["state"] == "ready"]
            return names if len(names) == FLEET_MAX else None

        names = wait_until(joined, "the 4th replica in the ring")
        scale_out_s = time.perf_counter() - t1
        (new,) = set(names) - set(before["members"])
        st = _http(int(new.rsplit(":", 1)[1]), "GET", "/status.json")[1]
        ladder = st["warmReport"]["launches"]["fused_topk"]
        grew = st["kernels"]["fused_topk"]["launches"] - before["launches"]
        check(st["servingWarm"] and st["requestCount"] == 0,
              f"the new replica joined unwarmed or already served "
              f"({st['servingWarm']}, {st['requestCount']})")
        check(0 < ladder <= grew, f"the new replica's warm-up launched "
              f"fused_topk {ladder} times ({grew} in the process) before "
              f"it joined the ring")
        print(f"phase fleet scale-out: fleet scale --to {FLEET_MAX} put "
              f"{new} in the ring in {scale_out_s:.3f}s; its warm-up "
              f"(seconds {json.dumps(st['warmReport']['seconds'])}, "
              f"artifactWarm={st['artifactWarm']}) launched fused_topk "
              f"{ladder} times before it joined, and it had served 0 "
              f"queries | {card_tag(card)}", flush=True)

        rows = {}
        rows["uniform"] = fleet_routed_burst(
            "uniform burst", agg, router, uniform, U64, V64, dev, card)
        first = rows["uniform"]["after"]
        check(first["count"][new] > 0, "the new replica served nothing")
        check(counter_sum(first, "pio_router_retries_total") == 1.0
              and counter_sum(first, "pio_router_requests_total",
                              "transport_error") == 1.0,
              "the armed router.forward fault did not make exactly one "
              "retry")
        injected = sum(
            c["value"] for c in _children(first["merged"],
                                          "pio_fault_injections_total")
            if c["labels"].get("point") == "router.forward")
        check(injected == FLEET_REPLICAS + 1, f"the replicas' fault "
              f"families counted {injected} router.forward injections, "
              f"not one each")
        rows["zipf"] = fleet_routed_burst(
            f"zipf({CACHE_ZIPF}) burst", agg, router, zipf, U64, V64, dev,
            card)
        second = rows["zipf"]["after"]
        check(counter_sum(second, "pio_router_spill_total") > 0,
              "the Zipf burst spilled no hot key")
        check(counter_sum(second, "pio_router_retries_total") == 1.0,
              "a retry beyond the one fault: a replica failed")
        # one replica alone, the same uniform burst without the router
        alone = first["fleet"]["replicas"][0]
        wall, res = finish_burst(start_burst(
            int(alone["url"].rsplit(":", 1)[1]), uniform), "one replica")
        fleet_f64_check("one replica", uniform, [r[0] for r in res], U64,
                        V64, dev)
        a_qps, a_p50, a_p99 = burst_stats(wall, res)
        u = rows["uniform"]
        print(f"phase fleet router vs one replica (uniform burst, "
              f"{BURST_CLIENTS} connections): router to {FLEET_MAX} "
              f"replicas qps={u['qps']:.1f} p50_ms={u['p50']:.3f} "
              f"p99_ms={u['p99']:.3f} | replica {alone['replica']} alone "
              f"qps={a_qps:.1f} p50_ms={a_p50:.3f} p99_ms={a_p99:.3f} | "
              f"{card_tag(card)}", flush=True)

        # scale in during a burst: the drained replicas finish what they
        # hold; no query is lost or fails
        before = fleet_snapshot(agg)
        proc_b = start_burst(router, drain_q)
        time.sleep(0.3)
        t2 = time.perf_counter()
        fleet_cli(["fleet", "scale", "--to", str(FLEET_MIN), "--port",
                   str(agg), "--reason", "chip smoke scale-in"], env)

        def drained():
            fj = _http(agg, "GET", "/fleet.json")[1]
            lc = fj["autoscale"]["lifecycle"]
            return fj if lc["ready"] == FLEET_MIN and not lc["draining"] \
                else None

        fj = wait_until(drained, "the drain to 2 replicas")
        drain_s = time.perf_counter() - t2
        wall, res = finish_burst(proc_b, "burst during the drain")
        fleet_f64_check("burst during the drain", drain_q,
                        [r[0] for r in res], U64, V64, dev)
        after = fleet_snapshot(agg)
        # a replica leaves the scrape set when it stops, so what it served
        # after its last scrape never reaches the merged series (as in the
        # JAX package): the router's own count is the whole burst's
        merged = [a - b for a, b in zip(queries_served(after["merged"]),
                                        queries_served(before["merged"]))]
        routed_ok = (counter_sum(after, "pio_router_requests_total", "ok")
                     - counter_sum(before, "pio_router_requests_total",
                                   "ok"))
        check(routed_ok == len(drain_q) and merged[1] == 0,
              f"the drain burst: the router answered {routed_ok} of "
              f"{len(drain_q)}, merged 5xx {merged[1]}")
        removed = fj["autoscale"]["removed"]
        check(len(removed) == FLEET_MAX - FLEET_MIN,
              f"removed {removed}, not {FLEET_MAX - FLEET_MIN} replicas")
        d_qps, d_p50, d_p99 = burst_stats(wall, res)
        decisions = [(d["action"], d["reason"])
                     for d in fj["autoscale"]["decisions"]]
        print(f"phase fleet drain: fleet scale --to {FLEET_MIN} during a "
              f"burst of {len(drain_q)}: {len(removed)} replicas drained "
              f"and stopped in {drain_s:.3f}s, 0 errors, every answer held "
              f"to float64, the merged latency count grew by "
              f"{merged[2]:.0f} of {len(drain_q)} (the departed replicas' "
              f"last interval is never scraped) (burst qps={d_qps:.1f} "
              f"p50_ms={d_p50:.3f} "
              f"p99_ms={d_p99:.3f}) | decisions {decisions} | "
              f"{card_tag(card)}", flush=True)
        slo = _http(agg, "GET", "/slo.json")[1]
        launches = after["launches"]
        scrape = _children(after["merged"], "pio_fleet_scrape_seconds")
        scrape_ms = (1000.0 * sum(c["sum"] for c in scrape)
                     / max(1, sum(c["count"] for c in scrape)))
        check(_http(agg, "POST", "/stop")[1] == {"stopping": True},
              "POST /stop refused")
        try:
            rc = proc.wait(120)
        except subprocess.TimeoutExpired:
            rc = None
        check(rc == 0, f"the fleet deploy exited {rc} after POST /stop: "
              f"{err_log.read_text()[-1500:]}")
        print(f"phase fleet process: deploy --fleet-of {FLEET_REPLICAS} "
              f"warm in {ready_s:.3f}s, exit 0 after POST /stop | fleet "
              f"SLO {[(s['name'], s['state'], s['violations']) for s in slo['specs']]} "
              f"| one replica scrape + merge mean ms={scrape_ms:.3f}, a "
              f"synchronous POST /scrape of {FLEET_MIN} replicas "
              f"ms={after['scrape_ms']:.3f} | fused_topk launches in the "
              f"process={launches} | {card_tag(card)}", flush=True)
        return dict(launches=launches, rows=rows)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def fleet_autoscale_phase(U64, V64, dev, home: str, engine_json: Path,
                          card: dict) -> int:
    """(b): an in-process fleet of 2 with the autoscaler and the spec
    file's 150 ms latency spec; a 400 ms dispatch latency lights the
    fast burn, the autoscaler adds a third replica (the decision logged
    and traced); the fault cleared, the burn goes out."""
    from predictionio_tpu_torch import cli, faults
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.obs import Tracer
    from predictionio_tpu_torch.ops import fused_topk as ft

    storage = Storage(env={"PIO_HOME": home})
    args = cli._parser().parse_args([
        "deploy", "--engine-json", str(engine_json), "--ip", "127.0.0.1",
        "--port", "0", "--fleet-of", "2", "--fleet-port", "0",
        "--router-port", "0", "--fleet-scrape-interval-ms", "500",
        "--batching", "--autoscale", "--min-replicas", "2",
        "--max-replicas", "3", "--slo-specs", FLEET_SPECS,
        *([] if dev.type == "cuda" else ["--device", "cpu"])])
    tracer = Tracer(ring=64)
    ft.LAUNCHES = 0
    fleet = cli.build_fleet_deploy(args, storage, tracer=tracer)
    stop, codes, sent = threading.Event(), [], []
    rng = np.random.default_rng(31)
    users = [int(u) for u in rng.integers(0, N_USERS, 4096)]

    def client(k: int) -> None:
        i = k
        while not stop.is_set():
            q = {"user": f"u{users[i % len(users)]}", "num": 10}
            try:
                ans, _ = _post(fleet.router_server.port, q)
                codes.append(200)
                sent.append((q, ans))
            except Exception as e:  # noqa: BLE001 — counted, checked below
                codes.append(repr(e))
            i += 4

    clients = [threading.Thread(target=client, args=(k,), name=f"fc{k}")
               for k in range(4)]
    try:
        fleet.server.start_background()
        for srv in fleet.replicas:
            warmed(srv)
        for t in clients:
            t.start()
        time.sleep(4.0)  # the spec's windows see healthy traffic first
        t0 = time.perf_counter()
        faults.inject("serving.dispatch", mode="latency",
                      delay_ms=FLEET_BURN_DELAY_MS)
        wait_until(lambda: fleet.agg.slo.fast_burning(),
                   "the fleet's fast burn", timeout=120)
        breach_s = time.perf_counter() - t0

        def decided():
            return [d for d in fleet.autoscaler.status()["decisions"]
                    if d["action"] == "scale_out"]

        (decision, *_) = wait_until(decided, "a scale-out decision",
                                    timeout=120)
        decided_s = time.perf_counter() - t0
        wait_until(lambda: fleet.lifecycle.count("ready") == 3,
                   "a third ready replica", timeout=FLEET_TIMEOUT_S)
        ready_s = time.perf_counter() - t0
        check("fast burn" in decision["reason"],
              f"the scale-out's reason: {decision['reason']}")
        kept = tracer.recorder.get(decision.get("traceId") or "")
        check(kept is not None and kept.retained_reason == "autoscale",
              "the scale-out decision's trace was not kept under "
              "reason autoscale")
        faults.clear()
        t1 = time.perf_counter()
        wait_until(lambda: not fleet.agg.slo.fast_burning(),
                   "the burn to go out", timeout=120)
        out_s = time.perf_counter() - t1
        time.sleep(0.5)
    finally:
        faults.clear()
        stop.set()
        for t in clients:
            t.join(60)
        fleet.close()
        storage.close()
    launches = ft.LAUNCHES
    bad = [c for c in codes if c != 200]
    check(not bad, f"{len(bad)} queries failed during the autoscale: "
          f"{bad[:3]}")
    check(len(sent) > 0, "no query went through the router")
    fleet_f64_check("autoscale traffic", [q for q, _ in sent],
                    [a for _, a in sent], U64, V64, dev)
    check(launches > 0, "the autoscaled fleet launched fused_topk no time")
    print(f"phase fleet autoscale: serving.dispatch latency "
          f"{FLEET_BURN_DELAY_MS:.0f} ms injected -> fleet fast burn at "
          f"{breach_s:.3f}s -> scale_out decision at {decided_s:.3f}s "
          f"(reason '{decision['reason']}', traced under autoscale) -> a "
          f"third replica ready at {ready_s:.3f}s; the fault cleared, the "
          f"burn out after {out_s:.3f}s | {len(sent)} queries, 0 "
          f"errors, held to float64 | fused_topk launches={launches} | "
          f"{card_tag(card)}", flush=True)
    return launches


def fleet_slo_cost(uv, U64, V64, dev, card: dict) -> None:
    """The SLO engine's cost: the uniform burst on one engine server
    with the default engine (a 1 s tick) and with ``slo_interval_ms=0``,
    in turns (on, off, on, off)."""
    from predictionio_tpu_torch.models.convert import als_model_from_numpy
    from predictionio_tpu_torch.server.engineserver import (
        ServerConfig,
        deploy_models,
    )
    from predictionio_tpu_torch.templates.recommendation import (
        recommendation_engine,
    )

    U, V = uv
    engine = recommendation_engine()
    ep = engine.params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": RANK}}]})
    model = als_model_from_numpy(
        U, V, N_USERS, N_ITEMS, {f"u{n}": n for n in range(N_USERS)},
        {f"i{n}": n for n in range(N_ITEMS)}, {"rank": RANK}, device=dev)
    rng = np.random.default_rng(37)
    queries = [{"user": f"u{u}", "num": 10}
               for u in rng.integers(0, N_USERS, BURST_QUERIES)]
    rows = []
    for slo_ms in (1000.0, 0.0, 1000.0, 0.0):
        srv = deploy_models(engine, ep, [model], ServerConfig(
            batching=True, slo_interval_ms=slo_ms), "127.0.0.1",
            0).start_background()
        try:
            warmed(srv)
            check((srv.query_server.slo is None) == (slo_ms == 0),
                  "slo_interval_ms did not switch the engine")
            wall, res = finish_burst(start_burst(srv.port, queries),
                                     "slo cost burst")
        finally:
            srv.close()
        fleet_f64_check("slo cost burst", queries, [r[0] for r in res],
                        U64, V64, dev)
        rows.append((slo_ms, *burst_stats(wall, res)))
    print("phase fleet SLO tick cost, staged burst of "
          f"{BURST_QUERIES} on {BURST_CLIENTS} connections, in turns: "
          + ", ".join(f"slo_interval_ms={ms:.0f} qps={q:.1f} "
                      f"p50_ms={p50:.3f} p99_ms={p99:.3f}"
                      for ms, q, p50, p99 in rows)
          + f" | {card_tag(card)}", flush=True)


def phase_fleet(uv, dev, home: str, card: dict) -> dict:
    """``deploy --fleet-of N`` on phase 16's store and model: (a) a fresh
    process behind its router and aggregator, (b) the autoscaler in
    process, and the SLO engine's cost."""
    U, V = uv
    U64 = torch.from_numpy(U).to(dev, torch.float64)
    V64 = torch.from_numpy(V).to(dev, torch.float64)
    engine_json = Path(home) / "jaxblob" / "engine.json"
    check(engine_json.is_file(), "phase jaxblob's variant is missing")
    a = fleet_process_phase(U64, V64, dev, home, engine_json, card)
    b = fleet_autoscale_phase(U64, V64, dev, home, engine_json, card)
    fleet_slo_cost(uv, U64, V64, dev, card)
    return {"fused_topk": a["launches"] + b}


# ---------------------------------------------------------------------------
# phase mesh: sharded and replicated serving on the card
# ---------------------------------------------------------------------------

#: devices the phase's meshes and lane servers get on the one card
#: (PTPU_TORCH_FORCE_DEVICE_COUNT), the k of its rankings, the answers
#: held to float64, and the longest wait for a lane or stream state
MESH_DEVICES, MESH_K, MESH_F64 = 4, 16, 64
MESH_TIMEOUT_S = 300.0
#: the drill: lane 1 fails 3 dispatches (the default lane_fail_threshold),
#: then its first 3 restart probes, so it stays dead ~0.7 s before the
#: 4th probe (~1.5 s after its death) brings it back
MESH_LANE_FAULT = ("serving.lane=error,lane=1,times=3;"
                   "serving.lane_restart=error,lane=1,times=3")
#: the sharded stream's burst: users, their events, the consumer (16
#: users: each one's history read scans the `pio` store, ~0.48 s a user
#: on the card's host, PR 19 run C)
#: the sharded stream pass: 4 users of 8 events (the pass is its users'
#: history reads)
MESH_STREAM_USERS, MESH_STREAM_EVENTS = 4, 8
MESH_CONSUMER = "chip-mesh"
#: the pinned-lanes check: hot users pinned, and the ks served
MESH_PIN_USERS = 256
#: a folded row against the single-device fold-in's (the same kernels
#: on the same rows: expected bitwise)
MESH_FOLD_RTOL, MESH_FOLD_ATOL = 1e-4, 1e-5
#: the drill process: ``cli.main(["deploy", ...])``, then a census of
#: the threads still alive after the server closed
MESH_DEPLOY_MAIN = """\
import sys, threading, time
from predictionio_tpu_torch import cli
rc = cli.main(sys.argv[1:])
deadline = time.monotonic() + 10
while time.monotonic() < deadline:
    left = [t.name for t in threading.enumerate()
            if t is not threading.main_thread()]
    if not left:
        break
    time.sleep(0.05)
print("THREADS LEFT", left, flush=True)
sys.exit(rc if not left else 3)
"""


def mesh_sharded_ranking(uv, dev, card) -> int:
    """``shard_model`` over 4 shards of one card for each table dtype, at
    B = 2048 and B = 1: ids equal to the single-table answer, scores
    within the wire's tolerance (bitwise expected), ``fused_topk``
    launches = shards x batches, 64 answers held to float64, and each
    shard's launch timed beside one whole-table launch."""
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.models.convert import als_model_from_numpy
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.parallel import make_serving_mesh
    from predictionio_tpu_torch.parallel.collectives import (
        record_collectives,
    )

    U, V = uv
    mesh = make_serving_mesh(devices=[dev] * MESH_DEVICES)
    base = als_model_from_numpy(U, V, N_USERS, N_ITEMS, None, None,
                                {"rank": RANK}, device="cpu")
    rng = np.random.default_rng(41)
    users = rng.integers(0, N_USERS, BATCH)
    launches = 0
    for wire, quant in (("f32", "off"), ("bf16", "bf16"), ("int8", "int8")):
        # the quantization is forced (the NDCG gate refuses int8 for
        # these factors): the phase exercises every table type
        q = als.quantize_serving_model(base, quant, parity_floor=0) \
            if quant != "off" else base
        single = als.place_model(q, dev)
        ms = als.shard_model(single, mesh)
        n_local = ms.item_factors.n_local
        for B in (BATCH, 1):
            rows = users[:B]
            want_i, want_s = als.recommend_batch(single, rows, MESH_K)
            ft.LAUNCHES = 0
            with record_collectives() as rec:
                got_i, got_s = als.recommend_batch(ms, rows, MESH_K)
            n = ft.LAUNCHES
            launches += n
            census = rec.shapes()
            check(rec.counts() == {"all-gather": 2},
                  f"mesh {wire} B={B}: collectives {census}, not the "
                  f"merge's two all-gathers")
            check(n == MESH_DEVICES,
                  f"mesh {wire} B={B}: fused_topk launched {n} times, not "
                  f"{MESH_DEVICES} shards x 1 batch")
            check(np.array_equal(got_i, want_i),
                  f"mesh {wire} B={B}: sharded ids differ from the single "
                  f"table's")
            err = float(np.abs(got_s - want_s).max())
            tol = RTOL[wire] * (1 + np.abs(want_s))
            check(bool((np.abs(got_s - want_s) <= tol).all()),
                  f"mesh {wire} B={B}: sharded scores off by {err:.3e}")
            print(f"phase mesh: sharded {wire} B={B} k={MESH_K}: ids equal "
                  f"to the single table's, scores "
                  f"{'bitwise' if err == 0 else f'max abs err {err:.3e}'}, "
                  f"fused_topk launches={n} ({MESH_DEVICES} shards of "
                  f"{n_local} rows), collectives recorded {census}",
                  flush=True)
        # 64 answers against float64 over the dequantized tables
        U64 = torch.from_numpy(als.table_host_f32(single.user_factors)).to(
            dev, torch.float64)
        V64 = torch.from_numpy(als.table_host_f32(single.item_factors)).to(
            dev, torch.float64)
        rows = users[:MESH_F64]
        got_i, got_s = als.recommend_batch(ms, rows, MESH_K)
        gi = torch.from_numpy(got_i).to(dev)
        gs = torch.from_numpy(got_s).to(dev, torch.float64)
        scores = U64[torch.from_numpy(rows).to(dev)] @ V64[:N_ITEMS].T
        want = torch.topk(scores, MESH_K, dim=1).values
        own = scores.gather(1, gi)
        tol = RTOL[wire] * (1 + want.abs())
        check(bool(((own - gs).abs() <= tol).all()),
              f"mesh {wire}: a sharded id does not score what was returned")
        check(bool(((own - want).abs() <= tol).all()),
              f"mesh {wire}: a sharded answer is not its user's float64 "
              f"top-{MESH_K}")
        # one shard's launch beside the whole table's, at B = 2048
        vecs, vsc = als._user_vecs(single.user_factors, users, dev)
        ar = torch.arange(BATCH, dtype=torch.int32, device=dev)
        sd, ss = als._table_leaves(ms.item_factors.shards[0])
        wd, ws = als._table_leaves(single.item_factors)
        shard_ms = median_ms(lambda: ft.fused_topk(
            vecs, ar, sd, vsc, ss, 0, k=MESH_K, n_items=N_ITEMS), 20)
        whole_ms = median_ms(lambda: ft.fused_topk(
            vecs, ar, wd, vsc, ws, 0, k=MESH_K, n_items=N_ITEMS), 20)
        sharded_ms = median_ms(lambda: als.recommend_batch(ms, users,
                                                           MESH_K), 5)
        print(f"phase mesh: {wire} fused_topk B={BATCH} k={MESH_K}: one "
              f"shard ({n_local} rows) {shard_ms:.4f} ms, the whole table "
              f"({N_ITEMS} rows) {whole_ms:.4f} ms, a sharded batch end to "
              f"end (gather, {MESH_DEVICES} launches, merge, readback) "
              f"{sharded_ms:.4f} ms; {MESH_F64} answers held to float64 | "
              f"{card_tag(card)}", flush=True)
    return launches


def mesh_status(port: int) -> dict:
    return _http(port, "GET", "/status.json")[1]


def mesh_lane_gauges(port: int) -> tuple:
    """``(pio_serving_degraded, pio_lane_restarts_total{lane="1"})`` of
    one ``/metrics`` scrape."""
    samples, _ = parse_exposition(scrape(port))
    restarts = samples.get("pio_lane_restarts_total", {})
    return (samples["pio_serving_degraded"][""],
            restarts.get('{lane="1"}', 0.0))


def mesh_deploy(tag: str, engine_json: Path, env: dict, work: Path,
                extra: list, census: bool = False):
    """A ``cli deploy`` process (with ``census``, run through
    :data:`MESH_DEPLOY_MAIN`); returns ``(process, its stdout path)``."""
    out_log = work / f"{tag}.out"
    args = ["deploy", "--engine-json", str(engine_json), "--ip",
            "127.0.0.1", "--port", "0", "--batching", *extra]
    cmd = ([sys.executable, "-c", MESH_DEPLOY_MAIN, *args] if census
           else [sys.executable, "-m", "predictionio_tpu_torch.cli", *args])
    with open(out_log, "w") as out, open(work / f"{tag}.err", "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                                stderr=err)
    return proc, out_log


def mesh_port(tag: str, proc, out_log: Path) -> int:
    def port():
        check(proc.poll() is None, f"mesh {tag} deploy exited "
              f"{proc.returncode}: "
              f"{out_log.with_suffix('.err').read_text()[-1500:]}")
        found = re.findall(r"is listening at http://127\.0\.0\.1:(\d+)",
                           out_log.read_text())
        return int(found[0]) if found else None

    p = wait_until(port, f"mesh {tag} deploy", timeout=MESH_TIMEOUT_S)
    wait_until(lambda: mesh_status(p)["servingWarm"], f"mesh {tag} warm",
               timeout=MESH_TIMEOUT_S, every=0.1)
    return p


def mesh_stop(tag: str, port: int, proc) -> None:
    try:
        _http(port, "POST", "/stop")
    except OSError:
        pass
    rc = end_process(proc)
    check(rc == 0, f"mesh {tag} deploy exited {rc}")


def mesh_lanes(uv, dev, home: str, card: dict) -> int:
    """``cli deploy --serving-mode replicated --batching`` with 4 lanes in
    a fresh process against a ``single`` deploy, a Zipf(1.5) burst of
    2,048 queries on 32 connections to each in turns; then the lane drill
    in a third process: lane 1 killed by ``serving.lane`` faults, failed
    over with 0 failed queries, ``pio_serving_degraded`` 1 while it is
    dead, restarted, and the process exits 0 with no thread left."""
    U, V = uv
    U64 = torch.from_numpy(U).to(dev, torch.float64)
    V64 = torch.from_numpy(V).to(dev, torch.float64)
    engine_json = Path(home) / "jaxblob" / "engine.json"
    check(engine_json.is_file(), "phase jaxblob's variant is missing")
    work = Path(home) / "mesh"
    work.mkdir(exist_ok=True)
    env = dict(os.environ, PIO_HOME=home,
               PTPU_TORCH_FORCE_DEVICE_COUNT=str(MESH_DEVICES))
    env.pop("PTPU_FAULTS", None)
    device = [] if dev.type == "cuda" else ["--device", "cpu"]
    rng = np.random.default_rng(43)
    burst = [{"user": f"u{u}", "num": 10}
             for u in (rng.zipf(CACHE_ZIPF, BURST_QUERIES) - 1) % N_USERS]
    procs = {
        "replicated": mesh_deploy("replicated", engine_json, env, work,
                                  ["--serving-mode", "replicated",
                                   *device]),
        "single": mesh_deploy("single", engine_json, env, work,
                              ["--serving-mode", "single", *device]),
        "drill": mesh_deploy("drill", engine_json,
                             dict(env, PTPU_FAULTS=MESH_LANE_FAULT), work,
                             ["--serving-mode", "replicated", *device],
                             census=True),
    }
    ports, launches = {}, 0
    try:
        for tag, (proc, out_log) in procs.items():
            ports[tag] = mesh_port(tag, proc, out_log)
        rep = mesh_status(ports["replicated"])
        check(rep["mesh"]["mode"] == "replicated"
              and len(rep["mesh"]["lanes"]) == MESH_DEVICES,
              f"the replicated deploy's mesh block: {rep['mesh']}")
        check(mesh_status(ports["single"])["mesh"] == {"mode": "single"},
              "the single deploy is not single")
        qps = {"replicated": [], "single": []}
        for turn in ("replicated", "single", "replicated", "single"):
            wall, res = run_burst(ports[turn], burst)
            qps[turn].append(burst_stats(wall, res))
            fleet_f64_check(f"mesh {turn} burst", burst,
                            [r[0] for r in res], U64, V64, dev)
        rep = mesh_status(ports["replicated"])
        lanes = rep["mesh"]["lanes"]
        check(all(lane["dispatches"] > 0 for lane in lanes),
              f"a lane dispatched nothing: "
              f"{[lane['dispatches'] for lane in lanes]}")
        # the lane processes' launches (warm-up ladders and bursts); the
        # single deploy is the comparison and does not count
        launches += rep["kernels"]["fused_topk"]["launches"]
        r_qps = [s[0] for s in qps["replicated"]]
        s_qps = [s[0] for s in qps["single"]]
        lat = {t: [(round(s[1], 3), round(s[2], 3)) for s in v]
               for t, v in qps.items()}
        print(f"phase mesh: lanes burst ({BURST_QUERIES} Zipf({CACHE_ZIPF}) "
              f"queries, {BURST_CLIENTS} connections), in turns: "
              f"{MESH_DEVICES} replicated lanes qps={r_qps} p50/p99 ms="
              f"{lat['replicated']} | single qps={s_qps} p50/p99 ms="
              f"{lat['single']} | lanes/single="
              f"{np.mean(r_qps) / np.mean(s_qps):.3f}x | "
              f"lane dispatches={[lane['dispatches'] for lane in lanes]} | "
              f"every answer held to float64 | {card_tag(card)}",
              flush=True)

        # -- the drill: lane 1 killed, failed over, degraded, restarted --
        port = ports["drill"]
        proc = start_burst(port, burst)
        seen_dead, t_dead, t_back = False, None, None
        deadline = time.monotonic() + MESH_TIMEOUT_S
        while time.monotonic() < deadline:
            degraded, restarts = mesh_lane_gauges(port)
            if degraded == 1.0 and not seen_dead:
                seen_dead, t_dead = True, time.monotonic()
                st = mesh_status(port)["degraded"]
                check([d["lane"] for d in st["deadLanes"]] == [1]
                      or st["laneRestarts"] == 1,
                      f"the drill's dead lanes: {st['deadLanes']}")
            if seen_dead and restarts == 1.0 and degraded == 0.0:
                t_back = time.monotonic()
                break
            if proc.poll() is not None and not seen_dead:
                break
            time.sleep(0.02)
        wall, res = finish_burst(proc, "mesh drill burst")
        check(seen_dead, "pio_serving_degraded never read 1 in the drill")
        if t_back is None:
            wait_until(lambda: mesh_lane_gauges(port) == (0.0, 1.0),
                       "lane 1's restart", timeout=MESH_TIMEOUT_S)
            t_back = time.monotonic()
        fleet_f64_check("mesh drill burst", burst, [r[0] for r in res],
                        U64, V64, dev)
        st = mesh_status(port)
        deg = st["degraded"]
        check(deg["laneRestarts"] == 1 and deg["deadLanes"] == []
              and deg["laneFailures"] == 3,
              f"the drill's degraded block: {deg}")
        # the rejoined lane serves again
        before = st["mesh"]["lanes"][1]["dispatches"]
        run_burst(port, burst[:512])
        after = mesh_status(port)["mesh"]["lanes"][1]["dispatches"]
        check(after > before, "lane 1 took no batch after its restart")
        errors = st["pipeline"]["deadlineExceeded"]
        launches += mesh_status(port)["kernels"]["fused_topk"]["launches"]
        print(f"phase mesh: lane drill ({MESH_LANE_FAULT}): lane 1 dead "
              f"~{(t_back - t_dead) * 1000:.0f} ms (pio_serving_degraded 1 "
              f"read, traffic on the survivors), restarted once, "
              f"laneFailures=3, 0 failed queries of {len(res)} (every "
              f"answer held to float64; deadlineExceeded={errors}), lane 1 "
              f"dispatches {before} -> {after} after rejoining", flush=True)
    finally:
        for tag, (proc, out_log) in procs.items():
            if tag in ports and proc.poll() is None:
                mesh_stop(tag, ports[tag], proc)
            elif proc.poll() is None:
                end_process(proc)
    census = (work / "drill.out").read_text()
    check(procs["drill"][0].returncode == 0
          and "THREADS LEFT []" in census,
          f"the drill deploy exited {procs['drill'][0].returncode} with "
          f"threads left: {census[-500:]}")
    print("phase mesh: every deploy process exited 0; the drill's left no "
          "thread (its restarter joined by close())", flush=True)
    return launches


def mesh_sharded_stream(uv, dev, home: str, card: dict) -> dict:
    """``deploy --serving-mode sharded --stream`` in process over 4
    shards, one fold-in burst of known users' ``rate`` events: the pass
    launches ``fused_gram`` and ``chol_solve``, and the served rows equal
    a single-device fold-in of the same events."""
    from predictionio_tpu_torch import cli
    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event, from_millis
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.models.convert import als_model_from_numpy
    from predictionio_tpu_torch.parallel import FORCE_DEVICE_COUNT_ENV
    from predictionio_tpu_torch.streaming import EventCursor, fold_in_events

    U, V = uv
    engine_json = Path(home) / "jaxblob" / "engine.json"
    storage = Storage(env={"PIO_HOME": home})
    prior = os.environ.get(FORCE_DEVICE_COUNT_ENV)
    os.environ[FORCE_DEVICE_COUNT_ENV] = str(MESH_DEVICES)
    srv = None
    try:
        app = storage.apps().get_by_name(PIO_APP)
        now_ms = int(time.time() * 1000)
        cur = EventCursor(storage, app.id, MESH_CONSUMER)
        cur.position = from_millis(now_ms)
        cur.save()
        args = cli._parser().parse_args([
            "deploy", "--engine-json", str(engine_json), "--ip",
            "127.0.0.1", "--port", "0", "--batching", "--serving-mode",
            "sharded", "--stream", "--stream-app", PIO_APP,
            "--stream-consumer", MESH_CONSUMER, "--stream-interval-ms",
            "50", "--stream-canary-probes", "0",
            *([] if dev.type == "cuda" else ["--device", "cpu"])])
        srv = cli.build_deploy(args, storage).start_background()
        warmed(srv)
        qs = srv.query_server
        check(qs.serving_mode_resolved == "sharded"
              and qs.serving_mesh.size == MESH_DEVICES,
              f"the stream deploy is {qs.serving_mode_resolved}")
        trainer = qs.stream
        base = qs.models[0]
        check(isinstance(base.item_factors, als.RowShardedTable),
              "the sharded deploy serves an unsharded table")
        rng = np.random.default_rng(47)
        users = rng.choice(N_USERS, MESH_STREAM_USERS, replace=False)
        events = [Event(event="rate", entity_type="user",
                        entity_id=f"u{u}", target_entity_type="item",
                        target_entity_id=f"i{int(i)}",
                        properties=DataMap({"rating": float(r)}),
                        event_time=from_millis(now_ms + 1 + n))
                  for n, (u, i, r) in enumerate(
                      (u, i, r) for u in users
                      for i, r in zip(rng.integers(0, N_ITEMS,
                                                   MESH_STREAM_EVENTS),
                                      rng.integers(1, 6,
                                                   MESH_STREAM_EVENTS)))]
        zero_launch_counts()
        t0 = time.perf_counter()
        storage.events().insert_batch(events, app.id)
        wait_until(lambda: trainer.events_consumed >= len(events)
                   and trainer.applies >= 1, "the sharded fold-in pass",
                   timeout=MESH_TIMEOUT_S, every=0.02)
        pass_s = time.perf_counter() - t0
        # the pass's launches; the reference fold-in below is a
        # comparison and does not count
        counts = launch_counts()
        check(counts["fused_gram"] > 0 and counts["chol_solve"] > 0,
              f"the sharded fold-in launched {counts}")
        check(trainer.rejects == 0, "the sharded fold-in was refused")
        served = qs.models[0]
        check(isinstance(served.user_factors, als.RowShardedTable),
              "the folded model is not sharded")
        single = als_model_from_numpy(
            U, V, N_USERS, N_ITEMS, {f"u{n}": n for n in range(N_USERS)},
            {f"i{n}": n for n in range(N_ITEMS)}, {"rank": RANK},
            device=dev)
        want, _ = fold_in_events(single, events, storage, app.id,
                                 weights=trainer.weights,
                                 max_history=trainer.config.max_history)
        got_rows = als.table_rows_f32(served.user_factors, users)
        want_rows = als.table_rows_f32(want.user_factors, users)
        err = float(np.abs(got_rows - want_rows).max())
        check(np.allclose(got_rows, want_rows, rtol=MESH_FOLD_RTOL,
                          atol=MESH_FOLD_ATOL),
              f"sharded folded rows off the single-device fold-in by "
              f"{err:.3e}")
        check(not np.array_equal(got_rows, als.table_rows_f32(
            base.user_factors, users)), "the fold-in changed no row")
        # the folded rows serve through the shards
        ans, _ = _post(srv.port, {"user": f"u{users[0]}", "num": 10})
        want_i, _ = als.recommend_products(want, int(users[0]), 10)
        check([s["item"] for s in ans["itemScores"]]
              == [f"i{i}" for i in want_i],
              "the sharded deploy does not serve the folded row")
        print(f"phase mesh: sharded stream ({MESH_DEVICES} shards): "
              f"{len(events)} events of {MESH_STREAM_USERS} users folded "
              f"in {pass_s:.3f}s, fused_gram={counts['fused_gram']} "
              f"chol_solve={counts['chol_solve']} "
              f"fused_topk={counts['fused_topk']} launches, folded rows "
              f"{'bitwise' if err == 0 else f'within {err:.3e}'} of a "
              f"single-device fold-in of the same events | "
              f"{card_tag(card)}", flush=True)
    finally:
        if srv is not None:
            srv.close()
        if prior is None:
            os.environ.pop(FORCE_DEVICE_COUNT_ENV, None)
        else:
            os.environ[FORCE_DEVICE_COUNT_ENV] = prior
        storage.close()
    return counts


def mesh_pinned_lanes(uv, dev, card: dict) -> int:
    """The hot tier under replicated lanes, in process: the pin lands on
    every lane device, and a pinned serve on every lane is bit-equal to
    that lane's full-table answer."""
    from predictionio_tpu_torch.models.convert import als_model_from_numpy
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.parallel import FORCE_DEVICE_COUNT_ENV
    from predictionio_tpu_torch.server.engineserver import (
        QueryServer,
        ServerConfig,
    )
    from predictionio_tpu_torch.templates.recommendation import (
        recommendation_engine,
    )

    U, V = uv
    model = als_model_from_numpy(
        U, V, N_USERS, N_ITEMS, {f"u{n}": n for n in range(N_USERS)},
        {f"i{n}": n for n in range(N_ITEMS)}, {"rank": RANK}, device=dev)
    engine = recommendation_engine()
    ep = engine.params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": RANK}}]})
    prior = os.environ.get(FORCE_DEVICE_COUNT_ENV)
    os.environ[FORCE_DEVICE_COUNT_ENV] = str(MESH_DEVICES)
    qs = None
    try:
        qs = QueryServer(engine, ep, [model], ServerConfig(
            device=None if dev.type == "cuda" else "cpu",
            serving_mode="replicated", serving_cache=True,
            hot_entities=MESH_PIN_USERS, hot_refresh_every=1 << 30,
            warm_start=False, slo_interval_ms=0))
        check(len(qs.lane_models) == MESH_DEVICES,
              "the pinned-lanes server has no lanes")
        hot = [f"u{n}" for n in range(0, N_USERS, N_USERS // MESH_PIN_USERS)
               ][:MESH_PIN_USERS]
        for u in hot:
            qs.cache.hot.record(u)
        qs.cache.hot.refresh(wait=True)
        algo = qs.algorithms[0]
        n, served = 0, 0
        for u in hot[:: max(1, len(hot) // 32)]:
            handle = qs.cache.hot.peek(u)
            check(handle is not None, f"{u} was not pinned")
            _, (tables, slot) = handle
            check(isinstance(tables, tuple)
                  and len(tables) == MESH_DEVICES,
                  "the pin did not land on every lane device")
            q = algo.query_class(user=u, num=MESH_K)
            for lane in qs.lane_models:
                n0 = ft.LAUNCHES
                got = algo.predict_pinned(lane[0], q, (tables, slot))
                n += ft.LAUNCHES - n0
                want = algo.predict(lane[0], q)
                check(got == want, f"{u}: a pinned serve on a lane is not "
                      f"its full-table answer")
                served += 1
        check(n == served, f"pinned lanes: {n} fused_topk launches for "
              f"{served} pinned serves")
        print(f"phase mesh: pinned lanes: {len(hot)} hot users pinned on "
              f"each of {MESH_DEVICES} lane devices; {served} pinned serves "
              f"(k={MESH_K}) bit-equal to the lanes' full-table answers, "
              f"fused_topk launches={n} | {card_tag(card)}", flush=True)
    finally:
        if qs is not None:
            qs.close()
        if prior is None:
            os.environ.pop(FORCE_DEVICE_COUNT_ENV, None)
        else:
            os.environ[FORCE_DEVICE_COUNT_ENV] = prior
    return n


def phase_mesh(uv, dev, home: str, card: dict) -> dict:
    """Mesh-wide serving at full width on phase fleet's factors, with 4
    devices on the one card: sharded ranking for every table type, 4
    replicated lanes against 1 in burst qps and the lane drill (fresh
    processes), a sharded deploy's stream fold-in, and pinned lanes."""
    a = mesh_sharded_ranking(uv, dev, card)
    b = mesh_lanes(uv, dev, home, card)
    c = mesh_sharded_stream(uv, dev, home, card)
    d = mesh_pinned_lanes(uv, dev, card)
    return {"fused_topk": a + b + c["fused_topk"] + d,
            "fused_gram": c["fused_gram"], "chol_solve": c["chol_solve"],
            "gram_table": c["gram_table"]}


# ---------------------------------------------------------------------------
# phase train-mesh: ALS over a mesh of shards and across processes
# ---------------------------------------------------------------------------

#: the in-process mesh's shards on the one card
MESH_TRAIN_SHARDS = 4
#: implicit iterations of part (a), and their tolerance against the one
#: card: |d| <= rtol * (1 + |one card's|)
MESH_IMPLICIT_ITERS = 1
MESH_IMPLICIT_RTOL = 1e-5
#: part (b)'s first launch (the resume adds 2) and its tolerance against
#: the in-process two-shard run: |d| <= atol + rtol * |in-process|
MESH_PROC_ITERS = 4
MESH_PROC_RTOL, MESH_PROC_ATOL = 1e-4, 1e-5
MESH_PROC_TIMEOUT_S = 600.0

#: part (b): one rank of a two-process ALS training on the one card over
#: gloo. It maps the surrogate's arrays (written by the parent), checks
#: that gloo takes CUDA tensors for the ``all_gather`` the port uses,
#: counts the device collectives gloo staged through the host, and
#: trains from a ``ShardedColumnarRatingsSource`` over its half of the
#: surrogate's columnar batch, checkpointing every iteration through the
#: ``DistributedCheckpointer``; rank 0 saves the factors. Prints one
#: ``MESHPROC {...}`` line.
MESH_TRAIN_MAIN = """\
import json, sys, time
t0 = time.perf_counter()
import numpy as np
import torch
import torch.distributed as dist
from predictionio_tpu_torch.parallel import multihost
multihost.initialize_distributed()
import chip_smoke
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.models.data import ShardedColumnarRatingsSource
from predictionio_tpu_torch.ops import fused_gram, solve
out, iters, ckdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
pid = multihost.process_index()
x = torch.full((4,), float(pid + 1), device="cuda")
parts = [torch.empty_like(x) for _ in range(2)]
dist.all_gather(parts, x)
gloo_cuda = torch.cat(parts).tolist() == [1.0] * 4 + [2.0] * 4
users, items, stars = (np.load(f"{out}/{k}.npy", mmap_mode="r")
                       for k in ("users", "items", "stars"))
n_users, n_items = int(sys.argv[4]), int(sys.argv[5])
shard = chip_smoke.surrogate_batch(users, items, stars, n_users,
                                   n_items).shard(pid, 2, with_props=False)
src = ShardedColumnarRatingsSource(shard)
reads = []
local_pass = src._read_filtered_pos
def counted(side, pred):
    got = local_pass(side, pred)
    if pred is None:
        reads.append(len(got[1]))
    return got
src._read_filtered_pos = counted
mesh = multihost.global_mesh(data=2)
params = als.ALSParams(rank=chip_smoke.RANK, num_iterations=iters)
fused_gram.LAUNCHES = solve.LAUNCHES = 0
multihost.HOST_STAGED.update(collectives=0, bytes=0)
t = time.perf_counter()
packed = als.pack_ratings_multihost(src, params, mesh)
torch.cuda.synchronize()
pack_s = time.perf_counter() - t
# the checkpoint's fingerprint digests the surrogate's triples
coo = als.RatingsCOO(users, items, stars, n_users, n_items)
t = time.perf_counter()
U, V = als.train_als(coo, params, mesh=mesh, packed=packed,
                     checkpoint_dir=ckdir)
torch.cuda.synchronize()
train_s = time.perf_counter() - t
if pid == 0:
    np.save(out + "/U.npy",
            als.unshard_table(U).cpu().numpy()[:src.n_users])
    np.save(out + "/V.npy",
            als.unshard_table(V).cpu().numpy()[:src.n_items])
print("MESHPROC " + json.dumps({
    "pid": pid, "backend": multihost.backend(), "ranks": list(mesh.ranks),
    "gloo_cuda": gloo_cuda, "rows": [src.n_users, src.n_items],
    "nnz": len(users), "local_reads": reads,
    "fused_gram": fused_gram.LAUNCHES, "chol_solve": solve.LAUNCHES,
    "host_staged": dict(multihost.HOST_STAGED), "pack_s": pack_s,
    "train_s": train_s,
    "seconds": time.perf_counter() - t0}), flush=True)
multihost.shutdown()
"""

#: part (c): a process group of one rank over NCCL trains the JAX
#: multihost test's problem through the process-group code path
MESH_NCCL_MAIN = """\
import json, sys
import numpy as np
import torch
from predictionio_tpu_torch.parallel import multihost
multihost.initialize_distributed()
import chip_smoke
from predictionio_tpu_torch.models import als
from predictionio_tpu_torch.ops import fused_gram, solve
ratings, params = chip_smoke.nccl_problem()
mesh = multihost.global_mesh()
fused_gram.LAUNCHES = solve.LAUNCHES = 0
U, V = als.train_als(ratings, params, mesh=mesh)
torch.cuda.synchronize()
np.save(sys.argv[1] + "/U.npy", als.unshard_table(U).cpu().numpy())
np.save(sys.argv[1] + "/V.npy", als.unshard_table(V).cpu().numpy())
print("MESHNCCL " + json.dumps({
    "backend": multihost.backend(), "world": multihost.process_count(),
    "ranks": list(mesh.ranks),
    "fused_gram": fused_gram.LAUNCHES, "chol_solve": solve.LAUNCHES}),
    flush=True)
multihost.shutdown()
"""


def surrogate_batch(users, items, stars, n_users: int, n_items: int):
    """The surrogate as one ``rate`` log's columnar batch: dictionary
    code = the surrogate's number (``u<n>``, ``i<n>``), storage order =
    the surrogate's, the stars as the ``rating`` column. Its sources'
    indexation is then the surrogate's own."""
    from predictionio_tpu_torch.data.columnar import (
        ColumnarBatch,
        ColumnarDicts,
        StringDict,
    )

    n = len(users)
    z = np.zeros(n, np.int32)
    return ColumnarBatch(
        event=z, entity_type=z, entity_id=np.asarray(users, np.int32),
        target_type=z, target_id=np.asarray(items, np.int32),
        event_time=np.arange(n, dtype=np.int64),
        props_offsets=np.zeros(n + 1, np.int64),
        props_blob=np.empty(0, np.uint8),
        float_props={"rating": np.asarray(stars, np.float64)},
        dicts=ColumnarDicts(
            StringDict(["rate"]), StringDict(["user"]),
            StringDict([f"u{k}" for k in range(n_users)]),
            StringDict(["item"]),
            StringDict([f"i{k}" for k in range(n_items)])))


def nccl_problem():
    """The JAX multihost test's problem: 900 ratings, 64 users x 40
    items, rank 4, 3 iterations."""
    from predictionio_tpu_torch.models import als

    rng = np.random.default_rng(7)
    nnz, n_users, n_items = 900, 64, 40
    ratings = als.RatingsCOO(
        rng.integers(0, n_users, nnz).astype(np.int32),
        rng.integers(0, n_items, nnz).astype(np.int32),
        rng.random(nnz).astype(np.float32) * 4 + 1, n_users, n_items)
    return ratings, als.ALSParams(rank=4, num_iterations=3, reg=0.05,
                                  seed=5)


def free_port() -> int:
    with contextlib.closing(socket.socket()) as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def rank_env(n: int, pid: int, port: int, backend: str) -> dict:
    """The environment of rank ``pid`` of an ``n``-process group."""
    root = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_", "PTPU_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH", "")) if p)
    env.update(PIO_COORDINATOR=f"127.0.0.1:{port}",
               PIO_NUM_PROCESSES=str(n), PIO_PROCESS_ID=str(pid),
               PIO_DIST_BACKEND=backend)
    return env


def start_ranks(code: str, args: list, n: int, backend: str, work: Path,
                tag: str, env_extra=None) -> list:
    """``python -c CODE ARGS`` as ranks 0..n-1 of a process group, all
    started together: each rank's (process, log path)."""
    root = Path(__file__).resolve().parent
    port = free_port()
    started = []
    for pid in range(n):
        log = work / f"{tag}_{pid}.log"
        env = dict(rank_env(n, pid, port, backend), **(env_extra or {}))
        with open(log, "w") as f:
            started.append((subprocess.Popen(
                [sys.executable, "-c", code, *map(str, args)], stdout=f,
                stderr=subprocess.STDOUT, cwd=root, env=env), log))
    return started


def finish_ranks(started: list) -> list:
    """Each started rank's exit code and output, once all have ended."""
    rcs = [end_process(p, MESH_PROC_TIMEOUT_S) for p, _ in started]
    return [(rc, log.read_text()) for rc, (_, log) in zip(rcs, started)]


def run_ranks(code: str, args: list, n: int, backend: str, work: Path,
              tag: str, env_extra=None) -> list:
    """:func:`start_ranks`, then :func:`finish_ranks`."""
    return finish_ranks(start_ranks(code, args, n, backend, work, tag,
                                    env_extra))


def report(out: str, tag: str) -> dict:
    return json.loads(next(ln for ln in out.splitlines()
                           if ln.startswith(tag + " "))[len(tag) + 1:])


def held(tag: str, got: np.ndarray, want: np.ndarray, rtol: float,
         atol: float) -> tuple:
    """(bitwise, max |d|): ``got`` within ``atol + rtol * |want|``."""
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    bad = d > atol + rtol * np.abs(want.astype(np.float64))
    check(got.shape == want.shape and not bool(bad.any()),
          f"{tag}: {int(bad.sum())} entries off (max |d| {d.max():.3e}, "
          f"shapes {got.shape} {want.shape})")
    return bool(np.array_equal(got, want)), float(d.max())


def split_launch(B: int, L: int) -> bool:
    """Whether ``fused_gram`` cuts a launch of ``B`` rows of ``L`` slots
    at rank RANK (f32 table) into partial sums on this card."""
    from predictionio_tpu_torch.ops import fused_gram

    return fused_gram.gram_plan(B, L, RANK, 4,
                                fused_gram.sm_count(0)).splits > 1


def mesh_iteration_ms(fn, reps: int = 3) -> float:
    """Median host ms of ``fn`` ending in a synchronize, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def all_gather_ms(fn) -> float:
    """Device ms of the kernels inside ``fn``'s ``ptpu.all_gather``
    ranges (the gather's copies and the scatter by row id), from one
    ``torch.profiler`` trace; 0 where the trace shows none."""
    from torch.profiler import ProfilerActivity, profile

    from predictionio_tpu_torch.obs.trace import profiler_held

    torch.cuda.synchronize()
    with profiler_held(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.events():
        if e.name == "ptpu.all_gather":
            us += e.device_time_total if hasattr(e, "device_time_total") \
                else e.cuda_time_total
    return us / 1e3


def forced_mesh(n: int, dev):
    """A training mesh of ``n`` positions, each the one card
    (``PTPU_TORCH_FORCE_DEVICE_COUNT`` set only while it is laid out)."""
    from predictionio_tpu_torch.parallel import local_devices, make_mesh
    from predictionio_tpu_torch.parallel.mesh import FORCE_DEVICE_COUNT_ENV

    saved = os.environ.get(FORCE_DEVICE_COUNT_ENV)
    os.environ[FORCE_DEVICE_COUNT_ENV] = str(n)
    try:
        return make_mesh(data=n, devices=local_devices(dev))
    finally:
        if saved is None:
            del os.environ[FORCE_DEVICE_COUNT_ENV]
        else:
            os.environ[FORCE_DEVICE_COUNT_ENV] = saved


def train_mesh_shards(data, dev, host_factors, card: dict) -> dict:
    """Part (a): ``train_als`` over 4 shards on the one card, explicit
    (bitwise against phase train's factors) and implicit (against the
    one card within MESH_IMPLICIT_RTOL); the pieces planned as their own
    rows against the block plan (time in turns, and where 10 iterations
    of it land); then the two- and one-shard in-process runs parts (b)
    and (c) are held to."""
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.parallel.collectives import (
        record_collectives,
    )

    users, items, stars, n_users, n_items = data
    ratings = als.RatingsCOO(users, items, stars, n_users, n_items)
    out = {}

    def mesh_of(n):
        return forced_mesh(n, dev)

    mesh = mesh_of(MESH_TRAIN_SHARDS)
    params = als.ALSParams(rank=RANK, num_iterations=TRAIN_ITERS)
    t = time.perf_counter()
    packed = als.pack_ratings(ratings, params, mesh=mesh)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t
    # the sides cut before the recorded run (a bucket side's cut
    # all-gathers its row map)
    us, its = packed.mesh_side("user", params), packed.mesh_side("item",
                                                                   params)
    zero_launch_counts()
    with record_collectives() as rec:
        U, V = als.train_als(ratings, params, mesh=mesh, packed=packed)
    torch.cuda.synchronize()
    l4 = launch_counts()
    check(l4["fused_gram"] > 0 and l4["chol_solve"] > 0,
          f"the 4-shard training launched {l4}")
    census = rec.counts()
    check(census == {"all-gather": 2 * TRAIN_ITERS},
          f"the 4-shard training's collectives {census}: not one "
          f"all-gather a half-step over {TRAIN_ITERS} iterations")
    gathered = sorted(set(rec.shapes()["all-gather"]))
    U4 = als.unshard_table(U).cpu().numpy()[:n_users]
    V4 = als.unshard_table(V).cpu().numpy()[:n_items]
    U1, V1 = host_factors
    check(U4.shape == U1[:n_users].shape and V4.shape == V1[:n_items].shape,
          "the 4-shard factors' shapes differ from phase train's")
    dU = float(np.abs(U4 - U1[:n_users]).max())
    dV = float(np.abs(V4 - V1[:n_items]).max())
    check(np.array_equal(U4, U1[:n_users]) and np.array_equal(V4,
                                                              V1[:n_items]),
          f"explicit: the 4 shards' factors are not phase train's bit for "
          f"bit (max |dU| {dU:.3e}, |dV| {dV:.3e})")
    per_iter = us.launches + its.launches
    # the same pieces planned as their own rows, not as their block
    us_own, its_own = (dataclasses.replace(side, pieces=tuple(
        tuple(dataclasses.replace(pc, plan_rows=int(pc.indices.shape[0]))
              for pc in pieces) for pieces in side.pieces))
        for side in (us, its))

    # one iteration each way, from the initial tables
    one = dataclasses.replace(params, num_iterations=1)
    p1 = als.pack_ratings_cached(ratings, one, device=dev)
    # launches fused_gram cuts into partial sums, by each plan
    card_split = sum(split_launch(int(b[0].shape[0]), int(b[0].shape[1]))
                     for h in (p1.user_h, p1.item_h)
                     for b in als.training_blocks(h, RANK, one.block_rows))
    split = {plan: sum(split_launch(plan_of(pc), int(pc.indices.shape[1]))
                       for side in (us, its) for pieces in side.pieces
                       for pc in pieces)
             for plan, plan_of in (
                 ("block", lambda pc: pc.plan_rows),
                 ("own", lambda pc: int(pc.indices.shape[0])))}
    U0, V0 = (t.to(dev) for t in als.draw_initial_factors(
        params.seed, n_users, als._rows_padded(p1.user_h), n_items,
        als._rows_padded(p1.item_h), RANK))
    single_ms = mesh_iteration_ms(lambda: als._update_side(
        als._update_side(V0, p1.user_h, one), p1.item_h, one))
    Vr = als._replicate(als._initial_tables(
        one, None, n_users, us.n_rows_padded, n_items,
        its.n_rows_padded)[1], mesh)

    def mesh_iter(sides=(us, its), V=Vr):
        Ur = als._mesh_half_step(V, sides[0], one, mesh)
        return als._mesh_half_step(Ur, sides[1], one, mesh)

    # the block plan and the own-rows plan in turns
    turns = {"block": [], "own": []}
    for _ in range(2):
        turns["block"].append(mesh_iteration_ms(mesh_iter))
        turns["own"].append(mesh_iteration_ms(
            lambda: mesh_iter((us_own, its_own))))
    mesh_ms = turns["block"][0]
    gather_ms = all_gather_ms(mesh_iter)
    # where TRAIN_ITERS iterations of each plan land (train_als's loop)
    by_hand = {}
    for plan, sides in (("block", (us, its)), ("own", (us_own, its_own))):
        V = Vr
        for _ in range(TRAIN_ITERS):
            U = als._mesh_half_step(V, sides[0], one, mesh)
            V = als._mesh_half_step(U, sides[1], one, mesh)
        Uh = U[0].cpu().numpy()[:n_users]
        Vh = V[0].cpu().numpy()[:n_items]
        check(bool(np.isfinite(Uh).all() and np.isfinite(Vh).all()),
              f"the {plan} plan's factors are not finite")
        by_hand[plan] = (float(np.abs(Uh - U1[:n_users]).max()),
                         float(np.abs(Vh - V1[:n_items]).max()))
    check(by_hand["block"] == (0.0, 0.0),
          f"the block plan by hand is not train_als's: {by_hand['block']}")

    # implicit: the Gramian's shard-order sum rounds apart
    imp = als.ALSParams(rank=RANK, num_iterations=MESH_IMPLICIT_ITERS,
                        implicit_prefs=True, alpha=1.0)
    Ui, Vi = als.train_als(ratings, imp, device=dev)
    zero_launch_counts()
    Uim, Vim = als.train_als(ratings, imp, mesh=mesh)
    torch.cuda.synchronize()
    li = launch_counts()
    check(li["fused_gram"] > 0 and li["chol_solve"] > 0,
          f"the implicit 4-shard training launched {li}")
    bi = []
    for name, got, want, n in (("U", Uim, Ui, n_users),
                               ("V", Vim, Vi, n_items)):
        g = als.unshard_table(got).cpu().numpy()[:n]
        w = want.cpu().numpy()[:n]
        bi.append(held(f"implicit 4 shards {name}", g, w, MESH_IMPLICIT_RTOL,
                       MESH_IMPLICIT_RTOL))
    print(f"phase train-mesh (a): {MESH_TRAIN_SHARDS} shards on one card, "
          f"rank {RANK}, {TRAIN_ITERS} iterations, pack_ratings(mesh) "
          f"{pack_s:.3f}s | explicit factors bitwise equal to phase "
          f"train's | collectives recorded {census} (one a half-step, "
          f"shapes {gathered}) | launches fused_gram={l4['fused_gram']} "
          f"chol_solve={l4['chol_solve']} ({per_iter} an iteration "
          f"against the one "
          f"card's 30; split into partial sums: block plan "
          f"{split['block']}, own rows {split['own']}, one card "
          f"{card_split}) | an iteration ms in turns, block plan "
          f"{' '.join(f'{t:.3f}' for t in turns['block'])}, own rows "
          f"{' '.join(f'{t:.3f}' for t in turns['own'])}; {TRAIN_ITERS} "
          f"iterations planned by own rows land max |d| U "
          f"{by_hand['own'][0]:.3e} V {by_hand['own'][1]:.3e} from phase "
          f"train's | one iteration ms: one card {single_ms:.3f}, "
          f"{MESH_TRAIN_SHARDS} shards {mesh_ms:.3f} "
          f"({mesh_ms / single_ms:.3f}x), the all-gather's kernels "
          f"{gather_ms:.3f} (profiler) | implicit {MESH_IMPLICIT_ITERS} "
          f"iteration(s) alpha 1.0: bitwise U {bi[0][0]} V {bi[1][0]}, max "
          f"|d| U {bi[0][1]:.3e} V {bi[1][1]:.3e} (rtol "
          f"{MESH_IMPLICIT_RTOL}), launches fused_gram={li['fused_gram']} "
          f"chol_solve={li['chol_solve']} | {card_tag(card)}", flush=True)
    out["shards4"] = l4
    out["implicit"] = li

    # the in-process counterpart of part (c)
    out["mesh_of"] = mesh_of
    r_c, p_c = nccl_problem()
    Uc, Vc = als.train_als(r_c, p_c, mesh=mesh_of(1))
    out["one_shard"] = (als.unshard_table(Uc).cpu().numpy(),
                        als.unshard_table(Vc).cpu().numpy())
    return out


def train_mesh_procs(data, ref: dict, work: Path, card: dict) -> dict:
    """Part (b): two ranks on the one card over gloo, their sources
    sharded, checkpointed every iteration; then a resumed launch with 2
    more iterations. Held to the in-process 2 shards trained on the
    whole batch's COO (the sources' indexation: users and items that
    have ratings, in surrogate order)."""
    from predictionio_tpu_torch.models import als

    users, items, stars, n_users, n_items = data
    for k, a in (("users", users), ("items", items), ("stars", stars)):
        np.save(work / f"{k}.npy", a)
    # every triple, users and items renumbered in number order among the
    # rated ones: the sources' indexation, found here by numpy alone
    luts = []
    for ids, n in ((users, n_users), (items, n_items)):
        seen = np.zeros(n, bool)
        seen[ids] = True
        luts.append((np.cumsum(seen) - 1, int(seen.sum())))
    coo = als.RatingsCOO(luts[0][0][users].astype(np.int32),
                         luts[1][0][items].astype(np.int32),
                         np.asarray(stars, np.float32), luts[0][1],
                         luts[1][1])
    mesh2 = ref["mesh_of"](2)
    want = {}
    for iters in (MESH_PROC_ITERS, MESH_PROC_ITERS + 2):
        p = als.ALSParams(rank=RANK, num_iterations=iters)
        Ux, Vx = als.train_als(coo, p, mesh=mesh2)
        want[iters] = (als.unshard_table(Ux).cpu().numpy()[:coo.n_users],
                       als.unshard_table(Vx).cpu().numpy()[:coo.n_items])
    ckdir = work / "ckpt"
    launches = {}
    for tag, iters in (("procs", MESH_PROC_ITERS),
                       ("resume", MESH_PROC_ITERS + 2)):
        t = time.perf_counter()
        ranks = run_ranks(MESH_TRAIN_MAIN,
                          [work, iters, ckdir, n_users, n_items], 2,
                          "gloo", work, f"mesh_{tag}")
        wall = time.perf_counter() - t
        for pid, (rc, log) in enumerate(ranks):
            check(rc == 0, f"(b) {tag}: rank {pid} exited {rc}: "
                           f"{log[-3000:]}")
        reps = [report(log, "MESHPROC") for _, log in ranks]
        for r in reps:
            check(r["rows"] == [coo.n_users, coo.n_items],
                  f"(b) the source's rows differ from the COO's: {r}")
            check(r["gloo_cuda"], f"(b) gloo's CUDA collectives: {r}")
            check(r["fused_gram"] > 0 and r["chol_solve"] > 0,
                  f"(b) {tag}: rank {r['pid']} launched {r}")
            check(r["host_staged"]["collectives"] > 0,
                  f"(b) {tag}: gloo's CUDA collectives went uncounted: {r}")
            check(r["backend"] == "gloo" and r["ranks"] == [0, 1],
                  f"(b) {tag}: group {r['backend']} {r['ranks']}")
            for n in r["local_reads"]:
                check(0.4 <= n / r["nnz"] <= 0.6,
                      f"(b) rank {r['pid']} materialised {n} of "
                      f"{r['nnz']} triples before the shuffle")
        launches[tag] = {k: sum(r[k] for r in reps)
                         for k in ("fused_gram", "chol_solve")}
        U = np.load(work / "U.npy")
        V = np.load(work / "V.npy")
        Uw, Vw = want[iters]
        bu, du = held(f"(b) {tag} U", U, Uw, MESH_PROC_RTOL, MESH_PROC_ATOL)
        bv, dv = held(f"(b) {tag} V", V, Vw, MESH_PROC_RTOL, MESH_PROC_ATOL)
        print(f"phase train-mesh (b) {tag}: 2 ranks on one card over gloo, "
              f"{iters} iterations, {wall:.3f}s wall (rank 0: "
              f"{reps[0]['seconds']:.3f}s, pack {reps[0]['pack_s']:.3f}s, "
              f"train {reps[0]['train_s']:.3f}s, checkpoints every "
              f"iteration) | materialised before the shuffle "
              f"{[r['local_reads'] for r in reps]} of {len(users)} | "
              f"launches fused_gram={launches[tag]['fused_gram']} "
              f"chol_solve={launches[tag]['chol_solve']} | gloo's "
              f"all_gather takes CUDA tensors; staged through the host "
              f"(rank 0): {reps[0]['host_staged']['collectives']} "
              f"collectives, {reps[0]['host_staged']['bytes']} bytes | "
              f"{coo.n_users} x {coo.n_items} rated | against the "
              f"in-process 2 shards: "
              f"bitwise U {bu} V {bv}, max |d| U {du:.3e} V {dv:.3e} | "
              f"{card_tag(card)}", flush=True)
    first, resumed = launches["procs"], launches["resume"]
    for k in ("fused_gram", "chol_solve"):
        check(resumed[k] * MESH_PROC_ITERS == first[k] * 2,
              f"(b) the resumed launch ran {resumed[k]} {k} launches, not "
              f"2 iterations' of {first[k]} over {MESH_PROC_ITERS}")
    return launches


def train_mesh_nccl(started: list, ref: dict, work: Path,
                    card: dict) -> dict:
    """Part (c): one rank over NCCL (started beside part (b): it is
    small), bitwise against the in-process one shard."""
    (rc, log), = finish_ranks(started)
    check(rc == 0, f"(c) the NCCL rank exited {rc}: {log[-3000:]}")
    r = report(log, "MESHNCCL")
    check(r["backend"] == "nccl" and r["world"] == 1 and r["ranks"] == [0],
          f"(c) the group was not one NCCL rank: {r}")
    check(r["fused_gram"] > 0 and r["chol_solve"] > 0,
          f"(c) the NCCL rank launched {r}")
    U, V = np.load(work / "nccl" / "U.npy"), np.load(work / "nccl" / "V.npy")
    Uw, Vw = ref["one_shard"]
    check(np.array_equal(U, Uw) and np.array_equal(V, Vw),
          f"(c) the NCCL rank's factors are not the in-process one "
          f"shard's bit for bit (max |d| "
          f"{np.abs(U - Uw).max():.3e}, {np.abs(V - Vw).max():.3e})")
    print(f"phase train-mesh (c): 1 rank over NCCL, the JAX multihost "
          f"test's problem (900 ratings, 64 x 40, rank 4, 3 iterations): "
          f"factors bitwise the in-process one shard's | launches "
          f"fused_gram={r['fused_gram']} chol_solve={r['chol_solve']} | "
          f"{card_tag(card)}", flush=True)
    return {"fused_gram": r["fused_gram"], "chol_solve": r["chol_solve"]}


def pod_env_base() -> dict:
    """This process's environment less ``PIO_*``, with the repo on the
    path."""
    base_env = {k: v for k, v in os.environ.items()
                if not k.startswith("PIO_")}
    root = Path(__file__).resolve().parent
    base_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH", "")) if p)
    return base_env


def train_mesh_pod(home: str, pio: dict, remote: dict, work: Path,
                   server, srv_log: Path, threads_before: set,
                   card: dict) -> dict:
    """Part (d): ``server`` (a ``cli storageserver`` over the ``pio``
    store, started with the phase) and two ``cli train`` ranks over
    REMOTE with shard pushdown, held to phase storage's single REMOTE
    training."""
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.workflow.persistence import loads_models

    base_env = pod_env_base()
    pod = None
    try:
        srv_port = None
        t0 = time.perf_counter()
        while srv_port is None:
            check(server.poll() is None
                  and time.perf_counter() - t0 < STORAGE_TIMEOUT_S,
                  f"cli storageserver did not start: {srv_log.read_text()}")
            for ln in srv_log.read_text().splitlines():
                if " is listening at http://" in ln:
                    srv_port = int(ln.rsplit(":", 1)[1].rstrip("."))
            time.sleep(0.01)
        pod_env = {
            "PIO_STORAGE_SOURCES_NET_TYPE": "REMOTE",
            "PIO_STORAGE_SOURCES_NET_URL": f"http://127.0.0.1:{srv_port}",
            "PIO_STORAGE_SOURCES_NET_SECRET": STORAGE_SECRET,
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "NET",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "NET",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "NET"}
        variant = json.loads(Path(pio["engine_json"]).read_text())
        variant["id"] = "pod-mesh"
        engine_json = work / "pod_engine.json"
        engine_json.write_text(json.dumps(variant))
        t = time.perf_counter()
        ranks = run_ranks(CLI_COUNTED_MAIN,
                          ["train", "--engine-json", engine_json], 2,
                          "gloo", work, "pod", env_extra=pod_env)
        wall = time.perf_counter() - t
        reps = []
        for pid, (rc, log) in enumerate(ranks):
            check(rc == 0, f"(d) cli train rank {pid} exited {rc}: "
                           f"{log[-3000:]}")
            reps.append(report(log, "COUNTED"))
        shares = [r["pull"]["bytes"] / remote["pull_bytes"] for r in reps]
        for pid, (r, share) in enumerate(zip(reps, shares)):
            check(r["fused_gram"] > 0 and r["chol_solve"] > 0,
                  f"(d) rank {pid} launched {r}")
            check(0.4 <= share <= 0.6,
                  f"(d) rank {pid} pulled {r['pull']['bytes']} bytes, "
                  f"{share:.4f} of the single REMOTE training's "
                  f"{remote['pull_bytes']}")
        pod = Storage(env=pod_env)
        insts = [i for i in pod.engine_instances().get_all()
                 if i.engine_id == "pod-mesh"]
        check(len(insts) == 1 and insts[0].status == "COMPLETED",
              f"(d) instances {[(i.id, i.status) for i in insts]}")
        (model,) = loads_models(pod.models().get(insts[0].id).models)
        # the later phases read phase 8's store with its one instance
        pod.models().delete(insts[0].id)
        pod.engine_instances().delete(insts[0].id)
        bits = []
        for side, attr, ref_f, ref_ids in (
                ("user_ids", "user_factors", remote["factors"][0],
                 remote["ids"][0]),
                ("item_ids", "item_factors", remote["factors"][1],
                 remote["ids"][1])):
            ids = getattr(model, side).to_dict()
            check(set(ids) == set(ref_ids), f"(d) {side} differ")
            keys = sorted(ids)
            got = getattr(model, attr).cpu().numpy()[[ids[k] for k in keys]]
            want = ref_f[[ref_ids[k] for k in keys]]
            bits.append(held(f"(d) {attr}", got, want, MESH_PROC_RTOL,
                             MESH_PROC_ATOL))
        pod.close()
        pod = None
        server.send_signal(signal.SIGINT)
        check(end_process(server, 60) == 0,
              f"(d) cli storageserver did not exit cleanly: "
              f"{srv_log.read_text()[-2000:]}")
        server = None
        left = storage_threads_left(threads_before)
        check(not left, f"(d) threads left: {left}")
        check_no_children()
        print(f"phase train-mesh (d): cli storageserver over the pio store, "
              f"2 cli train ranks over REMOTE with shard pushdown (gloo) in "
              f"{wall:.3f}s | npz pulls {[r['pull']['bytes'] for r in reps]}"
              f" bytes, {', '.join(f'{s:.4f}' for s in shares)} of phase "
              f"storage's single pull ({remote['pull_bytes']}) | one "
              f"COMPLETED instance, one blob | against phase storage's "
              f"REMOTE model: bitwise users {bits[0][0]} items "
              f"{bits[1][0]}, max |d| {bits[0][1]:.3e} {bits[1][1]:.3e} | "
              f"launches fused_gram={[r['fused_gram'] for r in reps]} "
              f"chol_solve={[r['chol_solve'] for r in reps]} | "
              f"{card_tag(card)}", flush=True)
        return {k: sum(r[k] for r in reps)
                for k in ("fused_gram", "chol_solve")}
    finally:
        if pod is not None:
            pod.close()


def phase_train_mesh(data, dev, host_factors, home: str, pio: dict,
                     remote: dict, card: dict) -> dict:
    """ALS over a mesh and across processes (module docstring, phase
    8a'). Part (d)'s storage server starts with the phase and part (c)'s
    rank beside part (b)'s. Returns each part's kernel launches."""
    work = Path(tempfile.mkdtemp(prefix="train_mesh_", dir=Path(home)))
    threads_before = {t.ident for t in threading.enumerate()}
    srv_log = work / "pod_storageserver.log"
    server = cli_process(["storageserver", "--ip", "127.0.0.1", "--port",
                          "0", "--secret", STORAGE_SECRET],
                         dict(pod_env_base(), PIO_HOME=home), srv_log)
    nccl = []
    try:
        ref = train_mesh_shards(data, dev, host_factors, card)
        launches = {"shards4": ref["shards4"], "implicit": ref["implicit"]}
        (work / "nccl").mkdir()
        nccl = start_ranks(MESH_NCCL_MAIN, [work / "nccl"], 1, "nccl",
                           work, "mesh_nccl")
        launches.update(train_mesh_procs(data, ref, work, card))
        launches["nccl"] = train_mesh_nccl(nccl, ref, work, card)
        launches["pod"] = train_mesh_pod(home, pio, remote, work, server,
                                         srv_log, threads_before, card)
        return launches
    finally:
        for proc in [p for p, _ in nccl] + [server]:
            if proc.poll() is None:
                proc.terminate()
                end_process(proc, 30)
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase check: the port's static analysis, and the shared-memory formulas
# held to the libraries
# ---------------------------------------------------------------------------

#: cudaDevAttrMaxSharedMemoryPerBlockOptin
_ATTR_SMEM_OPTIN = 97


def smem_optin(dev_index: int = 0) -> int:
    """The card's opt-in limit of dynamic shared memory a block, from the
    card (``torch``'s device properties, else the runtime)."""
    props = torch.cuda.get_device_properties(dev_index)
    optin = getattr(props, "shared_memory_per_block_optin", None)
    if optin:
        return int(optin)
    out = ctypes.c_int(0)
    err = _cudart().cudaDeviceGetAttribute(ctypes.byref(out),
                                           _ATTR_SMEM_OPTIN, dev_index)
    check(err == 0, f"cudaDeviceGetAttribute failed: {err}")
    return int(out.value)


def _topk_c_grid():
    """Every point ``csrc/fused_topk.cu``'s launch validates (rank, k's
    list length, queries a block, tile rows, wire), planned or not."""
    from predictionio_tpu_torch.ops import smem

    for itemsize in smem.TOPK_WIRES:
        for r in range(1, smem.TOPK_MAX_RANK + 1):
            for k in (1, 32, 33, smem.TOPK_MAX_K):
                for qb in range(8, smem.TOPK_MAX_QB + 1, 8):
                    for chunk in smem.TOPK_CHUNKS:
                        yield (r * itemsize, qb, chunk, k)


def static_smem(lib, name: str, variant: int) -> int:
    fn = getattr(lib, f"{name}_static_smem")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = ctypes.c_longlong(-1)
    err = fn(variant, ctypes.byref(out))
    check(err == 0, f"{name}_static_smem({variant}) failed: {err}")
    return int(out.value)


def phase_check(card: dict) -> dict:
    """``cli check`` in a fresh process, then every kernel's shared-memory
    formula against its library's export over every point its launcher
    accepts, and the largest point against the card's opt-in limit."""
    from predictionio_tpu_torch.analysis import kernels as akernels
    from predictionio_tpu_torch.ops import _build, smem

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "check"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    check_s = time.perf_counter() - t0
    check(out.returncode == 0 and "clean" in out.stdout,
          f"cli check exited {out.returncode}: {out.stdout[-3000:]} "
          f"{out.stderr[-3000:]}")
    optin = smem_optin()
    report = akernels.smem_report(str(ROOT / "predictionio_tpu_torch"
                                      / "ops" / "smem.py"))
    t0 = time.perf_counter()
    rows, points = {}, 0
    for name, spec in smem.KERNELS.items():
        lib = _build.load_library(name)
        export = getattr(lib, spec["export"])
        export.argtypes = [ctypes.c_int] * len(spec["args"])
        export.restype = ctypes.c_longlong
        grid = list(spec["grid"]())
        if name == "fused_topk":
            grid += list(_topk_c_grid())
        for point in grid:
            want = spec["bytes"](point)
            got = export(*point)
            check(got == want,
                  f"{name}: {spec['export']}{point} = {got}, ops/smem.py "
                  f"gives {want}")
        points += len(grid)
        top = report[name]
        p = top["point"]
        variant = {"fused_topk": None, "chol_solve": p.get("rp"),
                   "fused_gram": p.get("itemsize"),
                   "gram_table": p.get("itemsize")}[name]
        if variant is None:  # the static part of each wire's kernel
            stat = max(static_smem(lib, name, w) for w in smem.TOPK_WIRES)
        else:
            stat = static_smem(lib, name, variant)
        check(top["bytes"] <= optin and top["bytes"] + stat <= optin,
              f"{name}: {top['bytes']} dynamic + {stat} static bytes at "
              f"{p} pass the card's opt-in limit of {optin}")
        rows[name] = {"point": p, "dynamic": top["bytes"], "static": stat,
                      "points": len(grid)}
    cmp_s = time.perf_counter() - t0
    caught = kernel_rules_caught()
    print(f"phase check: cli check clean in {check_s:.3f}s (fresh "
          f"process) | {points} grid points, ops/smem.py equal to the C "
          f"exports at every one ({cmp_s:.3f}s) | opt-in limit {optin} "
          f"bytes a block (the card's) | kernel-safety rules with no "
          f"baseline, each catching its seeded fault: "
          f"{', '.join(f'{r} at {at}' for r, at in caught.items())} | "
          f"{card_tag(card)}", flush=True)
    for name, r in rows.items():
        print(f"phase check smem {name}: largest accepted point "
              f"{r['point']} dynamic={r['dynamic']} static={r['static']} "
              f"sum={r['dynamic'] + r['static']} of {optin} "
              f"({r['points']} points)", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    numerics = numerics_on_card(dev, card)
    hlo = hlo_on_card(dev, card)
    return {"check_s": check_s, "optin": optin, "smem": rows,
            "numerics": numerics, "launches": numerics["launches"],
            "hlo": hlo, "hlo_launches": hlo["launches"]}


#: phase check: the ``audit-hlo`` entries and the kernels each must launch
#: on the card
HLO_KERNEL_GATES = {
    "lhs_fused": ("fused_gram", "chol_solve"),
    "sharded_rank": ("fused_topk",),
}
HLO_TIMEOUT_S = 300.0


def hlo_census(dev) -> dict:
    """``run_audit`` of each ``audit-hlo`` entry on ``dev``, the kernels'
    launches and (on the card) the allocator's peak above its start read
    around each, then the seeded ``unshard_table`` fault's census."""
    from predictionio_tpu_torch.analysis import hlo_audit as ha
    from predictionio_tpu_torch.analysis.numerics_audit import (
        _forced_devices,
    )

    entries, launches, peaks = {}, {}, {}
    for name in ha.ENTRY_POINTS:
        before = launch_counts()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        entries.update(ha.run_audit([name], device=dev)["entries"])
        if dev.type == "cuda":
            peaks[name] = torch.cuda.max_memory_allocated(dev) - base
        after = launch_counts()
        launches[name] = {k: after[k] - before[k] for k in after}
    with _forced_devices(ha.AUDIT_DEVICE_COUNT):
        seeded = ha.census(ha.seeded_unshard, dev)
    return {"entries": entries, "launches": launches, "peaks": peaks,
            "seeded": seeded}


def hlo_on_card(dev, card: dict) -> dict:
    """The ``audit-hlo`` census on the card in a threaded child (module
    docstring, phase 2b): its four gates, and its seconds (on the CPU, for
    a rehearsal: the ``cpu`` section, and no launch is asked for)."""
    from predictionio_tpu_torch.analysis import hlo_audit as ha

    platform = ha.platform_of(dev)
    doc = ha.load_manifest(ha.DEFAULT_BASELINE)
    committed, cpu = ha.section(doc, platform), ha.section(doc, "cpu")
    check(committed is not None and cpu is not None,
          f"{ha.DEFAULT_BASELINE} records no {platform} or cpu section")
    out: dict = {}

    def run():
        try:
            out.update(hlo_census(dev))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["error"] = e

    t0 = time.perf_counter()
    child = threading.Thread(target=run, name="audit-hlo", daemon=True)
    child.start()
    child.join(HLO_TIMEOUT_S)
    audit_s = time.perf_counter() - t0
    check(not child.is_alive(),
          f"the audit-hlo census ran past {HLO_TIMEOUT_S:.0f}s")
    if "error" in out:
        raise out["error"]
    census = {"version": ha.MANIFEST_VERSION, "platform": platform,
              "devices": ha.AUDIT_DEVICE_COUNT, "entries": out["entries"]}
    violations, shrinkable = ha.diff_manifests(census, committed)
    check(not violations, f"audit-hlo on {platform} against the committed "
          f"section: {violations}")
    check(ha.structure(census) == ha.structure(cpu),
          f"the {platform} census's collectives, shapes and joins differ "
          f"from the committed cpu section's: {ha.structure(census)}")
    for entry, kernels in HLO_KERNEL_GATES.items():
        for k in kernels:
            n = out["launches"][entry][k]
            check(platform == "cpu" or n > 0,
                  f"audit-hlo {entry} launched {k} {n} times")
    seeded, _ = ha.diff_manifests(
        {**census, "entries": {"sharded_rank": out["seeded"]}}, committed)
    hit = [v for v in seeded if v.startswith("sharded_rank: join aten.cat")]
    check(bool(hit), f"sharded_rank through unshard_table passed the gate: "
          f"{seeded}")
    entries = out["entries"]
    summary = "; ".join(
        f"{name} " + (", ".join(f"{op} x{c} {rec['collective_shapes'][op]}"
                                for op, c in sorted(
                                    rec["collectives"].items()))
                      or "no collective")
        + "".join(f", join {op} x{len(sh)}"
                  for op, sh in sorted(rec["joins"].items()))
        for name, rec in entries.items())
    temps = {name: (rec["temp_bytes"], out["peaks"].get(name))
             for name, rec in entries.items()}
    launches = {k: sum(l[k] for l in out["launches"].values())
                for k in next(iter(out["launches"].values()))}
    print(f"phase check hlo: run_audit on {platform} in a threaded child "
          f"{audit_s:.3f}s, {len(entries)} entries pass the committed "
          f"{platform} section ({len(shrinkable)} shrinkable), their "
          f"collectives, shapes and joins exactly the cpu section's | "
          f"{summary} | temp_bytes against max_memory_allocated's delta "
          f"{temps} | launches "
          f"{ {e: {k: out['launches'][e][k] for k in ks} for e, ks in HLO_KERNEL_GATES.items()} } "
          f"(all entries {launches}) | seeded unshard_table: "
          f"'{hit[0].split(' — ')[0]}' | {card_tag(card)}", flush=True)
    return {"audit_s": audit_s, "launches": launches, "temps": temps}


#: phase check: the serving wires and training entries of
#: ``audit-numerics`` and the kernel each must launch on the card
NUMERICS_KERNEL_GATES = {
    "device_topk_off": "fused_topk",
    "device_topk_bf16": "fused_topk",
    "device_topk_int8": "fused_topk",
    "lhs_fused": "fused_gram",
    "train_update_block": "chol_solve",
}

#: phase check: ``ops/gram.py``'s bf16 einsum with its upcast dropped
#: (the JAX package's TestSeededRegressionFailsBothGates, in torch)
SEEDED_GRAM = """\
import torch


def gram_weighted(F, w, bf16=True):
    lo = (F * w[..., None]).to(torch.bfloat16)
    return torch.einsum("...lr,...ls->...rs", lo, F.to(torch.bfloat16))
"""


def numerics_on_card(dev, card: dict) -> dict:
    """``cli audit-numerics`` on the card in a fresh process against the
    committed ``cuda`` section, the five census gates, and the seeded
    bf16 einsum caught by both gates (on the CPU, for a rehearsal: the
    ``cpu`` section, and no launch is asked for)."""
    from predictionio_tpu_torch.analysis import numerics_audit as na

    platform = na.platform_of(dev)
    doc = na.load_manifest(na.DEFAULT_BASELINE)
    check(na.section(doc, platform) is not None,
          f"{na.DEFAULT_BASELINE} records no {platform} section")
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    out_path = scratch / "numerics_census.json"
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli",
         "audit-numerics", "--out", str(out_path),
         *(["--device", "cpu"] if platform == "cpu" else [])],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    audit_s = time.perf_counter() - t0
    check(out.returncode == 0,
          f"cli audit-numerics exited {out.returncode}: "
          f"{out.stdout[-3000:]} {out.stderr[-3000:]}")
    census = json.loads(out_path.read_text())
    entries = census["entries"]
    check(census["platform"] == platform
          and set(entries) == set(na.ENTRY_POINTS),
          f"the census ran on {census['platform']} over {list(entries)}")
    for entry, kernel in NUMERICS_KERNEL_GATES.items():
        check(platform == "cpu" or entries[entry]["kernels"][kernel] >= 1,
              f"{entry} launched {kernel} "
              f"{entries[entry]['kernels'][kernel]} times")
    table_f32 = na.ITEM_ROWS * na.RANK * 4
    f32 = {q: entries[f"device_topk_{q}"]["bytes"].get("float32", 0)
           for q in ("bf16", "int8")}
    check(platform == "cpu" or all(b < table_f32 for b in f32.values()),
          f"a quantized wire made {f32} f32 result bytes, an item table "
          f"in f32 is {table_f32}")
    low = {op: by for op, by in
           entries["foldin_update_bf16"]["reductions"].items()
           if any(na.is_low(dt) for dt in by)}
    check(not low, f"foldin_update_bf16 accumulates below f32: {low}")
    static_at, violation = seeded_gram_caught(dev)
    launches = {k: sum(e["kernels"][k] for e in entries.values())
                for k in na.KERNEL_MODULES}
    print(f"phase check numerics: cli audit-numerics on {platform} "
          f"{audit_s:.3f}s (fresh process), {len(entries)} entries equal "
          f"to the committed {platform} section | launches "
          f"{ {e: entries[e]['kernels'][k] for e, k in NUMERICS_KERNEL_GATES.items()} } "
          f"(all entries {launches}) | f32 result bytes bf16={f32['bf16']} "
          f"int8={f32['int8']} against the f32 item table's {table_f32} | "
          f"foldin_update_bf16 reductions "
          f"{entries['foldin_update_bf16']['reductions']} | seeded bf16 "
          f"einsum: low-precision-reduction at {static_at}, census "
          f"'{violation}' | {card_tag(card)}", flush=True)
    return {"audit_s": audit_s, "launches": launches, "f32": f32}


def seeded_gram_caught(dev) -> tuple:
    """The seeded bf16 einsum flagged by the static rule in a scratch
    ``ops/gram.py``, and its census on the card failing the diff against
    ``ops/gram.py::gram_weighted`` as shipped: ``(path:line, violation)``."""
    import importlib.util

    from predictionio_tpu_torch import analysis
    from predictionio_tpu_torch.analysis import numerics_audit as na
    from predictionio_tpu_torch.ops.gram import gram_weighted

    with tempfile.TemporaryDirectory(prefix="numerics_",
                                     dir=ROOT / "build") as d:
        path = Path(d) / "pkg" / "ops" / "gram.py"
        path.parent.mkdir(parents=True)
        path.write_text(SEEDED_GRAM)
        found = analysis.run_check([str(Path(d) / "pkg")],
                                   rule_names=["low-precision-reduction"])
        check(len(found) == 1, f"low-precision-reduction on the seeded "
              f"einsum found {[f.format() for f in found]}")
        spec = importlib.util.spec_from_file_location("seeded_gram", path)
        seeded = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(seeded)
    g = torch.Generator(device=dev).manual_seed(0)
    F = torch.randn((64, 32, RANK), generator=g, device=dev)
    w = torch.rand((64, 32), generator=g, device=dev)
    shipped = na.census(lambda: gram_weighted(F, w, bf16=True))
    bad = na.census(lambda: seeded.gram_weighted(F, w))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    golden = {"version": na.MANIFEST_VERSION, "devices": 1,
              "entries": {"gram": shipped}}
    clean, _ = na.diff_manifests(golden, golden)
    check(not clean, f"the shipped einsum against itself: {clean}")
    violations, _ = na.diff_manifests(
        {**golden, "entries": {"gram": bad}}, golden)
    hit = [v for v in violations if "bfloat16" in v
           and "f32 accumulator" in v]
    check(bool(hit), f"the seeded einsum's census passed the diff "
          f"({bad['reductions']} against {shipped['reductions']})")
    return f"{found[0].path.rsplit('/', 2)[-2]}/gram.py:{found[0].line}", \
        hit[0].split(" — ")[0]


#: phase check: one seeded fault for each kernel-safety rule, in a
#: scratch package (``ops/k.py`` beside ``csrc/k.cu``): a ``cp.async``
#: never waited, a bf16 shared accumulator, and a launcher that returns
#: before its launch
KERNEL_RULE_FIXTURES = {
    "csrc/k.cu": """\
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src));
}
__global__ void unwaited(const float* x) {
  __shared__ float4 buf[32];
  cp_async16(&buf[threadIdx.x], x + 4 * threadIdx.x);
}
__global__ void narrow(const __nv_bfloat16* x, float* out) {
  __shared__ __nv_bfloat16 acc[128];
  acc[threadIdx.x] = acc[threadIdx.x] + x[threadIdx.x];
  out[threadIdx.x] = __bfloat162float(acc[threadIdx.x]);
}
extern "C" int k_f32(const void* x, void* stream) { return 0; }
""",
    "ops/k.py": """\
import ctypes


def load_library(name):
    return ctypes.CDLL(name)


def _kernel_lib():
    return load_library("k")


def k(x):
    if x.shape[0] < 64:
        return x
    return _kernel_lib().k_f32(x.data_ptr(), 0)
""",
}
KERNEL_RULES = ("dma-unwaited", "low-precision-accumulator",
                "missing-interpret-fallback")


def kernel_rules_caught() -> dict:
    """Each kernel-safety rule is registered, and finds exactly its one
    seeded fault in KERNEL_RULE_FIXTURES: ``{rule: "path:line"}``."""
    from predictionio_tpu_torch import analysis

    missing = set(KERNEL_RULES) - set(analysis.RULES)
    check(not missing, f"cli check's registry lacks {missing}")
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    caught = {}
    with tempfile.TemporaryDirectory(prefix="rules_", dir=scratch) as d:
        pkg = Path(d) / "pkg"
        for rel, text in KERNEL_RULE_FIXTURES.items():
            (pkg / rel).parent.mkdir(parents=True, exist_ok=True)
            (pkg / rel).write_text(text)
        for rule in KERNEL_RULES:
            found = analysis.run_check([str(pkg)], rule_names=[rule])
            check(len(found) == 1 and found[0].rule == rule,
                  f"{rule} on its seeded fault found "
                  f"{[f.format() for f in found]}")
            caught[rule] = f"{Path(found[0].path).name}:{found[0].line}"
    return caught


# ---------------------------------------------------------------------------
# phase audit: the leak census on the card
# ---------------------------------------------------------------------------

AUDIT_CYCLES = 3
AUDIT_SETTLE_S = 2.0
AUDIT_QUERIES = 64
#: users of a stream_trainer cycle's burst (a cycle is its users' history
#: reads; the census counts threads, fds and sockets)
AUDIT_BURST_USERS = 4
AUDIT_USER_EVENTS = 16
AUDIT_CONSUMER = "chip-audit"
AUDIT_TIMEOUT_S = 600.0
#: one cycle's tables at the serving width: U and V in f32 (42.3 MB)
AUDIT_TABLE_BYTES = (N_USERS + N_ITEMS) * RANK * 4

#: the gate's own fixture: a poller whose stop() neither signals nor joins
#: its thread (``gone`` lets the script end the threads once counted)
AUDIT_LEAKY_SRC = """
import threading
import time

gone = threading.Event()


class LeakyPoller:
    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        pass  # the bug: no stop event, no join

    def _run(self):
        while not gone.is_set():
            time.sleep(0.05)
"""


class CycleLog:
    """Each cycle's kernel launches and the card memory after it (after a
    collection): the first row is ``run_audit``'s warm-up cycle.
    ``gate`` is one cycle's tables, the growth the memory gate refuses:
    a cycle that binds a model sets it from that model's U and V."""

    def __init__(self, counters: dict, gate: int = 0):
        self.counters = counters  # kernel name -> module with LAUNCHES
        self.gate = gate
        self.rows: list = []

    def tables(self, model) -> None:
        """Gate at the bytes of ``model``'s bound U and V (with their
        scales on a quantized wire), as read from the card."""
        from predictionio_tpu_torch.models.als import _table_leaves

        self.gate = sum(t.numel() * t.element_size()
                        for table in (model.user_factors, model.item_factors)
                        for t in _table_leaves(table) if t is not None)

    def wrap(self, cycle):
        def run():
            for mod in self.counters.values():
                mod.LAUNCHES = 0
            t0 = time.perf_counter()
            cycle()
            gc.collect()
            torch.cuda.synchronize()
            self.rows.append({
                "launches": {k: m.LAUNCHES for k, m in self.counters.items()},
                "allocated": torch.cuda.memory_allocated(),
                "seconds": time.perf_counter() - t0})
        return run

    def growth(self) -> int:
        """Allocated bytes after the last cycle less after the warm-up."""
        return self.rows[-1]["allocated"] - self.rows[0]["allocated"]


def memory_gate(log: CycleLog) -> str:
    """Why the card memory grew too much over the measured cycles, or ''."""
    grew = log.growth()
    check(log.gate > 0, "no cycle set the memory gate")
    if grew >= log.gate:
        return (f"memory_allocated grew {grew} bytes over the measured "
                f"cycles, at least one cycle's tables ({log.gate})")
    return ""


def audit_entry(name: str, build, desc: str, dev) -> dict:
    """``run_audit`` of one in-process entry on the card, and its
    census's violations against an all-zero baseline."""
    from predictionio_tpu_torch.analysis import lifecycle_audit as la

    t0 = time.perf_counter()
    m = la.run_audit(entry_points={name: (build, desc)},
                     cycles=AUDIT_CYCLES, settle_sec=AUDIT_SETTLE_S,
                     device=dev)
    seconds = time.perf_counter() - t0
    return {"manifest": m, "seconds": seconds,
            "violations": la.diff_manifests(m, {
                "version": la.MANIFEST_VERSION, "cycles": AUDIT_CYCLES,
                "entries": {name: {k: 0 for k in la.RESOURCES}}})[0]}


def audit_line(name: str, log: CycleLog, res: dict, card: dict) -> None:
    census = res["manifest"]["entries"][name]
    per_cycle = [r["launches"] for r in log.rows]
    print(f"phase audit {name}: census {census} over {AUDIT_CYCLES} cycles "
          f"after 1 warm-up | memory_allocated after the warm-up "
          f"{log.rows[0]['allocated']} after the measured cycles "
          f"{log.rows[-1]['allocated']} (grew {log.growth()}, gate "
          f"{log.gate}: one cycle's tables, read from the bound model) | "
          f"launches a cycle {per_cycle} | cycle "
          f"seconds {[round(r['seconds'], 3) for r in log.rows]} | "
          f"{res['seconds']:.2f}s | {card_tag(card)}", flush=True)


def phase_audit(uv, dev, home: str, pio: dict, data, card: dict) -> dict:
    """(a) ``cli audit-lifecycle`` on the card; (b) the full-width engine
    and stream entries in this process; (c) the leaky fixture caught by
    both gates."""
    from predictionio_tpu_torch import cli
    from predictionio_tpu_torch.analysis import check_source
    from predictionio_tpu_torch.analysis import lifecycle_audit as la
    from predictionio_tpu_torch.cache.bus import InvalidationBus
    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event, from_millis
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.ops import fused_gram as fg
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.ops import gram
    from predictionio_tpu_torch.ops import solve as sv
    from predictionio_tpu_torch.streaming import (
        EventCursor,
        StreamConfig,
        StreamTrainer,
    )

    # -- (a) the CLI's six entries on the card, in a fresh process ------
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli",
         "audit-lifecycle", "--format", "json"],
        cwd=ROOT, capture_output=True, text=True, timeout=AUDIT_TIMEOUT_S)
    cli_s = time.perf_counter() - t0
    check(out.returncode == 0,
          f"cli audit-lifecycle exited {out.returncode}: "
          f"{out.stdout[-3000:]} {out.stderr[-3000:]}")
    cli_manifest = json.loads(out.stdout)
    check(set(cli_manifest["entries"]) == set(la.ENTRY_POINTS)
          and all(v == 0 for rec in cli_manifest["entries"].values()
                  for v in rec.values()),
          f"cli audit-lifecycle census: {cli_manifest['entries']}")
    print(f"phase audit cli: audit-lifecycle on the card, "
          f"{len(cli_manifest['entries'])} entries x "
          f"{cli_manifest['cycles']} cycles clean against the all-zero "
          f"baseline in {cli_s:.2f}s (fresh process) | "
          f"{out.stderr.strip().splitlines()[-1]}", flush=True)

    U, V = uv
    U64 = torch.from_numpy(U).to(dev, torch.float64)
    V64 = torch.from_numpy(V).to(dev, torch.float64)
    storage = Storage(env={"PIO_HOME": home})
    # every kernel counted in every cycle of both entries
    counters = {"fused_topk": ft, "fused_gram": fg, "chol_solve": sv,
                "gram_table": gram}
    try:
        # -- (b1) engine_server at the serving width -------------------
        rng = np.random.default_rng(29)
        queries = [{"user": f"u{u}", "num": 10}
                   for u in rng.integers(0, N_USERS, AUDIT_QUERIES)]
        serve_args = cli._parser().parse_args([
            "deploy", "--engine-json",
            str(Path(home) / "jaxblob" / "engine.json"), "--ip",
            "127.0.0.1", "--port", "0", "--batching"])
        eng = CycleLog(counters)

        def build_engine(device):
            def cycle():
                srv = cli.build_deploy(serve_args, storage)
                srv.start_background()
                try:
                    warmed(srv)
                    eng.tables(srv.query_server.models[0])
                    answers = [_post(srv.port, q)[0] for q in queries]
                finally:
                    srv.close()
                fleet_f64_check("phase audit engine_server", queries,
                                answers, U64, V64, dev)
            return eng.wrap(cycle)

        res = audit_entry("engine_server", build_engine, "cli deploy of "
                          "the serving width -> 64 queries -> close", dev)
        audit_line("engine_server", eng, res, card)
        check(not res["violations"], f"engine_server: {res['violations']}")
        check(not memory_gate(eng), f"engine_server: {memory_gate(eng)}")
        check(all(r["launches"]["fused_topk"] > 0 for r in eng.rows),
              "engine_server: a cycle launched fused_topk no time")

        # -- (b2) stream_trainer on phase 8's store --------------------
        users, items = data[0], data[1]
        store = users % PIO_USER_STRIDE == 0
        pool_u = np.unique(users[store])
        pool_i = np.unique(items[store])
        app = storage.apps().get_by_name(PIO_APP)
        cur = EventCursor(storage, app.id, AUDIT_CONSUMER)
        t_next = [int(time.time() * 1000)]
        cur.position = from_millis(t_next[0])
        cur.save()
        fold_args = cli._parser().parse_args([
            "deploy", "--engine-json", pio["engine_json"], "--ip",
            "127.0.0.1", "--port", "0"])
        stream = CycleLog(counters)
        consumed, refused = [], []

        def build_stream(device):
            def cycle():
                who = rng.choice(pool_u, AUDIT_BURST_USERS, replace=False)
                t_first = max(int(time.time() * 1000), t_next[0] + 1)
                events = [Event(
                    event="rate", entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item", target_entity_id=f"i{i}",
                    properties=DataMap({"rating": float(
                        rng.integers(1, 6))}),
                    event_time=from_millis(t_first + n))
                    for n, (u, i) in enumerate(
                        (u, i) for u in who
                        for i in rng.choice(pool_i, AUDIT_USER_EVENTS,
                                            replace=False))]
                t_next[0] = t_first + len(events)
                storage.events().insert_batch(events, app.id)
                srv = cli.build_deploy(fold_args, storage)
                srv.start_background()
                trainer = None
                try:
                    warmed(srv)
                    stream.tables(srv.query_server.models[0])
                    # the loop never wakes (no bus publisher, an hour's
                    # poll): the pass is this call's, canary gate and all
                    trainer = StreamTrainer(srv.query_server, StreamConfig(
                        app_name=PIO_APP, consumer=AUDIT_CONSUMER,
                        interval_ms=3_600_000.0), bus=InvalidationBus())
                    trainer.start()
                    consumed.append(trainer.consume_once())
                    status = trainer.status()
                finally:
                    if trainer is not None:
                        trainer.stop()
                    srv.close()
                # a refused delta is counted, as phase stream counts it:
                # the pass still folded in, and the census still reads it
                refused.append(status["canaryRejects"])
                check(consumed[-1] == len(events)
                      and status["applies"] + status["canaryRejects"] == 1
                      and not status["lastError"],
                      f"phase audit stream_trainer: consumed "
                      f"{consumed[-1]} of {len(events)}, applies "
                      f"{status['applies']}, canary refusals "
                      f"{status['canaryRejects']}, error "
                      f"{status['lastError']}")
            return stream.wrap(cycle)

        res = audit_entry("stream_trainer", build_stream, "cli deploy of "
                          f"the pio model -> one {AUDIT_BURST_USERS}-user "
                          "burst folded in -> "
                          "stop + close", dev)
        audit_line("stream_trainer", stream, res, card)
        print(f"phase audit stream_trainer: canary refusals a cycle "
              f"{refused} (8 probes a check; counted, as in phase stream)",
              flush=True)
        check(not res["violations"], f"stream_trainer: {res['violations']}")
        check(not memory_gate(stream), f"stream_trainer: "
              f"{memory_gate(stream)}")
        check(all(r["launches"]["fused_gram"] > 0
                  and r["launches"]["chol_solve"] > 0 for r in stream.rows),
              "stream_trainer: a cycle launched fused_gram or chol_solve "
              "no time")
    finally:
        storage.close()
    # the measured cycles of both entries (not the warm-ups)
    launched = {k: sum(r["launches"][k] for log in (eng, stream)
                       for r in log.rows[1:]) for k in counters}

    # -- (c) the gate bites: a leaky entry, both gates -----------------
    findings = check_source(
        AUDIT_LEAKY_SRC, path="predictionio_tpu_torch/server/leaky.py")
    check([f.rule for f in findings] == ["leaked-thread"],
          f"the static rule on the leaky poller: {findings}")
    ns: dict = {}
    exec(AUDIT_LEAKY_SRC, ns)  # noqa: S102 — the fixture above
    kept = []
    leaky = CycleLog({}, gate=AUDIT_TABLE_BYTES)

    def build_leaky(device):
        def cycle():
            p = ns["LeakyPoller"]()
            p.start()
            p.stop()
            kept.append(torch.empty(AUDIT_TABLE_BYTES // 4,
                                    dtype=torch.float32, device=device))
        return leaky.wrap(cycle)

    try:
        res = audit_entry("leaky", build_leaky,
                          "leaks a thread and 42.3 MB a cycle", dev)
    finally:
        ns["gone"].set()
    census = res["manifest"]["entries"]["leaky"]
    mem_why = memory_gate(leaky)
    check(census["threads"] >= AUDIT_CYCLES
          and any("leaky" in v and "threads" in v
                  for v in res["violations"]),
          f"the census missed the leaked threads: {census}")
    check(bool(mem_why), f"the memory gate missed {len(kept)} kept "
          f"tensors: grew {leaky.growth()}")
    print(f"phase audit leaky: leaked-thread flagged at "
          f"{findings[0].path}:{findings[0].line} | census {census} | "
          f"{mem_why} | both gates caught it", flush=True)
    kept.clear()
    return launched


def check_no_children() -> None:
    """Every process this script started has ended: none has this
    process as its parent."""
    me, left = str(os.getpid()), []
    for d in Path("/proc").iterdir():
        try:
            stat = (d / "stat").read_text()
        except (OSError, ValueError):
            continue
        if d.name.isdigit() and stat.rsplit(")", 1)[1].split()[1] == me:
            left.append(f"{d.name} {stat.split()[1]}")
    check(not left, f"processes left running: {left}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    with phase("card"):
        card = phase_card()
    with phase("build"):
        phase_build()
    with phase("check"):
        checked = phase_check(card)
        check_l, check_hlo_l = checked["launches"], checked["hlo_launches"]
    dev = torch.device("cuda", torch.cuda.current_device())
    rng, U, V = make_tables(args.seed)
    with phase("kernel"):
        row = phase_kernel(rng, U, V, dev)
    with phase("slice"):
        launches = phase_slice(rng, U, V, dev)
    with phase("telemetry"):
        telemetry_l = phase_telemetry(rng, U, V, dev, card)
    with phase("cache"):
        cache_l = phase_cache(rng, U, V, dev, card)
    del U, V
    from predictionio_tpu_torch.models import als

    data, times = load_surrogate(args.seed, with_times=True)
    params = als.ALSParams(rank=RANK, num_iterations=TRAIN_ITERS)
    with phase("train-kernel"):
        t0 = time.perf_counter()
        packed = als.pack_ratings(als.RatingsCOO(*data), params, device=dev)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        print(f"phase train-kernel: pack_ratings alone {pack_s:.3f}s",
              flush=True)
        gram_row, solve_row, per_iter, table_block = phase_train_kernel(
            packed, params, dev)
        del packed
    with phase("train"):
        trained = phase_train(data, dev)
    with phase("implicit"):
        implicit = phase_implicit(data, dev)
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with phase("resume"):
        resume_work = Path(tempfile.mkdtemp(prefix="resume_", dir=scratch))
        try:
            resume_l = phase_resume(data, dev, resume_work, card)
        finally:
            shutil.rmtree(resume_work, ignore_errors=True)
    with phase("sequential"):
        seq_l = phase_sequential(data, times, dev, card)
    with phase("stream-kernel"):
        stream_kernel_l = phase_stream_kernel(trained.pop("item_factors"),
                                              args.seed, dev)
    with phase("ring"):
        phase_ring(args.seed, dev, card)
    bd = trained["breakdown"]
    other = bd["device_ms"] - bd["fused_gram"] - bd["chol_solve"]
    print(f"phase train where the time goes, one profiled iteration ms: "
          f"wall={bd['wall_ms']:.3f} fused_gram={bd['fused_gram']:.3f} "
          f"chol_solve={bd['chol_solve']:.3f} other_kernels={other:.3f} "
          f"device_idle={bd['wall_ms'] - bd['device_ms']:.3f} | kernel "
          f"phase sums at the same shapes: fused_gram="
          f"{per_iter['gram_ms']:.3f} chol_solve={per_iter['solve_ms']:.3f}",
          flush=True)
    with phase("gram-table"):
        table_row = phase_gram_table(args.seed, table_block, dev)
        del table_block
    home = tempfile.mkdtemp(prefix="pio_home_", dir=scratch)
    try:
        with phase("pio"):
            # the whole phase traced: ingest and the store read launch
            # nothing
            pio, _ = profile_device("phase pio profile, the whole phase",
                                    lambda: phase_pio(data, dev, home))
        with phase("storage"):
            storage_l = phase_storage(data, dev, home, pio, card)
        with phase("train-mesh"):
            mesh_train_l = phase_train_mesh(
                data, dev, trained["host_factors"], home, pio,
                storage_l["remote"], card)
        with phase("batchpredict"):
            batch_launches = phase_batchpredict(data, dev, home, pio)
        with phase("eval"):
            eval_l = phase_eval(dev, home)
        with phase("stream"):
            stream_l = phase_stream(data, dev, home, pio, args.seed)
        with phase("templates"):
            templates_l = phase_templates(data, dev, home, args.seed, card)
        with phase("sequential-pio"):
            seq_pio_l = phase_sequential_pio(data, times, dev, home, card)
        with phase("classification"):
            cls_l = phase_classification(dev, home, args.seed, card)
        with phase("release"):
            rel_l = phase_release(data, dev, home, pio, card)
        with phase("console"):
            console_l = phase_console(dev, home, pio, card)
        uv = trained.pop("host_factors")
        with phase("jaxblob"):
            jaxblob_l = phase_jaxblob(uv, dev, home, card)
        with phase("fleet"):
            fleet_l = phase_fleet(uv, dev, home, card)
        with phase("mesh"):
            mesh_l = phase_mesh(uv, dev, home, card)
        with phase("audit"):
            audit_l = phase_audit(uv, dev, home, pio, data, card)
    finally:
        shutil.rmtree(home, ignore_errors=True)
    # launches: each kernel's main path (serving for fused_topk,
    # training for the others); batch_launches: the batchpredict job's;
    # eval_launches: the serial cli eval's; stream_launches: the stream
    # phase's path; implicit_launches: the implicit ML-20M iteration's;
    # templates_launches: the two templates' cli train and deploy (the
    # templates score on the host: fused_topk 0); sequential_launches,
    # sequential_pio_launches, classification_launches: the new phases'
    # (no TPU kernel is on their paths: each reads 0); release_launches:
    # the release phase's (two trainings, then both arms' serving);
    # telemetry_launches: the telemetry phase's two counted bursts;
    # storage_launches: the storage phase's REMOTE training and its deploy;
    # resume_launches: the resumed training's (iterations 6-10);
    # split_launches: one split-layout training's; split_mesh_launches:
    # the split layout over 4 positions (2 explicit iterations and 1
    # implicit); jaxblob_launches: the
    # deploy of the JAX-written blob; fleet_launches: the fleet process's
    # (its replicas' serving and warm-up ladders) and the in-process
    # autoscaled fleet's; mesh_launches: phase mesh's (the sharded
    # rankings, the lane processes' bursts and warm-ups, the sharded
    # stream's fold-in and queries, the pinned lanes' serves);
    # audit_launches: phase audit's measured full-width cycles (serving
    # for fused_topk, the fold-ins for the others); check_launches: phase
    # check's audit-numerics census, its 13 entries summed;
    # check_hlo_launches: its audit-hlo census, the 8 entries' two runs
    # and the seeded fault summed
    implicit_l = implicit["launches"]
    store_l = storage_l["launches"]
    kernels = [
        dict(name="fused_topk", route="cuda",
             source="predictionio_tpu_torch/csrc/fused_topk.cu",
             replaces="predictionio_tpu/ops/fused_topk.py:97",
             launches=launches, batch_launches=batch_launches,
             eval_launches=eval_l["fused_topk"],
             stream_launches=stream_l["fused_topk"],
             implicit_launches=implicit_l["fused_topk"],
             templates_launches=templates_l["fused_topk"],
             sequential_launches=seq_l["fused_topk"],
             sequential_pio_launches=seq_pio_l["fused_topk"],
             classification_launches=cls_l["fused_topk"],
             release_launches=rel_l["fused_topk"],
             console_launches=console_l["fused_topk"],
             telemetry_launches=telemetry_l["fused_topk"],
             cache_launches=cache_l["fused_topk"],
             storage_launches=store_l["fused_topk"],
             pio_feedback_launches=pio["feedback"]["fused_topk"],
             resume_launches=resume_l["fused_topk"],
             jaxblob_launches=jaxblob_l["fused_topk"],
             fleet_launches=fleet_l["fused_topk"],
             mesh_launches=mesh_l["fused_topk"],
             audit_launches=audit_l["fused_topk"],
             check_launches=check_l["fused_topk"],
             check_hlo_launches=check_hlo_l["fused_topk"], **row),
        dict(name="fused_gram", route="cuda",
             source="predictionio_tpu_torch/csrc/fused_gram.cu",
             replaces="predictionio_tpu/ops/fused_gram.py:93",
             launches=trained["launches"]["fused_gram"],
             eval_launches=eval_l["fused_gram"],
             stream_launches=stream_l["fused_gram"],
             implicit_launches=implicit_l["fused_gram"],
             templates_launches=templates_l["fused_gram"],
             templates_mesh_launches=templates_l["mesh"]["fused_gram"],
             pio_retrain_launches=pio["retrain"]["fused_gram"],
             sequential_launches=seq_l["fused_gram"],
             sequential_pio_launches=seq_pio_l["fused_gram"],
             classification_launches=cls_l["fused_gram"],
             release_launches=rel_l["fused_gram"],
             telemetry_launches=telemetry_l["fused_gram"],
             cache_launches=cache_l["fused_gram"],
             storage_launches=store_l["fused_gram"],
             resume_launches=resume_l["fused_gram"],
             split_launches=resume_l["split_fused_gram"],
             split_mesh_launches=resume_l["split_mesh_fused_gram"],
             mesh_launches=mesh_l["fused_gram"],
             train_mesh_launches={k: v["fused_gram"]
                                  for k, v in mesh_train_l.items()},
             audit_launches=audit_l["fused_gram"],
             check_launches=check_l["fused_gram"],
             check_hlo_launches=check_hlo_l["fused_gram"], **gram_row),
        dict(name="chol_solve", route="cuda",
             source="predictionio_tpu_torch/csrc/chol_solve.cu",
             replaces="predictionio_tpu/ops/solve.py:126,133",
             launches=trained["launches"]["chol_solve"],
             eval_launches=eval_l["chol_solve"],
             stream_launches=stream_l["chol_solve"],
             implicit_launches=implicit_l["chol_solve"],
             templates_launches=templates_l["chol_solve"],
             templates_mesh_launches=templates_l["mesh"]["chol_solve"],
             pio_retrain_launches=pio["retrain"]["chol_solve"],
             sequential_launches=seq_l["chol_solve"],
             sequential_pio_launches=seq_pio_l["chol_solve"],
             classification_launches=cls_l["chol_solve"],
             release_launches=rel_l["chol_solve"],
             telemetry_launches=telemetry_l["chol_solve"],
             cache_launches=cache_l["chol_solve"],
             storage_launches=store_l["chol_solve"],
             resume_launches=resume_l["chol_solve"],
             split_launches=resume_l["split_chol_solve"],
             split_mesh_launches=resume_l["split_mesh_chol_solve"],
             mesh_launches=mesh_l["chol_solve"],
             train_mesh_launches={k: v["chol_solve"]
                                  for k, v in mesh_train_l.items()},
             audit_launches=audit_l["chol_solve"],
             check_launches=check_l["chol_solve"],
             check_hlo_launches=check_hlo_l["chol_solve"], **solve_row),
        dict(name="gram_table", route="cuda",
             source="predictionio_tpu_torch/csrc/gram_table.cu",
             replaces="predictionio_tpu/ops/gram.py:148",
             launches=pio["gram_table_launches"],
             eval_launches=eval_l["gram_table"],
             stream_launches=stream_l["gram_table"],
             implicit_launches=implicit_l["gram_table"],
             templates_launches=templates_l["gram_table"],
             sequential_launches=seq_l["gram_table"],
             sequential_pio_launches=seq_pio_l["gram_table"],
             classification_launches=cls_l["gram_table"],
             release_launches=rel_l["gram_table"],
             telemetry_launches=telemetry_l["gram_table"],
             cache_launches=cache_l["gram_table"],
             storage_launches=store_l["gram_table"],
             resume_launches=resume_l["gram_table"],
             mesh_launches=mesh_l["gram_table"],
             audit_launches=audit_l["gram_table"],
             check_launches=check_l["gram_table"],
             check_hlo_launches=check_hlo_l["gram_table"], **table_row),
    ]
    print(f"phase stream-kernel launches (the fold-in cases): fused_gram="
          f"{stream_kernel_l['fused_gram']} chol_solve="
          f"{stream_kernel_l['chol_solve']}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    check_no_children()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
