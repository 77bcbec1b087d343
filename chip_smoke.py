#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (nnstreamer_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab PARENT   # K1 and K2: the checkout PARENT against this one
    python3 chip_smoke.py --plane       # only the plane group (its kernels built first)
    python3 chip_smoke.py --sources     # only the model_sources group (K1 built first)
    python3 chip_smoke.py --faults      # only the faults group (K1 built first)
    python3 chip_smoke.py --observe     # only the observe group (K1 built first)
    python3 chip_smoke.py --edge        # only the edge group (K1, K4 built first)
    python3 chip_smoke.py --mesh        # only the mesh group (K1, K3 built first)
    python3 chip_smoke.py --train       # only the train group (no kernel on its path)
    python3 chip_smoke.py --analysis    # only the analysis group (every kernel built first)

Phases, each printed as one JSON line; any failure exits nonzero:

1. build       — compile every CUDA source under nnstreamer_tpu_torch/csrc
                 with nvcc for sm_90a (one nvcc per source, all at once).
2. kernels     — the crop/resize kernel (K1) in both entry points against
                 its plain PyTorch version on the same GPU inputs, at the
                 shapes of both pipelines (720p → 224 and 720p → 300, u8)
                 and others: error, kernel / plain / library device time
                 (torch.profiler; the stream time of back-to-back calls,
                 host dispatch gaps included, beside it), and the bound
                 (bytes over 3.35 TB/s vs float ops over 67 TFLOP/s, the
                 larger); and the crop entry at the routing phase's
                 first region frame (16 boxes → 112x112).
3. pipeline    — the image-labeling pipeline (1280x720 gradient frames →
                 resize 224 → MobileNet-v2 1.0/224/1001 → image_labeling)
                 for 32 frames on the GPU: K1 launched exactly once per
                 frame, the model's outputs on the GPU, the first labels
                 equal to the port's own CPU run; frames per second
                 free-running, and end-to-end latency p50/p99 with the
                 source paced at 30 fps.
3a. segments   — every fused segment is one program per (signature,
                 bucket, fn version), on the card a captured CUDA graph
                 replayed once a frame (ROADMAP A.1): labeling-720p,
                 detection-720p and face-cascade-720p, 32 frames each,
                 every segment's replay bit for bit against
                 process_eager on the same input, K1 (and K2) counted once
                 a frame as replays, which segments replay and which stay
                 eager (an op's CAPTURABLE = False, recorded when the
                 program was filled), host launches a frame eager against
                 replay (torch.profiler, 16 frames) with K1's and K2's
                 device records equal to their counts in both modes, fps
                 over 1536 frames, paced p50/p99 with frame 0 apart, busy
                 share and device ms by class (16 frames); a replayed
                 segment into a depth-8 queue and a slow sink, every frame
                 equal to its eager output (no replay overwrote a frame in
                 flight); labeling with batching=true max-batch=8 bit for
                 bit against batching=false (logits, 32 frames), then 1536
                 frames a run unbatched / batched / batched / unbatched:
                 labels equal, one replay a window, K1 a row,
                 avg-batch-size, pad-waste-pct, fps. Every later phase
                 runs its pipelines' segments captured too.
4. profile     — device time by kernel over 16 labeling frames.
5. single      — SingleShot invoke on the GPU, logits against the CPU's.
6. routing     — the crop cascade routing-crop-720p: videotestsrc
                 device=true (1280x720) → tee → queue → tensor_crop
                 out-size=112:112 max-crops=16 (regions from an appsrc,
                 numpy seed 9, 3 of 16 zero-size, 2 past the edge) and
                 tee → queue → resize 224 → tensor_mux slowest →
                 tensor_demux → two sinks, 32 frames: K1's crop entry and
                 resize entry each launched once a frame, every sink
                 tensor and the regions on the GPU, crops and thumbnails
                 equal to the port's CPU run within K1's tolerance, the
                 zero-size regions' rows all zero; fps, paced p50/p99,
                 device-to-host copies a frame over 16 profiled frames (the
                 sinks' own only) and device time by class; then the 16
                 goldens of the element surface on CUDA tensors, byte for
                 byte against tests/golden.
7. nms_kernels — the greedy NMS kernel (K2: the mask kernel and the scan)
                 against its plain version on the same GPU inputs (registry
                 shapes n = 32 and 100, the 1917 candidates of a real SSD
                 output frame, n = 6300 and 25200, a case of tied scores,
                 n = 63, 64, 65 and 129 at the word edges, 2000 with 90 %
                 dead): alive masks, keep_idx and keep_score bit-identical;
                 up to n = 2048 every mask word the kernel wrote equal to the
                 plain twin's (plain_nms_bitmask); kernel device time (the
                 sum of both kernels' means) and plain device time (and one
                 call timed alone with CUDA events), time per greedy step,
                 the scan's word blocks (rounds), the workspace, the bound.
8. detection   — the detection pipeline (1280x720 → resize 300 →
                 SSD-MobileNet-v2 → bounding_boxes postproc=device) for 32
                 frames: K1 and K2 each launched exactly once per frame,
                 the filter's outputs on the GPU, the first detections
                 equal to the port's own CPU run; fps and paced p50/p99;
                 then the host-render form (postproc=auto, RGBA overlay)
                 for 4 frames, K2 once per frame.
9. detection_profile — device time by class over 16 detection frames.
10. single_ssd  — SingleShot zoo:ssd_mobilenet_v2_pp (NMS inside the model)
                 on the GPU against the CPU, K2 once per invoke.
11. attn_kernels — the decode-attention kernel (K3: the split kernel and
                 its combine) against its plain version on the same GPU
                 inputs: the JAX kernel registry's shapes, a wrapped
                 absolute pos, the serving shape (B 8, H 32, KV 8, D 128,
                 S 4096) in float32, bfloat16 and int8, fills spread over
                 the window and at pos 600, one slot at pos 4095 (long1),
                 and the kernel's other instances (D 256 and 64, head
                 groups of 32, 16 and 3, 24- and 20-byte rows); error,
                 kernel device time (the sum of each kernel's mean) with
                 the CUDA-event stream time of back-to-back calls beside
                 it, plain and library (scaled_dot_product_attention) time,
                 the bound (cache bytes over 3.35 TB/s), and the split
                 launch (chunk rows, splits, blocks, workspace bytes).
12. serving    — ContinuousBatcher at Mistral-7B's published widths (32
                 layers, d 4096, 32/8 heads, FFN 14336, vocab 32000),
                 float32, 8 slots, max_len 4096, prompt_len 512, random
                 weights from a seed: 16 greedy requests of 64 tokens
                 (prompts 64-512 and one of 1500, the chunked prefill). K3
                 launched exactly layers x steps; every greedy token equal
                 to the no-cache forward's argmax (near-ties exempt,
                 counted); through-cache logits of four requests against
                 the full forward; decode tok/s, TPOT p50/p99, TTFT p50,
                 a 16-step device profile; the same 8-request traffic
                 with attn_impl="xla" beside it.
13. serving_int8 — the int8 cache at the same widths, 4 layers, bfloat16:
                 K3 launches exact; teacher-forced on the batcher's
                 tokens, K3's greedy choices equal the inline attention's
                 on the same cache (near-ties exempt), in bfloat16 and in
                 float32, and the float32 logits agree.
14. llm_pipeline — appsrc ! tensor_llm_serversink attn-impl=pallas ...
                 tensor_llm_serversrc ! tensor_sink through parse_pipeline
                 on the GPU (Mistral attention widths, 2 layers): every
                 request back with its meta, K3 launches = layers x steps,
                 generations equal to a directly built batcher's.
15. paged_kernels — the block-table decode-attention kernel (K4: the split
                 kernel and its combine) against its plain version on the
                 same GPU inputs: the JAX kernel registry's shapes, pos 0
                 (the fresh column alone), pos past the table, NaN outside
                 the live history, the serving shape (B 8, H 32, KV 8,
                 D 128, bs 16, nb 256, 1025 blocks, random tables) in
                 float32, bfloat16 and int8 at fills spread over the window
                 and at pos 600, one slot at pos 4095, and the instances of
                 phase 11; error, kernel / stream / plain time, K3's time at
                 the same fills, the bound, the split launch, and a gather +
                 scaled_dot_product_attention yardstick (two calls; no
                 PyTorch call attends through a block table).
16. paged_serving — ContinuousBatcher(kv_layout="paged", block_size=16,
                 kv_blocks=1024, attn_impl="pallas") at the same Mistral-7B
                 widths, 32 layers float32: 16 greedy requests of 64 tokens,
                 8 of them chat prompts behind one 256-token system prompt
                 (prefix hits, seeded chunked prefill) and one of 1500
                 tokens (chunked prefill interleaved with decode). K4 =
                 layers x steps, K3 = 0; every greedy token equal to the
                 no-cache forward's argmax (near-ties exempt); logits
                 through the arena against the full forward; no block in
                 use after the drain; decode tok/s, TPOT, TTFT beside the
                 slot layout's, a 16-step device profile, the arena's GB,
                 and attn_impl="xla" on the same layout (8 requests).
17. paged_preempt_int8 — 4 layers: a pool of 264 blocks (one max_len
                 request and a little) under 8 requests of 600-1200 prompt
                 tokens and 256 new ones, so decode growth preempts and
                 re-prefills; every stream equal to its unpreempted run
                 under the margin rule; then the int8 arena in bfloat16, K4
                 against the inline attention under the same rule.
18. paged_pipeline — the llm_pipeline phase with kv-layout=paged
                 block-size=16 kv-blocks=1024: K4 = layers x steps,
                 generations equal to a directly built paged batcher's, no
                 block in use at the end.
18a. serving_graphs — the serving engine's one-program pump (ROADMAP
                 A.2): every step() and step_pump(n) is one pump program,
                 on the card a CUDA graph replayed with K3 / K4 inside it,
                 so phases 12-18 above run captured. At Mistral-7B's widths
                 (8 layers since PR 15, float32), for the slot (K3) and the paged
                 (K4) layout, the phase's 16-request x 64-token traffic on a
                 fresh batcher per run, eager oracle (step_eager /
                 step_pump_eager) and replays in turns (eager, replay,
                 replay, eager): every stream equal to the first eager
                 run's (near-ties exempt by the no-cache forward's top-2
                 margin), K3 / K4 counted = layers x steps in every run,
                 every replayed program captured; TPOT p50/p99, decode and
                 served tok/s, admit step and TTFT per run; the programs'
                 build_s, warm-up launches, allocated and reserved pool
                 bytes, host_state_builds; then a full batch for 16 steps
                 (two pumps of 8) eager and replayed under torch.profiler:
                 host kernel / graph launches and memcpy calls a pump
                 (replayed: exactly one cudaGraphLaunch a pump), K3's / K4's
                 split and combine device records equal to 2 x their
                 counted launches = layers x steps in both modes (replayed,
                 the counts are the capture's tally), device ms a
                 step by class and busy share, beside the matmuls' bound a
                 step (every weight read once at 3.35 TB/s). Each of the
                 decode step's five matmul shapes at M = 8, eager against a
                 replay (bit-equal or not, reported). Then 4 layers, 12
                 requests sampling (top-k, top-p, greedy mixed), both
                 layouts: the replayed sampling pump's tokens equal the
                 eager oracle's.
18b. speculative — speculative decoding and registered prefixes (ROADMAP
                 A.4, first half): every spec_step / spec_pump(rounds, k,
                 ngram) is one spec program of whole rounds (propose →
                 verify → accept → commit), on the card a CUDA graph.
                 spec_ngram, slot and paged (block), Mistral-7B widths,
                 SPEC_LAYERS layers (8 since PR 16, from 32), float32,
                 16 requests x 64 tokens, half of them
                 periodic prompts: the plain pump's streams (K3 / K4 =
                 layers x steps) as the oracle, then spec_pump(2, 4, 2)
                 eager and replayed on fresh batchers: replayed = eager
                 token for token, spec = plain (near-ties exempt by the
                 no-cache forward's top-2 margin), accepted tokens > 0,
                 acceptance rate, tokens a round, ms a stream waits for a
                 token spec against plain (p50/p99 over full-batch runs),
                 the spec programs and their pool bytes; a full batch of
                 two spec pumps under torch.profiler: one cudaGraphLaunch
                 and no kernel launch a replayed pump, device ms a round by
                 class (weight matmuls / verify attention / other, from the
                 eager profile with the verify attention annotated) and
                 the busy share. spec_draft_self (4 layers since PR 15):
                 the target as its own draft (shared weights, its own
                 cache), 8 requests, spec pumps between plain pumps:
                 acceptance 1.0 (a rejection only where the no-cache
                 forward has a near-tie), streams = plain. spec_sampling
                 (4 layers, both layouts, greedy / top-k / top-p mixed):
                 replayed = eager token for token.
                 prefixes (both layouts, full width, SPEC_LAYERS): a 256-token
                 registered prefix and 8 prefix= requests against the same
                 requests concatenated on a fresh batcher: streams equal
                 (margin rule), admission ms with and without the prefix,
                 K3 / K4 = layers x steps on the decode that follows.
18c. serving_state — the sliding-window ring, snapshot/restore and KV-span
                 migration (ROADMAP A.4b). windowed_ring: Mistral-7B widths
                 (STATE_LAYERS layers: 8 since PR 16, from 32; float32) on
                 its published window (max_len =
                 sliding_window = 4096, prompt_len 512, K3), 8 requests of
                 3584 prompt tokens (7 ring-prefill buckets; half periodic)
                 and 1024 new ones, so every slot wraps the ring at its
                 512th token: replayed pumps of 8 (K3 = layers x steps, one
                 cudaGraphLaunch a pump before and after the wrap, device
                 bytes allocated flat across it), a snapshot at 480 tokens;
                 from it the eager oracle for 64 steps across the wrap and a
                 restored replayed run to the end, both equal to the
                 uninterrupted streams; every stream held to a
                 teacher-forced sliding-window forward (a causal band of
                 width 4096 at T 4608) under the margin rule; TPOT before and
                 after the wrap, ring prefill ms, snapshot / restore ms and
                 host bytes, device ms a step by class; K3 at pos 3600 and
                 saturated (wrapped-s4096) against its plain version.
                 windowed_spec: spec_pump(2, 4, 2) for 32 rounds from the
                 snapshot, replayed = eager, streams = the uninterrupted
                 ones (margin rule), acceptance on the periodic half, one
                 cudaGraphLaunch a spec pump; the ring self-draft at 4 layers
                 (replayed = eager, every proposal accepted but at
                 near-ties). snapshot_restore_paged: the paged_serving
                 configuration, a snapshot with 8 live requests restored
                 into a fresh batcher and into one that has replayed its
                 programs: the pool's accounting equal to the snapshot's,
                 continued streams bitwise, K4 = layers x steps.
                 migrate_spans: two paged batchers, 4 requests behind a
                 256-token system prompt extracted, encoded, decoded and
                 adopted cold (bitwise), warm (the destination holds the
                 system prompt: fewer bytes by the stripped blocks exactly,
                 bitwise) and by resume_from_span (margin rule): ms and
                 GB/s a request; the int8 arena at 4 layers. checkpoints:
                 tensor_llm_serversink kv-layout=paged
                 checkpoint-every-tokens=8 at 4 layers, the server dropped
                 without a drain, a new one on the same directory adopts
                 every span (no prefill queued) and finishes the streams
                 bitwise, reaping the files.
19. flash_kernels — the flash prefill attention kernel (K5) against its
                 plain version on the same GPU inputs: the JAX kernel
                 registry's six shapes, the main path's B 1, T 4096, H 32,
                 D 128 causal in float32, bfloat16 and float16, T 1500 (a
                 ragged tail), T 4096 non-causal, and head dims 8, 48, 64,
                 96 and 256; error (<= 2e-5), non-finite outputs, kernel /
                 plain device time, one launch alone, the bound (operations
                 at the route's tensor-core rate: a third of 495 TFLOP/s
                 TF32 for float32's three products, 989 for 16-bit; or
                 bytes), the CUDA-core float32 bound beside it, and
                 scaled_dot_product_attention on the same data (its kernel
                 named); then a CUDA call at D 12 raises with no launch.
20. flash_forward — the no-cache forward (tokens [1, 4096] → logits) of
                 Mistral-7B's published widths, 32 layers, with attn_fn =
                 K5 against dense attention, float32 and bfloat16 compute:
                 K5 = 32 launches a forward (dense 0), argmax agreement at
                 every position (near-ties exempt; in bfloat16 the gate is
                 the drift from the float32 forward, at most twice dense's),
                 ms a forward, prefill tokens/s, peak device memory, and a
                 device profile of one forward by class.
21. flash_pipeline — appsrc ! tensor_filter model=zoo:transformer_lm
                 attn:flash (Mistral attention widths, 4 layers, the zoo's
                 FFN 4 x d) ! tensor_sink through parse_pipeline against the
                 same pipeline with attn:dense: K5 = 4 x frames, argmax
                 agreement (near-ties exempt); then one frame of each with
                 compute_dtype:float16: K5 = 4 launches, finite logits, and
                 the flash forward's drift from the float32 dense logits at
                 most twice the dense float16 forward's.
22. lm_int8w_beam — 4 layers at the same widths, quantize:int8w: the flash
                 forward against dense, the weight bytes against float32,
                 generate through a filter pipeline equal to decode.generate
                 on the same quantized module, decode=beam beam_width=1
                 equal to greedy, and a width-4 beam's score equal to the
                 teacher-forced log-prob of its tokens.

Then the vision group (queue A.3), at the zoo's full default widths:

10a. face_cascade — routing-crop-720p with its models: videotestsrc
                 device=true 1280x720 → tee; queue → resize 128 →
                 zoo:face_detect output=regions frame_size=1280:720
                 threshold 0.0 → tensor_crop's regions; queue → its image;
                 tensor_crop out-size=112:112 max-crops=16 →
                 zoo:face_landmark batch 16 → sink, 32 frames: K1's crop
                 and resize entries once a frame each, landmarks against
                 the CPU run (1e-3), D2H copies only the sink's (16
                 profiled frames), fps, paced p50/p99, device ms by class.
10b. composite_fused — zoo:face_composite at 128 through a filter, float32
                 and bfloat16: K1's crop entry once a frame on the float
                 image, outputs against the CPU run, fps.
10c. yolo_detection — 720p → resize 320 → zoo:yolov5 (80 classes, width
                 32) → bounding_boxes yolov5 postproc=device: K1 and K2
                 once a frame, K2 at n = 6300, detections equal to the CPU
                 run's, fps, paced p50/p99, device ms by class.
10d. pose_segment — zoo:posenet → pose_estimation heatmap-offset and
                 zoo:deeplab_v3 → image_segment tflite-deeplab, postproc
                 device, 257: against the CPU run, fps each.
10e. mobilenet_int8 — zoo:mobilenet_v2 224/1001 quantize int8 and int8w:
                 logits against the CPU (int8 10 % of max |logit|: quantum
                 flips; int8w 1e-3), top-1 agreement with the float model,
                 fps; int8 at size 96 (9-row int8 GEMMs) against the CPU.
10f. vision_kernels — K1 at the composite's crop (its detector's boxes on
                 128², float32 and bfloat16 → 16 x 112²) and at the face
                 detector's 720p regions (uint8); K2 on a real YOLO frame's
                 6300 candidates; each against its plain version.

Then the codecs group (queues A.1 and A.2: wire codecs, script
subplugins, fake backends, the flexible-input filter):

10g. codec_goldens — the nine goldens of A.1 through parse_pipeline on
                 CUDA, byte for byte; composite_face with both filters on
                 device:0 against the port's CPU run (1e-3), and the
                 golden's own device:1 refused before the landmark model
                 loads.
10h. codec_roundtrip — codec-roundtrip-720p: 1280x720 frames →
                 tensor_decoder mode=M → tensor_converter mode=M → sink for
                 M in flexbuf, protobuf, flatbuf, 32 frames: every sink
                 tensor on the GPU and equal to its source frame, frame 0's
                 wire bytes equal to the CPU encoding; fps, encode and
                 decode host ms a frame, D2H and H2D copies a frame over 16
                 profiled frames (limit: the decoder's D2H and the
                 converter's H2D, beside the sink's and the ingress's).
10i. codec_labeling — codec-labeling-720p: the labeling pipeline with a
                 protobuf decoder → converter pair between resize and
                 MobileNet-v2, whose filter takes the flexible stream: K1
                 once a frame, labels equal to the pipeline phase's,
                 logits against the codec-free run (8 frames), fps, paced
                 p50/p99 beside the pipeline phase's.
10j. codec_cli — the CLI in four subprocesses on the card, no --device:
                 filter_python3 and filter_scaler byte for byte,
                 composite_face (device:0) within 1e-3 of the CPU run (the
                 CLI leaves TF32 as the port's device setup has it),
                 bad_mesh refused naming 999 devices without a traceback;
                 then the python3 filter script on 16 720p frames: 255 -
                 frame, copies a frame, fps.

Last, the plane group (ROADMAP A.4c, the serving plane's core; alone with
``--plane``):

23. plane_pipelines — ONE description with two streams (720p gradient and
                 counter, 256 frames each → resize 224 → tensor_filter
                 zoo:mobilenet_v2 plane= → image_labeling): every plane
                 program captured before the clock starts; K1 once a
                 frame of both streams; frames a dispatch above 1 (the
                 streams batched together); one plane graph replay a
                 dispatch, and capture.replay's counter equal to the
                 plane's replays plus the segments'; every batched row bit
                 for bit against the plane's invoke_one of that frame;
                 labels equal to the same description with two private
                 filters, logits (16 frames a stream) within 1e-4 of max
                 |logit|; fps a stream and both from three runs each
                 through the plane at ring-depth 1 and 2 and through two
                 private filters, interleaved (PLANE_RUNS), every run
                 checked for K1 a frame and the private labels in order;
                 the busy share of a 16-frame plane run.
24. llm_plane   — two tensor_llm_serversink / serversrc pairs in one
                 description on one plane= (zoo:transformer_lm at
                 Mistral-7B's widths, LLM_PLANE_LAYERS layers, float32,
                 kv-layout=paged, block 16, pump=8, greedy), 4 requests of
                 64-512 prompt tokens and 192 new tokens a stream: each
                 serversrc emits only its own requests, one cudaGraphLaunch
                 a pump (capture.replay's counter around each pump), K4 =
                 layers x steps, kv_gather_dispatches 0; after the plane is
                 released, a private paged batcher on the same weights and
                 prompts: every generation equal, or parting at a near-tie
                 of the no-cache forward; TPOT p50 through the plane and
                 private.

Last, the model_sources group (ROADMAP A.3 + A.5; alone with ``--sources``):

25. vit_labeling — 720p gradient frames → resize 224 (K1) → zoo:vit
                 (ViT-S/16 at the zoo's defaults, float32) → image_labeling,
                 32 frames: one segment replay a frame, K1 once a frame,
                 every replay bit for bit against process_eager; logits
                 (2 frames) within 1e-4 of max |logit| of the same module
                 on the CPU, top-1 equal; fps (512 frames); busy share and
                 device ms by class over 16 profiled frames.
26. kws_audio   — audiotestsrc one-second 16 kHz clips → zoo:kws
                 samples:16000 → image_labeling, 32 frames: labels equal to
                 the CPU run's, logits (4 frames) within 1e-4 of max
                 |logit|, one replay a frame; fps (512 frames); device ms
                 by class over 16 profiled frames.
27. tflite_program — a MobileNet-v2 1.0/224/1001 .tflite written by this
                 script (FlatWriter, seeded weights, batch norm folded,
                 TFLite SAME padding): tools/tflite_parse gives back what
                 was written; the labeling pipeline with a typecast and
                 tensor_filter framework=torch model=<file>, 32 frames: one
                 replay a frame, K1 once a frame, replays bit for bit, the
                 program's constants on the card and no TFLite interpreter
                 imported, logits within 1e-4 of max |logit| of the same
                 program on the CPU; load_tflite_params of the file against
                 the program; fps (512 frames); device ms by class over 16
                 profiled frames.
28. script_models — a TorchScript .pt (framework=auto) and a get_model .py
                 (framework=torch, and framework=auto, which the priority
                 table sends to the custom backend's CustomFilter of the
                 same script) through SingleShot on the card: outputs on
                 the card, equal to the module's eager output (the
                 TorchScript within 1e-6 of max |y|).

Last, the faults group (ROADMAP A.6a; alone with ``--faults``), each phase
on labeling-720p (1280x720 gradient → resize 224 (K1) → zoo:mobilenet_v2 at
the zoo's defaults → image_labeling), 64 frames a run, after an unfaulted
run's labels and logits, the oracle of every check:

29. compile_fallback — a ``faulty traceable:true compile_fail:true
                 compile_fail_first_n:2`` filter fused between the resize
                 and the model, device_probe_every 16: the build at start
                 fails, the circuit opens at the first frame; the 32 open
                 frames run the segment eagerly (K1 once a frame, no graph
                 replay), the probe at frame 17 fails to build, the one at
                 frame 33 builds and closes it, and every later frame is
                 one replay with K1 in it; the circuit's counters are the
                 ones tests/test_torch_device_faults.py holds equal to the
                 JAX package's; labels and logits bit for bit the unfaulted
                 run's; fps while open and while closed.
30. oom_ladder  — max-batch=8 over ``faulty oom_above_rows:2``: the
                 governor's cap settles at 2, no bucket above 2 replays,
                 every frame arrives with the unbatched labels;
                 oom-policy=stop ends with DeviceOOMError; one allocation
                 past mem_get_info's free bytes raises
                 torch.OutOfMemoryError, classified oom, and the next
                 labeling run completes with the same labels.
31. filter_replicas — replicas=2 replica-devices=0,0: logits bit for bit
                 one instance's, invokes 32 and 32; a ``faulty replicas=2
                 device_lost_at:9 only_replica:0`` filter in the segment's
                 place: every frame delivered, replica 0 benched, the
                 replica counters equal the same run's on the CPU.
32. plane_replicas — two labeling streams on plane-mode=replicas
                 plane-devices=2 (both replicas on the one card): every
                 batched row bit for bit the frame alone, one graph replay
                 a dispatch, windows on both replicas; then replica 0 lost
                 (a typed DeviceLostError from its second window on): every
                 window fails over whole and each stream keeps its order.
33. warm_restart — the oom_ladder run drained after 32 frames,
                 save_snapshot, stop, a new executor restored from the file
                 and resumed: the remembered cap keeps every replay at
                 bucket 2 or below, no new OOM, the frames add up to 64;
                 then an in-place drain / resume delivers every frame.

Last, the observe group (ROADMAP A.6b; alone with ``--observe``), the
labeling pipeline at full width with ``! queue !`` before the filter
(1280x720 gradient → resize 224 (K1) → queue → MobileNet-v2 1.0/224/1001
→ image_labeling), 64 frames a run. The chain's head node starts once the
source has queued all 64 frames, so every window is full (a saturated
stream; a trickle runs smaller buckets):

34. chain_program — chain-mode auto against off: labels and logits bit
                 for bit, 16 replays of the chain's graph (64 / unroll 4)
                 against 128 segment replays, K1 64 in both, chain_fallback
                 0, the member segments' graphs never built in the chain
                 run; then a device fault injected at the third window
                 latches the per-node path (the members' own graphs on the
                 card): labels still equal, K1 still 64, chain_fallback 56;
                 fps and per-node p50 host time (metrics on) for chain on
                 and off and for routing-crop-720p.
35. frame_ring  — ring-depth 1 against 2 (chain off): frames in order and
                 bit for bit, D2H bytes in the transfer tally equal to
                 frames × the decoder's device output bytes (no interior
                 bytes), H2D the source frames' bytes.
36. observe_cli — nns-launch in a subprocess on cuda with --stats --metrics
                 --trace --profile over 32 frames: a latency row and an
                 nns_element_latency_us series for every node, a span for
                 every frame at every per-frame node (the chain node's
                 batch spans add up to the frames), K1's kernel name in the
                 torch.profiler trace.

Last, the edge group (ROADMAP A.7; alone with ``--edge``), with metrics on:

37. query_labeling — the labeling pipeline split across the wire, 64
                 1280x720 gradient frames: a query server pipeline
                 (tensor_query_serversrc → resize 224 (K1) → MobileNet-v2
                 1.0/224/1001 → image_labeling → tensor_query_serversink)
                 and a client pipeline (videotestsrc → tensor_converter →
                 tensor_query_client → tensor_sink), both on cuda, over
                 TCP, SHM and HYBRID (discovery through the port's own
                 MqttBroker): labels equal to the local pipeline frame by
                 frame, K1 64 a run, H2D exactly 64 frames' bytes (the
                 client moves none through the card), D2H under 64 B a
                 frame, nns_edge_requests_total 64, no NACK, the native
                 transports; fps and RTT p50/p99 from nns_edge_rtt_us.
38. query_fleet — two such servers behind one tensor_query_client hosts=,
                 the first drained over the wire (request_drain) once 16
                 frames came back: every frame answered once (unique
                 frame_ids, no duplicate reply), labels equal, the drained
                 server draining with its NACKs ``draining``, K1 64.
39. disagg      — tensor_llm_serversink role=prefill decode-peers= against
                 a role=decode peer behind a tensor_query_serversrc, on one
                 card over TCP loopback, at Mistral-7B's widths (vocab
                 32000, d_model 4096, 32 heads, 8 KV heads, d_ff 14336) and
                 4 of its 32 layers, float32, paged: 4 greedy prompts of
                 128-512 tokens, 32 new tokens each, equal to a private
                 paged batcher's solo runs; outcome handoff x 4, the decode
                 peer's kv_prefill_chunks 0, K4 = 4 layers x the steps of
                 both servers; span bytes and GB/s of the extract, the wire
                 and the adopt, the decode peer's TPOT p50. Then a decode
                 peer too small for one span: outcome local, tokens equal.
40. migrate     — drain(migrate_to=peer) on a paged server after 8
                 generated tokens: the 4 requests continue on a peer
                 pipeline, equal to the uninterrupted run, with no prefill
                 on the peer and K4 = 4 x the peer's steps.

Last, the mesh group (ROADMAP A.8a; alone with ``--mesh``, where its
serving check builds weights of its own and an unsharded batcher's tokens
on the same prompts first). The card's machine has one H100, so every mesh
has one position; each check runs the mesh path itself:

41. mesh_serving — run inside the serving phase on its Mistral-7B-width
                 weights (32 layers, float32), once that phase freed its
                 caches: ContinuousBatcher(mesh=make_mesh(1, axes=("dp",)))
                 on the serving traffic's first 8 prompts, 64 new tokens
                 each: tokens equal to the unsharded batcher's, K3 = 32 x
                 steps read from the shard's own counter (and equal to all
                 K3 launches), every pump program the shard's captured
                 graph; the mesh step's ms beside the unsharded step's.
42. mesh_filter — the labeling pipeline (32 frames) with
                 ``custom="mesh:dp1"`` and with
                 ``accelerator=true:gpu:mesh=dp1``: labels equal to the
                 unsharded filter's, K1 32 a run, the model called once a
                 frame by the filter's mesh program on cuda:0.
43. mesh_plane  — two 720p labeling streams (48 frames each) through
                 ``plane-mode=shard plane-devices=1``: labels equal to the
                 single-device plane's, the plane's program ``shard`` over
                 ``mesh_devices`` 1, K1 96.
44. mesh_refusals — ``mesh:dp2``, ``make_mesh(2)`` and ``plane-mode=shard
                 plane-devices=2`` raise, naming "2 devices, have 1".
45. mesh_placement — place_pipeline over the two streams under ``[plane]
                 memory_per_device=64G``: both stages on device 0, left
                 unpinned (fused), labels equal to the plane's; a bound one
                 byte below a stage's estimate raises PlacementError.

Last, the train group (training and sequence parallelism; alone with
``--train``). No hand-written kernel runs on its path: the reference's
training reaches no ``pl.pallas_call`` (K5 has no backward; ring attention
and Ulysses attend in jnp), so the steps run torch ops, their convs and
matmuls cuDNN's and cuBLAS's. Every mesh has one position on the card;
each step's ms (CUDA events) and peak GB are on its phase's line:

46. train_lm    — the dp×sp×ep LM step at Mistral-7B's widths (vocab 32000,
                 d 4096, 32 / 8 heads of 128, FFN 14336), 4 layers, float32,
                 ring attention with kv_chunk 512 on tokens [1, 2049]:
                 three steps on the same tokens, finite and falling, the
                 first loss within 1e-4 relative of dense attention's on the
                 same weights, and its gradient leaf by leaf within 5e-5
                 (reading 8.2e-6); the ring's and dense attention's forward +
                 backward timed alike.
47. train_pipeline — the GPipe forward, pp = 1 over that 4-layer stack, 4
                 microbatches of 256 tokens, within 2e-4 of the sequential
                 forward.
48. train_moe   — Mixtral-8x7B's expert widths (8 experts of 14336, top 2,
                 d 4096) in the reference's two-matrix form, 2 layers,
                 tokens [1, 1025]: the ep path within 1e-5 relative of
                 moe_ffn_dense on layer 0's FFN input; two steps, finite and
                 falling.
49. train_ulysses — the Ulysses step at Mistral-7B's widths, 2 layers,
                 tokens [1, 1025]: finite.
50. train_mobilenet — MobileNet-v2's dp×tp step at 224², 1001 classes,
                 batch 32, three steps on one batch, each loss below the
                 last; batch 4 on the same weights within 1e-4 relative of
                 the port's CPU step, and one float64 step of it against
                 the CPU's, every leaf of the parameters and the momentum
                 within 1e-5 of its largest magnitude (readings 6.1e-8 and
                 1.2e-6; cuDNN's deterministic algorithms).
51. train_checkpoint — its train state (parameters and momentum) saved and
                 restored onto the mesh: eval loss bit-equal, and the next
                 step equal to the uninterrupted one bit for bit (cuDNN's
                 deterministic algorithms for this check).
52. train_multihost — multihost.initialize on nccl at world size 1,
                 barrier, is_primary, process_info, one MobileNet step over
                 the global mesh; a mesh of 2 raises, naming "need 2
                 devices, have 1".

Last, the analysis group (the analysis tooling; alone with ``--analysis``),
on the default device, ``cuda``:

53. analysis_kernels — nns-kscope-torch --json (its default device,
                 cuda) over K1-K5 at the main shapes, exit 0: each
                 Python launch plan (grid, threads, dynamic shared memory)
                 equal to the launch the .cu's host code makes (its
                 ``nns_*_launch_info`` query), every row with its
                 registers, static shared memory, local bytes, blocks an
                 SM and bound; no NNS-W127 or NNS-W128.
54. analysis_dispatch — nns-xray's dispatch table on cuda: every entry
                 point of K1-K5 engaged its kernel, its launch counter moved.
55. analysis_check — ``nns-launch --check`` over the 720p labeling
                 pipeline (exit 0), and over a serving pipeline at
                 Mistral-7B's widths (d_ff 14336, 32 layers, 8 slots x
                 4096) with ``kv-memory-bound=4G``, below its 8 GiB slot
                 cache (exit 1, NNS-W115).
56. analysis_crosscheck — nns-xray over the labeling pipeline with its
                 backends open (one compile unit, the predicted bytes a
                 frame), then 32 frames with ``NNS_XRAY_CROSSCHECK=1``:
                 ``transfer_crosscheck()`` delta 0 for h2d and d2h, K1 once
                 a frame.

After the groups, ``segment_traces``: how many fake-tensor segment traces
(analysis/costmodel.py ``trace_program``, run by every chain verdict and
analyzer) the whole script made, their host seconds and the first one's.

``--ab PARENT`` runs K1's cases and K2 at the SSD frame, 6300 and 25200
candidates with the kernels of the checkout at PARENT (an unpacked `git
archive` of another commit) and with this one's, in four processes of one
call (parent, change, change, parent), each building its own kernels;
beside them the floor of a launch (a one-element ``fill_``); last a summary
of the means and the change / parent ratios.

TF32 is off throughout (cuDNN would otherwise run float32 convolutions,
and the LLM phases' float32 matmuls could run, in TF32), so GPU and CPU
runs and the references compare at float32 precision. The last lines
are the card's name and power limit (nvidia-smi), the kernel summary
``{"kernels": [...]}`` (K1-K5; K1's ``launches_mesh`` and K3's
``launches_mesh_serving`` are the mesh group's, ``launch_analysis`` the
analysis group's row of each kernel) and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import zlib

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_OPS_S = 67e12  # H100 SXM float32 outside the tensor cores
L2_BYTES = 50 * 2**20
FRAMES = 32
PIPELINE = (
    "videotestsrc pattern=gradient width=1280 height=720 num-frames={n}{live} "
    "stamp-wall=true ! tensor_converter ! "
    "tensor_transform mode=resize option=224:224 ! "
    "tensor_filter name=f framework=torch model=zoo:mobilenet_v2 ! "
    "tensor_decoder mode=image_labeling ! tensor_sink name=out"
)
DET_PIPELINE = (
    "videotestsrc pattern=gradient width=1280 height=720 num-frames={n}{live} "
    "stamp-wall=true ! tensor_converter ! "
    "tensor_transform mode=resize option=300:300 ! "
    "tensor_filter name=f framework=torch model=zoo:ssd_mobilenet_v2 ! "
    "tensor_decoder mode=bounding_boxes option1=mobilenet-ssd option3={priors} "
    "postproc={pp} ! tensor_sink name=out"
)
SSD_FRAME = (
    "videotestsrc pattern=gradient width=1280 height=720 num-frames=1 ! "
    "tensor_converter ! tensor_transform mode=resize option=300:300 ! "
    "tensor_filter framework=torch model=zoo:ssd_mobilenet_v2 ! tensor_sink name=out"
)
NMS_IOU = 0.5
NMS_OPS_PER_COLUMN = 12  # one masked IoU column: 4 min/max, 5 sub/mul, add, div, compare
NMS_WORDS_CHECK_N = 2048  # up to this n, the kernel's mask words are held against the twin's
# the routing phase: a detect → crop → per-object cascade beside a thumbnail
# branch, without its models (the labeling cell's 720p source)
ROUTING = (
    "videotestsrc device=true pattern=gradient width=1280 height=720 num-frames={n}{live} "
    "stamp-wall=true ! tensor_converter ! tee name=t "
    "t. ! queue ! crop.sink_0 "
    "appsrc name=regions dimensions=4:16 types=uint32 ! crop.sink_1 "
    "tensor_crop name=crop out-size=112:112 max-crops=16 ! mux.sink_0 "
    "t. ! queue ! tensor_transform mode=resize option=224:224 ! mux.sink_1 "
    "tensor_mux name=mux sync-mode=slowest ! tensor_demux name=d "
    "d.src_0 ! tensor_sink name=crops d.src_1 ! tensor_sink name=thumbs"
)
ROUTING_SINKS = ("crops", "thumbs")
# the goldens of the routing and host-side element surface ({out}: the
# dump, {fix}: tests/fixtures), each held to tests/golden/<name>.raw
ROUTING_GOLDENS = {
    "mux_slowest": (
        "videotestsrc pattern=counter num-frames=4 width=4 height=4 framerate=20/1 ! "
        "tensor_converter ! mux.sink_0 "
        "videotestsrc pattern=gradient num-frames=2 width=4 height=4 framerate=10/1 ! "
        "tensor_converter ! mux.sink_1 "
        "tensor_mux name=mux sync-mode=slowest ! filesink location={out}"
    ),
    "mux_basepad": (
        "videotestsrc pattern=counter num-frames=2 width=4 height=4 framerate=10/1 ! "
        "tensor_converter ! mux.sink_0 "
        "videotestsrc pattern=gradient num-frames=4 width=4 height=4 framerate=20/1 ! "
        "tensor_converter ! mux.sink_1 "
        "tensor_mux name=mux sync-mode=basepad sync-option=0:0 ! filesink location={out}"
    ),
    "mux_refresh": (
        "videotestsrc pattern=counter num-frames=4 width=4 height=4 framerate=20/1 ! "
        "tensor_converter ! mux.sink_0 "
        "videotestsrc pattern=gradient num-frames=1 width=4 height=4 framerate=10/1 ! "
        "tensor_converter ! mux.sink_1 "
        "tensor_mux name=mux sync-mode=refresh ! filesink location={out}"
    ),
    "demux_tensorpick": (
        "videotestsrc pattern=counter num-frames=2 width=4 height=4 ! "
        "tensor_converter ! mux.sink_0 "
        "videotestsrc pattern=gradient num-frames=2 width=4 height=4 ! "
        "tensor_converter ! mux.sink_1 "
        "tensor_mux name=mux sync-mode=nosync ! tensor_demux tensorpick=1 ! "
        "filesink location={out}"
    ),
    "demux_grouped": (
        "videotestsrc pattern=counter num-frames=2 width=4 height=4 ! "
        "tensor_converter ! mux.sink_0 "
        "videotestsrc pattern=gradient num-frames=2 width=4 height=4 ! "
        "tensor_converter ! mux.sink_1 "
        "videotestsrc pattern=solid num-frames=2 width=4 height=4 ! "
        "tensor_converter ! mux.sink_2 "
        "tensor_mux name=mux sync-mode=nosync ! tensor_demux tensorpick=0:1 ! "
        "filesink location={out}"
    ),
    "split_merge": (
        "videotestsrc pattern=counter num-frames=2 width=8 height=4 ! tensor_converter ! "
        "tensor_split tensorseg=3:8:2:1,3:8:2:1 name=sp sp.src_0 ! m.sink_0 sp.src_1 ! m.sink_1 "
        "tensor_merge name=m mode=linear option=2 sync-mode=nosync ! filesink location={out}"
    ),
    "if_branch": (
        "videotestsrc pattern=counter num-frames=4 width=4 height=4 ! tensor_converter ! "
        "tensor_transform mode=typecast option=float32 ! "
        "tensor_if compared-value=TENSOR_AVERAGE_VALUE compared-value-option=0 operator=GT "
        "supplied-value=1.5 then=PASSTHROUGH else=FILL_ZERO ! filesink location={out}"
    ),
    "if_fill_file": (
        "videotestsrc pattern=counter num-frames=3 width=4 height=4 ! tensor_converter ! "
        "tensor_if compared-value=TENSOR_AVERAGE_VALUE compared-value-option=0 operator=GE "
        "supplied-value=1 then=PASSTHROUGH else=FILL_WITH_FILE_RPT "
        "else-option={fix}/octet20.bin ! filesink location={out}"
    ),
    "rate_drop": (
        "videotestsrc pattern=counter num-frames=6 width=4 height=4 framerate=20/1 ! "
        "tensor_converter ! tensor_rate framerate=10/1 ! filesink location={out}"
    ),
    "aggregator_window": (
        "videotestsrc pattern=counter num-frames=4 width=4 height=4 ! tensor_converter ! "
        "tensor_aggregator frames-in=1 frames-out=2 frames-flush=2 ! filesink location={out}"
    ),
    "aggregator_overlap": (
        "videotestsrc pattern=counter num-frames=5 width=4 height=4 ! tensor_converter ! "
        "tensor_aggregator frames-in=1 frames-out=3 frames-flush=1 ! filesink location={out}"
    ),
    "sparse_roundtrip": (
        "videotestsrc pattern=counter num-frames=2 width=4 height=4 ! tensor_converter ! "
        "tensor_sparse_enc ! tensor_sparse_dec ! filesink location={out}"
    ),
    "converter_batch": (
        "videotestsrc pattern=counter num-frames=4 width=4 height=4 ! "
        "tensor_converter frames-per-tensor=2 ! filesink location={out}"
    ),
    "converter_octet": (
        "filesrc location={fix}/octet20.bin blocksize=5 ! "
        "tensor_converter input-dim=5 input-type=uint8 ! filesink location={out}"
    ),
    "converter_audio": (
        "audiotestsrc samples-per-buffer=32 num-buffers=2 channels=2 ! "
        "tensor_converter ! filesink location={out}"
    ),
    "videotestsrc_device": (
        "videotestsrc pattern=gradient device=true num-frames=3 width=8 height=8 ! "
        "tensor_converter ! tensor_transform mode=typecast option=uint8 ! "
        "filesink location={out}"
    ),
}


_T_START = time.perf_counter()


def emit(obj) -> None:
    """Print one result line; a phase's line carries ``t_s``, the seconds
    since the script started, so each phase's share of the time limit shows."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - _T_START)
    print(json.dumps(obj), flush=True)


def gpu_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, pool, reps: int, per_launch=False):
    """Device time per call: the summed durations of every GPU kernel and
    copy the calls ran (torch.profiler), over ``reps`` calls cycling through
    ``pool`` (inputs larger than L2, so each call reads cold memory).
    Returns (ms, the device records the profiler kept). With
    ``per_launch`` (``fn`` launches a fixed set of kernels, each once) the
    time is the sum over kernel names of that name's mean over the records
    kept: a profile may lose the records of some long kernels, and
    dividing their sum by ``reps`` would then undercount, while dividing by
    the records kept would time a call of two kernels as half a call. When three
    profiles keep no device record at all (seen late in a long run, for
    5 ms kernels), the time is the CUDA-event stream time per call of
    ``reps`` back-to-back calls (:func:`time_ms`) and the records are 0."""
    from torch.profiler import ProfilerActivity, profile

    for args in pool[:3]:
        fn(*args)
    torch.cuda.synchronize()
    for _ in range(3):  # a profile on this machine now and then keeps no device record
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(*pool[i % len(pool)])
            torch.cuda.synchronize()
        by_name = device_records(prof)
        total_us = sum(us for us, _ in by_name.values())
        records = sum(n for _, n in by_name.values())
        if total_us > 0 and per_launch:
            return sum(us / n for us, n in by_name.values()) / 1e3, records
        if total_us > 0:
            return total_us / 1e3 / reps, records
    return time_ms(torch, fn, pool, reps), 0


def device_records(prof):
    """Kernel name → (summed µs, records) of every device record a profile
    kept, read from its kineto results: the same records as
    ``key_averages()``'s device rows, without building the profiler's Python
    events, which costs about 0.2 ms a record (minutes for a plain
    version's loop of 10⁵ launches)."""
    from torch.autograd import DeviceType

    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA or ev.is_async() or ev.duration_ns() <= 0:
            continue
        us, n = out.get(ev.name(), (0.0, 0))
        out[ev.name()] = (us + ev.duration_ns() / 1e3, n + 1)
    return out


def alone_ms(torch, fn, args, reps: int = 5) -> float:
    """Median stream time of ``reps`` calls, each timed alone with CUDA
    events between two synchronizations: one launch and its dispatch."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def time_ms(torch, fn, pool, reps: int) -> float:
    """Stream time per call over ``reps`` back-to-back calls (CUDA events):
    device time plus any gap while the host dispatches the next call."""
    for args in pool[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*pool[i % len(pool)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_case(torch, np, ik, name, dtype, shape, out_hw, boxes=None,
                scale=None, offset=None):
    """One K1 case on the GPU: kernel vs plain version, timings, bound."""
    import torch.nn.functional as F

    rng = np.random.default_rng(zlib.crc32(name.encode()))
    out_h, out_w = out_hw
    h, w, c = shape[-3:]
    host = (
        rng.integers(0, 256, shape).astype(np.uint8) if dtype is torch.uint8
        else rng.standard_normal(shape).astype(np.float32)
    )
    img = torch.from_numpy(host).cuda().to(dtype)
    crop = boxes is not None
    tbox = torch.from_numpy(boxes).cuda() if crop else None
    n = boxes.shape[0] if crop else shape[0]
    out_dtype = torch.float32 if (scale is not None or offset is not None) else dtype

    def kernel(x, b):
        if crop:
            return ik.crop_and_resize(x, b, out_h, out_w, scale=scale, offset=offset)
        return ik.resize_bilinear(x, out_h, out_w, scale=scale, offset=offset)

    def plain(x, b):
        return ik.plain_crop_resize(x, b, n, out_h, out_w, scale, offset, out_dtype)

    got = kernel(img, tbox)
    want = plain(img, tbox)
    torch.cuda.synchronize()
    err = (got.to(torch.float32) - want.to(torch.float32)).abs().max().item()
    tol = ik.interp_atol(out_dtype, h, w)
    if got.shape != want.shape or got.dtype != want.dtype or not err <= tol:
        raise AssertionError(f"{name}: kernel vs plain max_abs_err {err} > {tol}")

    in_bytes = img.numel() * img.element_size()
    copies = min(64, max(2, math.ceil(2 * L2_BYTES / in_bytes)))
    pool = [(img.clone(), tbox) for _ in range(copies)]
    ms, records = device_ms(torch, kernel, pool, 100, per_launch=True)
    stream_ms = time_ms(torch, kernel, pool, 200)
    plain_ms, _ = device_ms(torch, plain, pool, 20)
    library_ms = library_stream_ms = None
    if not crop:
        # the same full-image resize as one PyTorch call, on float NCHW
        lib_pool = [
            (x.permute(0, 3, 1, 2).to(torch.float32 if dtype is torch.uint8 else dtype)
             .contiguous(), None) for x, _ in pool
        ]

        def library(x, _):
            return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                                 align_corners=False, antialias=False)

        library_ms, _ = device_ms(torch, library, lib_pool, 100)
        library_stream_ms = time_ms(torch, library, lib_pool, 200)
        del lib_pool

    # bound: each distinct source row a sample touches read once, the
    # output written once; ~9 float ops per output element (3 lerps)
    cpu_boxes = (
        torch.from_numpy(boxes) if crop
        else torch.tensor([[0.0, 0.0, float(w), float(h)]]).expand(n, 4)
    )
    y0, y1, _ = ik._axis_taps(cpu_boxes[:, 1], cpu_boxes[:, 3], out_h, h)
    rows = torch.cat([y0, y1], dim=1)
    images_rows = (
        len(torch.unique(rows)) if crop
        else sum(len(torch.unique(r)) for r in rows)
    )
    row_bytes = w * c * img.element_size()
    out_bytes = got.numel() * got.element_size()
    n_bytes = images_rows * row_bytes + out_bytes + (boxes.nbytes if crop else 0)
    n_ops = got.numel() * (9 + (scale is not None) + (offset is not None))
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = n_ops / PEAK_F32_OPS_S * 1e3
    return {
        "case": name,
        "entry": "crop_and_resize" if crop else "resize_bilinear",
        "in": f"{list(shape)} {str(dtype).removeprefix('torch.')}",
        "out": f"{list(got.shape)} {str(out_dtype).removeprefix('torch.')}",
        "max_abs_err": err,
        "tolerance": tol,
        "kernel_ms": ms,
        "kernel_records": records,
        "kernel_stream_ms": stream_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library_stream_ms": library_stream_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": n_bytes,
    }


def run_pipeline(parse_pipeline, device, n, live=False, hook=None):
    p = parse_pipeline(
        PIPELINE.format(n=n, live=" is-live=true framerate=30/1" if live else ""),
        device=device,
    )
    p.negotiate()
    if hook is not None:
        p["f"].backend.module.register_forward_hook(hook)
    t0 = time.perf_counter()
    p.run(timeout=600)
    wall = time.perf_counter() - t0
    frames = p["out"].frames
    labels = [int(f.tensors[0][0]) for f in frames]
    lat_ms = sorted((f.meta["render_t"] - f.meta["wall_t0"]) * 1e3 for f in frames)
    return labels, wall, lat_ms


def routing_regions(np, n_frames):
    """One [16, 4] uint32 (x, y, w, h) region frame a video frame, from
    numpy seed 9: 3 of 16 zero-size, 2 running past the 1280x720 frame's
    edge, the rest inside it."""
    rng = np.random.default_rng(9)
    frames = []
    for _ in range(n_frames):
        xy = np.stack([rng.integers(0, 1000, 16), rng.integers(0, 500, 16)], 1)
        wh = np.stack([rng.integers(16, 280, 16), rng.integers(16, 220, 16)], 1)
        wh[:3] = [[0, 40], [40, 0], [0, 0]]
        xy[3:5] = [[1200, 650], [1000, 690]]
        wh[3:5] = [[200, 150], [400, 100]]
        frames.append(np.concatenate([xy, wh], 1).astype(np.uint32))
    return frames


class SinkDevices:
    """Records the device of every tensor a sink node's coalesced fetch
    takes (pipeline/transfer.py ``fetch_frame``): where a frame's tensors
    are when they reach the sink, before render gets their host copy."""

    def __init__(self):
        self.seen = set()
        self.fetches = 0

    def __enter__(self):
        from nnstreamer_tpu_torch.pipeline import transfer

        self._mod, self._real = transfer, transfer.fetch_frame

        def fetch(frame):
            self.fetches += 1
            self.seen.update(t.device.type for t in frame.tensors if hasattr(t, "is_cuda"))
            return self._real(frame)

        transfer.fetch_frame = fetch
        return self

    def __exit__(self, *exc):
        self._mod.fetch_frame = self._real


def run_routing(parse_pipeline, device, regions, live=False, on_render=None):
    """The routing description for len(regions) frames, the regions pushed
    into its appsrc with the video's timestamps; returns (pipeline, wall s)."""
    from nnstreamer_tpu_torch.tensors.frame import SECOND, Frame

    p = parse_pipeline(
        ROUTING.format(n=len(regions), live=" is-live=true framerate=30/1" if live else ""),
        device=device,
    )
    p.negotiate()
    if on_render is not None:
        for name in ROUTING_SINKS:
            render = p[name].render
            p[name].render = lambda f, r=render: (on_render(f), r(f))
    dur = int(SECOND / 30)
    t0 = time.perf_counter()
    ex = p.start()
    for i, r in enumerate(regions):
        p["regions"].push(Frame((r,), pts=i * dur, duration=dur), timeout=600)
    p["regions"].end_of_stream()
    done = ex.wait(600)
    wall = time.perf_counter() - t0
    ex.stop()
    if ex.errors:
        raise ex.errors[0]
    if not done:
        raise AssertionError("routing: the pipeline did not reach EOS in 600 s")
    return p, wall


def routing_phase(torch, np, dev, parse_pipeline, ik):
    """Phase 6: the crop cascade (tee, queues, tensor_crop out-size → K1's
    crop entry, resize → K1's resize entry, mux, demux) on the card, then
    every golden of the element surface on CUDA tensors."""
    from torch.profiler import ProfilerActivity, profile

    regions = routing_regions(np, FRAMES)
    run_routing(parse_pipeline, dev, regions[:4])  # warm-up
    cpu, _ = run_routing(parse_pipeline, "cpu", regions[:4])
    seen = set()

    def on_render(frame):
        if "crop_regions" in frame.meta:
            seen.add("regions:" + frame.meta["crop_regions"].device.type)

    for c in (ik.crop_resize_launches, ik.crop_entry_launches, ik.resize_entry_launches):
        c.reset()
    # the sinks' tensors are read where each sink node's fetch takes them
    with SinkDevices() as sinks:
        p, wall = run_routing(parse_pipeline, dev, regions, on_render=on_render)
    seen |= sinks.seen
    if sinks.fetches != len(ROUTING_SINKS) * FRAMES:
        raise AssertionError(f"routing: {sinks.fetches} sink fetches for {FRAMES} frames")
    crop_k1, resize_k1 = ik.crop_entry_launches.count, ik.resize_entry_launches.count
    if (crop_k1, resize_k1) != (FRAMES, FRAMES):
        raise AssertionError(
            f"routing: K1 crop entry {crop_k1}, resize entry {resize_k1} launches "
            f"for {FRAMES} frames"
        )
    if seen != {dev.type, "regions:" + dev.type}:
        raise AssertionError(f"routing: sink tensors and regions on {seen}, want {dev.type}")
    crops, thumbs = (p[n].frames for n in ROUTING_SINKS)
    if len(crops) != FRAMES or len(thumbs) != FRAMES:
        raise AssertionError(f"routing: {len(crops)}/{len(thumbs)} frames of {FRAMES}")
    tol = ik.interp_atol(torch.uint8, 720, 1280)
    err = 0.0
    for name, got in (("crops", crops), ("thumbs", thumbs)):
        for g, c in zip(got, cpu[name].frames):
            g, c = g.tensors[0], c.tensors[0]
            if g.shape != c.shape or g.dtype != c.dtype:
                raise AssertionError(f"routing {name}: {g.shape} {g.dtype} vs CPU {c.shape}")
            err = max(err, float(np.abs(g.astype(np.int16) - c.astype(np.int16)).max()))
    if not err <= tol:
        raise AssertionError(f"routing: GPU vs CPU max abs err {err} > {tol}")
    for f in crops:
        if f.tensors[0].shape != (16, 112, 112, 3) or f.tensors[0][:3].any():
            raise AssertionError("routing: zero-size regions must give all-zero rows")
        if not f.tensors[0][3:].reshape(13, -1).any(1).all():
            raise AssertionError("routing: a region with an area gave an all-zero row")
    lat_free = sorted((f.meta["render_t"] - f.meta["wall_t0"]) * 1e3 for f in crops)
    paced, _ = run_routing(parse_pipeline, dev, regions, live=True)
    lat_live = sorted((f.meta["render_t"] - f.meta["wall_t0"]) * 1e3 for f in paced["crops"].frames)

    n_prof = 16
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, prof_wall = run_routing(parse_pipeline, dev, regions[:n_prof])
    from torch.autograd import DeviceType

    d2h = sum(ev.count for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA and "dtoh" in ev.key.lower())
    # the sinks' own copies: one tensor a sink a frame; any more would be a
    # frame or region tensor read back between the source and the sinks
    if d2h > len(ROUTING_SINKS) * n_prof:
        raise AssertionError(f"routing: {d2h} D2H copies over {n_prof} frames, "
                             f"more than the sinks' {len(ROUTING_SINKS) * n_prof}")

    here = os.path.dirname(os.path.abspath(__file__))
    fix = os.path.join(here, "tests", "fixtures")
    goldens = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, desc in ROUTING_GOLDENS.items():
            out = os.path.join(tmp, f"{name}.raw")
            parse_pipeline(desc.format(out=out, fix=fix), device=dev).run(timeout=120)
            with open(out, "rb") as f, open(os.path.join(here, "tests", "golden",
                                                         f"{name}.raw"), "rb") as g:
                goldens[name] = f.read() == g.read()
    if not all(goldens.values()):
        raise AssertionError(f"routing goldens differ on CUDA: "
                             f"{[n for n, ok in goldens.items() if not ok]}")
    return {
        "phase": "routing", "config": "routing-crop-720p", "frames": FRAMES,
        "k1_crop_launches": crop_k1, "k1_resize_launches": resize_k1,
        "sink_devices": sorted(seen),
        "gpu_vs_cpu_max_abs_err": err, "tolerance": tol, "compared_frames": 4,
        "fps": FRAMES / wall, "wall_s": wall,
        "free_latency_ms_p50": pct(lat_free, 0.5), "free_latency_ms_p99": pct(lat_free, 0.99),
        "paced30_latency_ms_p50": pct(lat_live, 0.5),
        "paced30_latency_ms_p99": pct(lat_live, 0.99),
        "d2h_records": d2h, "d2h_per_frame": d2h / n_prof,
        "d2h_at_sinks_per_frame": len(ROUTING_SINKS),
        "profile_frames": n_prof,
        **profile_classes(torch, prof, prof_wall, [("crop_resize (K1)", "crop_resize")]),
        "goldens_cuda_byte_exact": goldens,
    }


def nms_times(torch, nk, sboxes, sscores):
    """K2's times on ranked GPU inputs: (device ms of a call, the sum of
    the mask and scan kernels' means, with the records kept and the reps;
    stream ms of back-to-back calls; one call alone)."""
    pool = [(sboxes, sscores)]

    def kernel(b, s):
        return nk._cuda_nms(b, s, NMS_IOU)

    reps = 50 if sboxes.shape[0] <= 8192 else 10
    ms, records = device_ms(torch, kernel, pool, reps, per_launch=True)
    return ms, records, reps, time_ms(torch, kernel, pool, reps), alone_ms(torch, kernel, pool[0])


def nms_case(torch, det, nk, name, boxes, scores, max_out=100):
    """One K2 case on the GPU: the kernel and the plain version on the
    same ranked inputs (masks and packed results bit-identical, and the
    whole ``nms`` equal to the port's CPU run); up to NMS_WORDS_CHECK_N
    candidates, every mask word the kernel wrote (the live rows, from the
    diagonal block on: all the scan can read) equal to the plain twin's;
    timings, bound, the scan's word blocks and the workspace."""
    order, sboxes, sscores = det.rank(boxes, scores)
    n = boxes.shape[0]
    plan = nk.nms_plan(n)
    words = torch.empty((n, plan.words), dtype=torch.int64, device=sboxes.device)
    alive_k, live = nk._cuda_nms(sboxes, sscores, NMS_IOU, words=words)
    got_mask = alive_k > 0
    want_mask = nk.plain_nms_mask(sboxes, sscores, NMS_IOU)
    got = det.pack_kept(order, sscores, got_mask, max_out)
    want = det.pack_kept(order, sscores, want_mask, max_out)
    cpu = det.nms(boxes.cpu(), scores.cpu(), NMS_IOU, max_out)
    torch.cuda.synchronize()
    m = int(live.item())
    err = max(
        (alive_k - want_mask.to(torch.float32)).abs().max().item(),
        (got[1] - want[1]).abs().max().item(),
    )
    identical = (
        torch.equal(got_mask, want_mask)
        and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    )
    if not identical or err != 0:
        raise AssertionError(f"nms {name}: kernel differs from plain (max_abs_err {err})")
    if not (torch.equal(got[0].cpu(), cpu[0]) and torch.equal(got[1].cpu(), cpu[1])):
        raise AssertionError(f"nms {name}: GPU keep_idx/keep_score differ from the CPU run")
    words_checked = 0
    if n <= NMS_WORDS_CHECK_N:
        twin_words, twin_alive = nk.plain_nms_bitmask(sboxes.cpu(), sscores.cpu(), NMS_IOU)
        rows = torch.arange(n)
        written = (sscores.cpu() > 0)[:, None] & (
            torch.arange(plan.words)[None, :] >= (rows // nk.WORD_BITS)[:, None]
        )
        if not torch.equal(words.cpu()[written], twin_words[written]):
            raise AssertionError(f"nms {name}: mask words differ from the plain twin's")
        if not torch.equal(twin_alive, want_mask.cpu()):
            raise AssertionError(f"nms {name}: the plain twin's mask differs from plain")
        words_checked = int(written.sum())
    del words
    kept = torch.nonzero(want_mask).flatten().cpu()
    # IoU columns the live steps of these inputs visit: j in (i, m) per kept i
    columns = int((m - 1 - kept).sum())
    n_bytes = n * 20 + n * 4  # boxes + scores in, alive out
    n_ops = NMS_OPS_PER_COLUMN * columns
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = n_ops / PEAK_F32_OPS_S * 1e3
    ms, records, reps, stream_ms, one_ms = nms_times(torch, nk, sboxes, sscores)

    def plain(b, s):
        return nk.plain_nms_mask(b, s, NMS_IOU)

    # the plain version launches ~12 kernels per live step and reads a
    # flag back per step: one profiled call, its stream time beside it
    pool = [(sboxes, sscores)]
    plain_ms, _ = device_ms(torch, plain, pool, 1)
    plain_stream_ms = time_ms(torch, plain, pool, 1)
    return {
        "case": name, "n": n, "m": m, "kept": int(len(kept)), "max_out": max_out,
        "max_abs_err": err, "bit_identical": True, "cpu_identical": True,
        "words_checked": words_checked,
        "kernel_ms": ms, "kernel_records": records, "kernel_reps": reps,
        "kernel_stream_ms": stream_ms, "kernel_alone_ms": one_ms,
        "ms_per_step": ms / max(m, 1),
        "rounds": -(-m // nk.WORD_BITS), "mask_tiles": plan.tiles,
        "workspace_bytes": plan.workspace_bytes,
        "plain_ms": plain_ms, "plain_stream_ms": plain_stream_ms,
        "library_ms": None,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": n_bytes, "operations": n_ops,
    }


def synthetic_boxes(np, n, seed, scale=1.0, size=(0.01, 0.2), zero_below=0.1):
    """n random (x1, y1, x2, y2) boxes in [0, scale] with scores; scores
    under ``zero_below`` set to 0 (candidates that start dead)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, scale, (n, 2))
    wh = rng.uniform(size[0] * scale, size[1] * scale, (n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[scores < zero_below] = 0.0
    return boxes, scores


def run_detection(parse_pipeline, device, n, priors, pp="device", live=False, hook=None):
    p = parse_pipeline(
        DET_PIPELINE.format(
            n=n, live=" is-live=true framerate=30/1" if live else "",
            priors=priors, pp=pp,
        ),
        device=device,
    )
    p.negotiate()
    if hook is not None:
        p["f"].backend.module.register_forward_hook(hook)
    t0 = time.perf_counter()
    p.run(timeout=600)
    wall = time.perf_counter() - t0
    frames = p["out"].frames
    lat_ms = sorted((f.meta["render_t"] - f.meta["wall_t0"]) * 1e3 for f in frames)
    return frames, wall, lat_ms


CONV_KEYS = ("conv", ("conv", "xmma", "fprop", "gemm", "cudnn"))
MATMUL_KEYS = ("matmul", ("gemm", "gemv", "xmma", "cutlass", "matmul", "sm90_", "nvjet"))


def profile_classes(torch, prof, wall_s, extra, main=CONV_KEYS, annotations=()):
    """Device time (ms) by class from a torch.profiler run, the records
    kept in each class, and the busy share of ``wall_s``. ``extra``:
    (class name, key substring) pairs checked first; ``main``: the class
    of the model's dense work and its key substrings; ``annotations``: the
    names of ``record_function`` ranges, whose device-side records span
    kernels already counted. A profile may lose some records, so the
    times are lower bounds: a class's record count against the frames
    shows how many were kept."""
    from torch.autograd import DeviceType

    # a profiler schedule's step also shows as a device-side annotation
    # spanning the whole step: no kernel, so not device time
    rows = sorted(
        ((ev.self_device_time_total, ev.key, ev.count) for ev in prof.key_averages()
         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
         and not ev.key.startswith("ProfilerStep") and ev.key not in annotations),
        reverse=True,
    )
    main_cls, main_subs = main
    classes = {main_cls: 0.0, **{c: 0.0 for c, _ in extra}, "memcpy": 0.0, "other": 0.0}
    calls = dict.fromkeys(classes, 0)
    for dt, key, count in rows:
        low = key.lower()
        cls = next((c for c, sub in extra if sub in low), None)
        if cls is None:
            if "memcpy" in low or "memset" in low:
                cls = "memcpy"
            elif any(t in low for t in main_subs):
                cls = main_cls
            else:
                cls = "other"
        classes[cls] += dt / 1e3
        calls[cls] += count
    device_ms = sum(classes.values())
    return {
        "wall_ms": wall_s * 1e3,
        "device_ms": device_ms if rows else "not measured",
        "device_busy_share": device_ms / 1e3 / wall_s if rows else "not measured",
        "device_ms_by_class": classes,
        "device_records_by_class": calls,
        "device_kernels": sum(n for _, _, n in rows),
        "top_kernels": [
            {"name": k[:80], "device_ms": dt / 1e3, "calls": n} for dt, k, n in rows[:8]
        ],
    }


# -- the LLM serving slice (Mistral-7B widths) -------------------------------

# Mistral-7B-v0.1 (mistralai/Mistral-7B-v0.1 config.json): every width
# published; RMSNorm eps 1e-6 (the repo's) where Mistral uses 1e-5
MISTRAL = dict(vocab=32000, d_model=4096, n_heads=32, n_layers=32, d_ff=14336, n_kv_heads=8)
SERVE = dict(n_slots=8, max_len=4096, prompt_len=512)  # max_len = the sliding window
NEW_TOKENS = 64
LONG_PROMPT = 1500  # > prompt_len: the chunked prefill
# a reference position whose top-2 logit margin is below this share of
# max |logit| is a near-tie that either choice may take: exempt from the
# token check, and counted
MARGIN_REL = 1e-3
# the same rule in bfloat16, whose logits are rounded to 8 significant bits:
# ties and one- or two-ulp margins are common there, and a one-ulp change
# anywhere in a bfloat16 stack moves them, so near-ties are those within
# 2**-6 of max |logit| (two to four bfloat16 ulps of it)
MARGIN_REL_BF16 = 2.0 ** -6
INT8_F32_LOGIT_TOL = 1e-3  # K3 vs the inline attention on one int8 cache, float32
# through-cache logits against the no-cache forward, float32: two summation
# orders, 32 layers deep (TF32 matmuls would be off by ~1e-3)
LOGIT_REL_TOL = 2e-4
PIPE_OPTS = "vocab:32000,d_model:4096,n_heads:32,n_kv_heads:8,n_layers:2,seed:0"
LLM_PIPELINE = (
    "appsrc name=src dimensions=512:1 types=int32 ! "
    'tensor_llm_serversink id=chip custom="{opts}" attn-impl=pallas n-slots=8 '
    "max-len=4096 prompt-len=512 max-new-tokens=32 "
    "tensor_llm_serversrc name=ssrc id=chip ! tensor_sink name=out"
)


def split_report(da, b, h, kv, d, rows, live):
    """The split launch of K3/K4 for a history of ``rows`` rows and these
    live lengths: chunk rows, splits, blocks launched and attending, and
    the partials' workspace (allocated; written and read back by the live
    chunks: the design's overhead, outside the bytes bound)."""
    plan = da.split_plan(rows)
    g = h // kv
    heads = 1 if g <= 1 else 2 if g <= 2 else 4 if g <= 4 else 8  # attn_tile.cuh heads_per_block
    live_chunks = sum(da.live_splits(x, plan.chunk) for x in live)
    return {
        "chunk_rows": plan.chunk, "splits": plan.splits,
        "blocks": kv * -(-g // heads) * b * plan.splits,
        "blocks_attending": kv * -(-g // heads) * live_chunks,
        "combine_blocks": b * h,
        "workspace_bytes": b * h * plan.splits * (d + 2) * 4,
        "partial_bytes_moved": 2 * live_chunks * h * (d + 2) * 4,
    }


def attn_case(torch, np, da, name, b, h, kv, d, s_len, pos, dtype="float32",
              from_float=False):
    """One K3 case on the GPU: the kernel against its plain version on the
    same inputs, timings, the library call, and the bound. ``from_float``:
    an int8 cache as quantize_kv writes it from float K/V (the serving
    path's values), else the kernel registry's raw int8 and scales."""
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.models import serving as sv

    dev = torch.device("cuda")
    rng = np.random.default_rng(zlib.crc32(name.encode()))

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    q = randn(b, 1, h, d)
    ks = vs = None
    if dtype == "int8" and from_float:
        ck, ks = sv.quantize_kv(randn(b, s_len, kv, d))
        cv, vs = sv.quantize_kv(randn(b, s_len, kv, d))
    elif dtype == "int8":
        ck, cv = (torch.from_numpy(rng.integers(-127, 128, (b, s_len, kv, d)).astype(np.int8))
                  .to(dev) for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(0.01, 0.1, (b, s_len, kv)).astype(np.float32))
                  .to(dev) for _ in range(2))
    else:
        ck, cv = randn(b, s_len, kv, d), randn(b, s_len, kv, d)
        if dtype == "bfloat16":
            q, ck, cv = q.bfloat16(), ck.bfloat16(), cv.bfloat16()
    p = torch.tensor(pos, dtype=torch.int32, device=dev)

    def kernel(q, ck, cv, p, ks, vs):
        return da.decode_attention(q, ck, cv, p, k_scale=ks, v_scale=vs)

    def plain(q, ck, cv, p, ks, vs):
        return da.plain_decode_attention(q, ck, cv, p, k_scale=ks, v_scale=vs)

    got = kernel(q, ck, cv, p, ks, vs)
    want = plain(q, ck, cv, p, ks, vs)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    if got.shape != (b, 1, h, d) or got.dtype != torch.float32 or not err <= tol:
        raise AssertionError(f"K3 {name}: kernel vs plain max_abs_err {err} > {tol}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"K3 {name}: non-finite output")

    live = [min(x + 1, s_len) for x in pos]
    esize = ck.element_size()
    live_bytes = sum(live) * kv * d * 2 * esize + (sum(live) * kv * 2 * 4 if ks is not None else 0)
    n_bytes = live_bytes + q.numel() * q.element_size() + b * h * d * 4 + b * 4
    n_ops = sum(live) * h * 4 * d  # q.k and p.v: a multiply-add each per element
    copies = min(8, max(1, math.ceil(2 * L2_BYTES / live_bytes)))
    pool = [(q, ck.clone(), cv.clone(), p, ks, vs) for _ in range(copies)]
    ms, records = device_ms(torch, kernel, pool, 50, per_launch=True)
    stream_ms = time_ms(torch, kernel, pool, 50)
    one_ms = alone_ms(torch, kernel, pool[0])
    plain_ms, _ = device_ms(torch, plain, pool, 5)

    # yardstick: one PyTorch call on the same live prefix (float caches:
    # int8 dequantized beforehand), a boolean mask and grouped heads
    smax = max(live)
    mask = (torch.arange(smax, device=dev)[None, :]
            < torch.tensor(live, device=dev)[:, None])[:, None, None, :]
    if ks is not None:
        kf, vf = sv.dequantize_kv(ck, ks), sv.dequantize_kv(cv, vs)
    else:
        kf, vf = ck, cv
    lib_pool = [(q.transpose(1, 2).contiguous(),
                 kf[:, :smax].permute(0, 2, 1, 3).contiguous(),
                 vf[:, :smax].permute(0, 2, 1, 3).contiguous(), mask)
                for _ in range(copies)]

    def library(qh, kl, vl, m):
        return F.scaled_dot_product_attention(qh, kl, vl, attn_mask=m, enable_gqa=True)

    library_ms = library_err = None
    note = None
    try:
        lib_out = library(*lib_pool[0]).transpose(1, 2)
        torch.cuda.synchronize()
        library_err = (lib_out.float() - want).abs().max().item()
        library_ms, _ = device_ms(torch, library, lib_pool, 50)
    except TypeError as exc:  # a PyTorch without enable_gqa
        note = f"scaled_dot_product_attention: {exc}"
    del pool, lib_pool
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = n_ops / PEAK_F32_OPS_S * 1e3
    return {
        "case": name, "b": b, "h": h, "kv": kv, "d": d, "s": s_len,
        "pos_min": min(pos), "pos_max": max(pos), "live_rows": sum(live),
        "dtype": dtype + (" (quantize_kv of float)" if from_float else ""),
        "max_abs_err": err, "tolerance": tol, "non_finite": 0,
        "kernel_ms": ms, "kernel_records": records, "kernel_stream_ms": stream_ms,
        "kernel_alone_ms": one_ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "library_max_abs_err": library_err,
        "library_note": note,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": n_bytes, "operations": n_ops,
        "achieved_GBps": n_bytes / (ms * 1e-3) / 1e9,
        **split_report(da, b, h, kv, d, s_len, live),
    }


def drive_requests(cb, prompts, budget, pump=8, eager=False):
    """Serve ``prompts`` through ``cb``: submit while a slot is free (per-
    token steps while admissions are pending), then drain with
    ``step_pump``; ``eager``: the programs' bodies uncaptured
    (``step_eager`` / ``step_pump_eager``, the oracle). Host-clock timings;
    every step ends in a read of the host, so it has waited for the card."""
    step, step_pump = ((cb.step_eager, cb.step_pump_eager) if eager
                       else (cb.step, cb.step_pump))
    queue = list(enumerate(prompts))
    rid_of, t_sub, t_first = {}, {}, {}
    step_ms, admit_ms, pump_ms = [], [], []
    t_start = time.perf_counter()
    while queue or any(cb.result(r) is None for r in rid_of.values()):
        admitted = False
        while queue and cb.n_free:
            i, p = queue[0]
            t0 = time.perf_counter()
            rid = cb.submit(p, budget)
            if rid is None:
                break
            queue.pop(0)
            rid_of[i], t_sub[rid] = rid, t0
            admitted = True
        t0 = time.perf_counter()
        if queue or admitted:
            step()
            (admit_ms if admitted else step_ms).append((time.perf_counter() - t0) * 1e3)
        else:
            step_pump(pump)
            pump_ms.append((time.perf_counter() - t0) * 1e3 / pump)
        now = time.perf_counter()
        for rid in rid_of.values():
            if rid not in t_first and cb.partial(rid):
                t_first[rid] = now
    wall = time.perf_counter() - t_start
    toks = [cb.result(rid_of[i]) for i in range(len(prompts))]
    ttft = sorted((t_first[r] - t_sub[r]) * 1e3 for r in rid_of.values())
    return {
        "tokens": toks, "wall_s": wall, "step_ms": sorted(step_ms),
        "admit_step_ms": sorted(admit_ms), "pump_ms_per_step": sorted(pump_ms),
        "ttft_ms": ttft,
    }


def through_cache_logits(torch, tfm, dec, sv, lm, prompt, toks, attn_fn, compute_dtype,
                         cache_dtype="auto"):
    """Teacher-forced serving path for one request, one slot: the prefill
    of ``prompt`` in prompt_len chunks through the cache, then one
    ``batched_decode_step`` per generated token (``attn_fn`` None = the
    inline masked attention, else K3). → logits [len(toks), V] float32:
    row j chose ``toks[j]``."""
    import numpy as np

    dev = lm.embed.device
    n_heads, P, max_len = MISTRAL["n_heads"], SERVE["prompt_len"], SERVE["max_len"]
    hd = lm.d_model // n_heads
    shape = (lm.n_layers, 1, max_len, lm.n_kv_heads, hd)
    if cache_dtype == "int8":
        cache = tuple((torch.zeros(shape, dtype=torch.int8, device=dev),
                       torch.ones(shape[:-1], device=dev)) for _ in range(2))
    else:
        cache = tuple(torch.zeros(shape, dtype=compute_dtype, device=dev) for _ in range(2))
    t = len(prompt)
    n_chunks = -(-t // P)
    stage = tuple(torch.zeros((lm.n_layers, 1, n_chunks * P, lm.n_kv_heads, hd),
                              dtype=compute_dtype, device=dev) for _ in range(2))
    for c in range(n_chunks):
        chunk = np.zeros((1, P), np.int64)
        part = prompt[c * P:(c + 1) * P]
        chunk[0, :len(part)] = part
        logits, stage, _ = dec.verify_chunk(
            lm, torch.as_tensor(chunk, device=dev), c * P, stage, n_heads,
            compute_dtype=compute_dtype, return_logits=c == n_chunks - 1,
        )
    rows = [logits[0, (t - 1) % P]]
    sv.insert_slot(cache, stage[0], stage[1], 0)
    pos = torch.tensor([t], dtype=torch.int32, device=dev)
    active = torch.ones((1,), dtype=torch.bool, device=dev)
    for j in range(len(toks) - 1):
        tok = torch.tensor([toks[j]], dtype=torch.int32, device=dev)
        lg, cache, pos = sv.batched_decode_step(lm, tok, pos, active, cache, n_heads,
                                                compute_dtype, attn_fn=attn_fn)
        rows.append(lg[0])
    return torch.stack(rows)


def decode_profile(torch, cb, prompts, steps):
    """Device time by class over ``steps`` decode steps of a full batch: the
    run's first 8 prompts (the 1500-token one among them), admitted before
    the window."""
    from torch.profiler import ProfilerActivity, profile

    for p in prompts[:SERVE["n_slots"]]:
        cb.submit(p, steps + 4)
    cb.step()
    cb.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            cb.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    while cb.n_free < SERVE["n_slots"]:
        cb.step_pump(8)
    return profile_classes(torch, prof, wall, [("decode_attention (K3)", "decode_attention")],
                           main=MATMUL_KEYS)


def per_step(prof, steps):
    """A decode profile's device time a step, in all and by class."""
    if not prof["device_kernels"]:
        return {"device_ms_per_step": "not measured"}
    return {
        "device_ms_per_step": prof["device_ms"] / steps,
        "device_ms_per_step_by_class": {
            c: v / steps for c, v in prof["device_ms_by_class"].items()},
        "device_busy_share": prof["device_busy_share"],
    }


def margin_check(torch, logits, toks, rel=MARGIN_REL):
    """Greedy tokens against reference logits [n, V]: (mismatches at
    positions whose top-2 margin is at least rel * max |logit|, positions
    exempt as near-ties)."""
    top2 = logits.topk(2, dim=-1).values
    near = ((top2[:, 0] - top2[:, 1]) < rel * logits.abs().amax(dim=-1)).cpu()
    wrong = logits.argmax(dim=-1).cpu() != torch.tensor(toks)
    return int((wrong & ~near).sum()), int(near.sum())


def replayed_programs(st, phase):
    """The pump programs a batcher's stats() lists, each captured as a CUDA
    graph (raises otherwise): {name: replays}."""
    progs = st["programs"]
    if not progs or not all(p["captured"] for p in progs.values()):
        raise AssertionError(f"{phase}: pump programs not all captured: {progs}")
    return {name: p["replays"] for name, p in progs.items()}


def pct(sorted_vals, q):
    return sorted_vals[min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))]


def k3_kernel_cases(torch, np, da):
    """The attn_kernels phase's K3 cases (phase 11)."""
    spread = [(i * 4095) // 7 for i in range(8)]
    return [
        # the JAX package's kernel registry shapes (decode_attention.py:359-381)
        attn_case(torch, np, da, "s64-bk16", 3, 4, 4, 16, 64, [0, 31, 63]),
        attn_case(torch, np, da, "s40-bk128", 3, 4, 4, 16, 40, [0, 19, 39]),
        attn_case(torch, np, da, "s97-bk32", 3, 4, 4, 16, 97, [0, 48, 96]),
        attn_case(torch, np, da, "s33-bk16", 3, 4, 4, 16, 33, [0, 16, 32]),
        attn_case(torch, np, da, "gqa-int8", 2, 4, 2, 16, 48, [11, 40], "int8"),
        attn_case(torch, np, da, "bf16", 2, 2, 2, 16, 32, [5, 20], "bfloat16"),
        # a wrapped ring's absolute positions (pos > S)
        attn_case(torch, np, da, "wrapped-s200", 2, 2, 2, 16, 200, [200, 607]),
        # the serving shape, fills spread over the whole window
        attn_case(torch, np, da, "serve-f32-spread", 8, 32, 8, 128, 4096, spread),
        attn_case(torch, np, da, "serve-bf16-spread", 8, 32, 8, 128, 4096, spread, "bfloat16"),
        attn_case(torch, np, da, "serve-int8-spread", 8, 32, 8, 128, 4096, spread, "int8",
                  from_float=True),
        # the serving shape at a realistic fill
        attn_case(torch, np, da, "serve-f32-pos600", 8, 32, 8, 128, 4096, [600] * 8),
        attn_case(torch, np, da, "serve-int8-pos600", 8, 32, 8, 128, 4096, [600] * 8, "int8",
                  from_float=True),
        attn_case(torch, np, da, "serve-bf16-pos600", 8, 32, 8, 128, 4096, [600] * 8,
                  "bfloat16"),
        # one slot at the end of the window: one (slot, kv head) pair per
        # kv head holds all the work, which the split spreads over blocks
        attn_case(torch, np, da, "serve-f32-long1", 1, 32, 8, 128, 4096, [4095]),
        # the kernel's other instances: padded head dims 64 and 256, head
        # groups of 8 split over blocks (g 16, 32) and of 3 (a padded head),
        # and rows of 24 and 20 bytes (bf16 D 12, int8 D 20), copied in
        # 8- and 4-byte pieces
        attn_case(torch, np, da, "g32-d256", 2, 32, 1, 256, 300, [150, 299]),
        attn_case(torch, np, da, "g16-d64-bf16", 2, 32, 2, 64, 500, [37, 499], "bfloat16"),
        attn_case(torch, np, da, "g3-d20-int8", 2, 6, 2, 20, 260, [128, 259], "int8"),
        attn_case(torch, np, da, "d12-bf16", 2, 4, 2, 12, 200, [126, 127], "bfloat16"),
    ]


def slot_traffic(np, rng):
    """The slot layout's 16 prompts: 64-512 tokens, the fourth 1500 (the
    chunked prefill)."""
    lengths = rng.integers(64, 513, 16)
    lengths[3] = LONG_PROMPT
    return [rng.integers(1, MISTRAL["vocab"], n).astype(np.int32) for n in lengths]


def llm_phases(torch, np, dev, parse_pipeline):
    """Phases 10-13, the LLM serving slice on the slot layout. Returns (the
    K3 cases by name, K3 launches in the serving run, the serving run's
    TTFT p50/p99)."""
    # 11. attn_kernels ---------------------------------------------------------
    from nnstreamer_tpu_torch.models import decode as dec
    from nnstreamer_tpu_torch.models import serving as sv
    from nnstreamer_tpu_torch.models import transformer as tfm
    from nnstreamer_tpu_torch.models import zoo
    from nnstreamer_tpu_torch.ops.kernels import decode_attention as da

    # float32 matmuls in full float32 for every LLM phase (set above, and
    # stated again here: the references compare at float32 precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    k3_cases = k3_kernel_cases(torch, np, da)
    emit({"phase": "attn_kernels", "cases": k3_cases})

    # 12. serving: the full-width engine ----------------------------------------
    t0 = time.perf_counter()
    lm = tfm.init_params(torch.Generator(device=dev).manual_seed(0), **MISTRAL, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_heads, n_layers = MISTRAL["n_heads"], MISTRAL["n_layers"]
    rng = np.random.default_rng(0)
    prompts = slot_traffic(np, rng)
    cb = sv.ContinuousBatcher(lm, n_heads, **SERVE, attn_impl="pallas", device=dev)
    weights_gb = sum(p.numel() * p.element_size() for p in lm.parameters()) / 1e9
    kv_row = MISTRAL["n_kv_heads"] * (MISTRAL["d_model"] // n_heads)  # values a cache row holds
    rows = SERVE["n_slots"] * SERVE["max_len"]
    cache_gb = 2 * n_layers * rows * kv_row * 4 / 1e9
    drive_requests(cb, [prompts[0][:64]], 4)  # warm-up: cuBLAS, the kernel's first load
    steps0 = cb.stats()["steps"]
    da.decode_attention_launches.reset()
    run = drive_requests(cb, prompts, NEW_TOKENS)
    k3_launches = da.decode_attention_launches.count
    steps = cb.stats()["steps"] - steps0
    programs = replayed_programs(cb.stats(), "serving")
    if k3_launches != n_layers * steps:
        raise AssertionError(f"serving: K3 launched {k3_launches} times, "
                             f"{n_layers} layers x {steps} steps = {n_layers * steps}")
    if any(t is None or len(t) != NEW_TOKENS for t in run["tokens"]):
        raise AssertionError("serving: a request did not return its 64 tokens")
    mismatches = exempt = 0
    with torch.no_grad():
        for p, toks in zip(prompts, run["tokens"]):
            seq = torch.as_tensor(np.concatenate([p, toks[:-1]])[None], device=dev)
            ref = tfm.apply(lm, seq, n_heads)[0, len(p) - 1:]
            if not torch.isfinite(ref).all():
                raise AssertionError("serving: reference logits not finite")
            bad, near = margin_check(torch, ref, toks)
            mismatches += bad
            exempt += near
        if mismatches:
            raise AssertionError(f"serving: {mismatches} greedy tokens differ from the "
                                 "no-cache reference's argmax (near-ties exempt)")
        # logits: prefill and decoding through the cache (K3) against the
        # full forward pass, teacher-forced on four requests (the long one too)
        pre_err = dec_err = 0.0
        for i in (0, 3, 7, 12):
            p, toks = prompts[i], run["tokens"][i]
            got = through_cache_logits(torch, tfm, dec, sv, lm, p, toks, da.make_decode_attention(),
                                       torch.float32)
            seq = torch.as_tensor(np.concatenate([p, toks[:-1]])[None], device=dev)
            ref = tfm.apply(lm, seq, n_heads)[0, len(p) - 1:]
            rel = ((got - ref).abs().amax(dim=-1) / ref.abs().amax(dim=-1)).cpu()
            pre_err = max(pre_err, float(rel[0]))
            dec_err = max(dec_err, float(rel[1:].max()))
        if not (pre_err <= LOGIT_REL_TOL and dec_err <= LOGIT_REL_TOL):
            raise AssertionError(f"serving: through-cache logits off the full forward: "
                                 f"prefill {pre_err}, decode {dec_err} > {LOGIT_REL_TOL}")

    serve_profile = decode_profile(torch, cb, prompts, 16)

    # yardstick: the same 8-request traffic through K3 and through the
    # plain inline attention (attn_impl="xla"), and 8 profiled steps each
    yard = {"pallas": drive_requests(cb, prompts[:8], NEW_TOKENS)}
    yard_prof = {"pallas": decode_profile(torch, cb, prompts, 8)}
    del cb
    torch.cuda.empty_cache()
    cbx = sv.ContinuousBatcher(lm, n_heads, **SERVE, attn_impl="xla", device=dev)
    drive_requests(cbx, [prompts[0][:64]], 4)
    yard["xla"] = drive_requests(cbx, prompts[:8], NEW_TOKENS)
    yard_prof["xla"] = decode_profile(torch, cbx, prompts, 8)
    del cbx
    torch.cuda.empty_cache()
    # the mesh group's serving check (ROADMAP A.8a) on these weights, its
    # slot cache the only one on the card
    mesh_serving = mesh_serving_phase(torch, np, dev, lm, prompts, run, yard_prof["pallas"])
    gen_tokens = sum(len(t) for t in run["tokens"])
    emit({
        "phase": "serving", "config": "llm-serving-mistral7b", **MISTRAL, **SERVE,
        "compute_dtype": "float32", "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "requests": len(prompts), "prompt_lengths": [len(p) for p in prompts],
        "new_tokens": NEW_TOKENS, "init_s": init_s,
        "weights_gb": weights_gb, "cache_gb": cache_gb,
        "k3_launches": k3_launches, "steps": steps, "layers_x_steps": n_layers * steps,
        "program_replays": programs,
        "greedy_mismatches": mismatches, "near_tie_exempt": exempt,
        "prefill_logit_max_rel_err": pre_err, "decode_logit_max_rel_err": dec_err,
        "logit_tolerance": LOGIT_REL_TOL,
        # full-batch decode rate: 8 slots over the median decode-only step
        "decode_tok_s": SERVE["n_slots"] * 1e3 / pct(run["step_ms"], 0.5),
        "served_tok_s": gen_tokens / run["wall_s"], "wall_s": run["wall_s"],
        "tpot_ms_p50": pct(run["step_ms"], 0.5), "tpot_ms_p99": pct(run["step_ms"], 0.99),
        "decode_steps_timed": len(run["step_ms"]),
        "pump_ms_per_step_p50": pct(run["pump_ms_per_step"], 0.5),
        "admit_step_ms_p50": pct(run["admit_step_ms"], 0.5),
        "ttft_ms_p50": pct(run["ttft_ms"], 0.5), "ttft_ms_p99": pct(run["ttft_ms"], 0.99),
        "profile_steps": 16, **serve_profile,
        "yardstick_8req": {
            impl: {"decode_tok_s": SERVE["n_slots"] * 1e3 / pct(y["pump_ms_per_step"], 0.5),
                   "ms_per_step_p50": pct(y["pump_ms_per_step"], 0.5),
                   "served_tok_s": sum(len(t) for t in y["tokens"]) / y["wall_s"],
                   "wall_s": y["wall_s"], **per_step(yard_prof[impl], 8)}
            for impl, y in yard.items()
        },
    })
    del lm
    torch.cuda.empty_cache()

    # 13. serving_int8: int8 cache, bfloat16 compute, 4 layers ---------------------
    lm4 = tfm.init_params(torch.Generator(device=dev).manual_seed(1),
                          **dict(MISTRAL, n_layers=4), device=dev)
    cb8 = sv.ContinuousBatcher(lm4, n_heads, **SERVE, attn_impl="pallas", cache_dtype="int8",
                               compute_dtype=torch.bfloat16, device=dev)
    drive_requests(cb8, [prompts[0][:64]], 4)
    steps0 = cb8.stats()["steps"]
    da.decode_attention_launches.reset()
    run8 = drive_requests(cb8, prompts[:8], NEW_TOKENS)
    k3_int8 = da.decode_attention_launches.count
    steps8 = cb8.stats()["steps"] - steps0
    if k3_int8 != 4 * steps8:
        raise AssertionError(f"serving_int8: K3 launched {k3_int8} times for 4 x {steps8}")
    # int8 payload plus a float32 scale per row and kv head, K and V
    int8_cache_gb = 2 * 4 * rows * (kv_row + MISTRAL["n_kv_heads"] * 4) / 1e9
    del cb8
    bad8 = near8 = batch_diff = 0
    int8_rel = int8_f32_rel = 0.0
    attn = da.make_decode_attention()

    def rel_err(a, b):
        return float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())

    with torch.no_grad():
        for p, toks in zip(prompts[:8], run8["tokens"]):
            # the same serving step on the same int8 cache with the inline
            # attention (xla) in place of K3, both teacher-forced on the
            # batcher's tokens in one slot: their greedy choices agree
            # (near-ties exempt), in the run's bfloat16 and in float32
            xla = through_cache_logits(torch, tfm, dec, sv, lm4, p, toks, None, torch.bfloat16,
                                       "int8")
            k3 = through_cache_logits(torch, tfm, dec, sv, lm4, p, toks, attn, torch.bfloat16,
                                      "int8")
            bad, near = margin_check(torch, xla, k3.argmax(dim=-1).tolist(), MARGIN_REL_BF16)
            bad8 += bad
            near8 += near
            int8_rel = max(int8_rel, rel_err(k3, xla))
            # reported, not checked: the 8-slot batch runs its bfloat16
            # matmuls at another M than one slot, so its rounding differs
            batch_diff += int((xla.argmax(dim=-1).cpu() != torch.tensor(toks)).sum())
            xla32 = through_cache_logits(torch, tfm, dec, sv, lm4, p, toks, None, torch.float32,
                                         "int8")
            k3_32 = through_cache_logits(torch, tfm, dec, sv, lm4, p, toks, attn, torch.float32,
                                         "int8")
            bad, _ = margin_check(torch, xla32, k3_32.argmax(dim=-1).tolist())
            bad8 += bad
            int8_f32_rel = max(int8_f32_rel, rel_err(k3_32, xla32))
    if bad8 or not int8_f32_rel <= INT8_F32_LOGIT_TOL:
        raise AssertionError(f"serving_int8: {bad8} K3 choices differ from the xla path's "
                             f"argmax; float32 logits rel err {int8_f32_rel}")
    emit({
        "phase": "serving_int8", "layers": 4, "compute_dtype": "bfloat16", "cache_dtype": "int8",
        "requests": 8, "k3_launches": k3_int8, "steps": steps8, "layers_x_steps": 4 * steps8,
        "token_mismatches": bad8, "near_tie_exempt": near8,
        "margin_rel_bf16": MARGIN_REL_BF16,
        "batch8_vs_one_slot_argmax_differences": batch_diff,
        "k3_vs_xla_logit_max_rel_err_bf16": int8_rel,
        "k3_vs_xla_logit_max_rel_err_f32": int8_f32_rel,
        "f32_logit_tolerance": INT8_F32_LOGIT_TOL, "cache_gb": int8_cache_gb,
        "decode_tok_s": SERVE["n_slots"] * 1e3 / pct(run8["pump_ms_per_step"], 0.5),
        "ms_per_step_p50": pct(run8["pump_ms_per_step"], 0.5),
        "ttft_ms_p50": pct(run8["ttft_ms"], 0.5),
    })
    del lm4
    torch.cuda.empty_cache()

    # 14. llm_pipeline: the element pair through parse_pipeline ------------------
    pipe_prompts = [rng.integers(1, MISTRAL["vocab"], n).astype(np.int32)
                    for n in rng.integers(32, 257, 12)]
    budgets = [16 if i % 3 == 0 else 32 for i in range(len(pipe_prompts))]
    pl = parse_pipeline(LLM_PIPELINE.format(opts=PIPE_OPTS), device=dev)
    da.decode_attention_launches.reset()
    ex = pl.start()
    from nnstreamer_tpu_torch.tensors.frame import Frame

    for i, (p, n) in enumerate(zip(pipe_prompts, budgets)):
        meta = {"req": i} if n == 32 else {"req": i, "max_new_tokens": n}
        pl["src"].push(Frame((p,), meta=meta))
    pl["src"].end_of_stream()
    done = ex.wait(600)
    ex.stop()
    if ex.errors or not done:
        raise AssertionError(f"llm_pipeline: {ex.errors or 'no EOS within 600 s'}")
    pipe_k3 = da.decode_attention_launches.count
    pipe_steps = pl["ssrc"].serving_stats()["steps"]
    pipe_programs = replayed_programs(pl["ssrc"].serving_stats(), "llm_pipeline")
    got = {f.meta["req"]: f.tensors[0][0].tolist() for f in pl["out"].frames}
    if sorted(got) != list(range(len(pipe_prompts))):
        raise AssertionError(f"llm_pipeline: requests back {sorted(got)}")
    if pipe_k3 != 2 * pipe_steps:
        raise AssertionError(f"llm_pipeline: K3 launched {pipe_k3} times for 2 x {pipe_steps}")
    m = zoo.get("transformer_lm", device=dev,
                **dict(kv.split(":") for kv in PIPE_OPTS.split(",")))
    direct = sv.ContinuousBatcher(m.params, n_heads, **SERVE, attn_impl="pallas", device=dev)
    rids = []
    for p, n in zip(pipe_prompts, budgets):
        while (rid := direct.submit(p, n)) is None:
            direct.step()
        rids.append(rid)
    while any(direct.result(r) is None for r in rids):
        direct.step()
    want = [direct.result(r) for r in rids]
    diff = [i for i in range(len(pipe_prompts)) if got[i] != want[i]]
    if diff:
        raise AssertionError(f"llm_pipeline: requests {diff} differ from the direct batcher")
    del m, direct
    torch.cuda.empty_cache()
    emit({"phase": "llm_pipeline", "requests": len(pipe_prompts), "layers": 2,
          "k3_launches": pipe_k3, "steps": pipe_steps, "layers_x_steps": 2 * pipe_steps,
          "program_replays": pipe_programs, "equal_to_direct_batcher": True, "meta_returned": True,
          "tokens_first_request": got[0][:8]})
    slot_ttft = {"ttft_ms_p50": pct(run["ttft_ms"], 0.5), "ttft_ms_p99": pct(run["ttft_ms"], 0.99)}
    return {c["case"]: c for c in k3_cases}, k3_launches, slot_ttft, mesh_serving


# -- the paged KV slice (block arena, prefix sharing, K4) --------------------------

PAGED = dict(kv_layout="paged", block_size=16)
KV_BLOCKS = 1024  # 16 384 tokens: half the 2048 blocks 8 slots x 4096 would reserve
SYSTEM_PROMPT = 256  # tokens (16 full blocks) shared by half the chat traffic
PREEMPT_KV_BLOCKS = 256 + 8  # just above one max_len request
PREEMPT_NEW = 256
LLM_PIPELINE_PAGED = (
    "appsrc name=src dimensions=512:1 types=int32 ! "
    'tensor_llm_serversink id=chippg custom="{opts}" attn-impl=pallas kv-layout=paged '
    "block-size=16 kv-blocks=1024 n-slots=8 max-len=4096 prompt-len=512 max-new-tokens=32 "
    "tensor_llm_serversrc name=ssrc id=chippg ! tensor_sink name=out"
)


def paged_case(torch, np, pa, dev, name, b, h, kv, d, bs, nb, n_blocks, pos, dtype="float32",
               from_float=False, nan=False, k3_ms=None):
    """One K4 case on the GPU: the kernel against its plain version on the
    same inputs, timings, the bound, and the gather + SDPA yardstick.
    Table entries are random block ids (every live one in 1..N-1, drawn
    from shuffled rounds of the arena, so a few repeat as shared prefix
    blocks do); entries past a slot's history point at scratch block 0.
    ``from_float``: an int8 arena as quantize_kv writes it from float K/V,
    else the kernel registry's raw int8 and scales. ``nan``: every arena
    row outside the live histories is NaN."""
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.models import serving as sv
    from nnstreamer_tpu_torch.ops.kernels import decode_attention as da

    rng = np.random.default_rng(zlib.crc32(name.encode()))

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    hist = [min(max(x, 0), nb * bs) for x in pos]
    n_live_blk = [-(-x // bs) for x in hist]
    if n_blocks >= b * nb:  # the registry's tables: one permutation of the arena
        tab = rng.permutation(n_blocks)[: b * nb].reshape(b, nb)
    else:
        ids = np.concatenate([rng.permutation(np.arange(1, n_blocks))
                              for _ in range(-(-b * nb // (n_blocks - 1)))])
        tab = ids[: b * nb].reshape(b, nb)
    for i in range(b):
        tab[i, n_live_blk[i]:] = 0
    tables = torch.from_numpy(tab.astype(np.int32)).to(dev)
    q = randn(b, 1, h, d)
    fk, fv = randn(b, 1, kv, d), randn(b, 1, kv, d)
    ks = vs = None
    if dtype == "int8" and from_float:
        ak, ks = sv.quantize_kv(randn(n_blocks, bs, kv, d))
        av, vs = sv.quantize_kv(randn(n_blocks, bs, kv, d))
    elif dtype == "int8":
        ak, av = (torch.from_numpy(rng.integers(-127, 128, (n_blocks, bs, kv, d)).astype(np.int8))
                  .to(dev) for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(0.01, 0.1, (n_blocks, bs, kv)).astype(np.float32))
                  .to(dev) for _ in range(2))
    else:
        ak, av = randn(n_blocks, bs, kv, d), randn(n_blocks, bs, kv, d)
        if dtype == "bfloat16":
            q, ak, av, fk, fv = (x.bfloat16() for x in (q, ak, av, fk, fv))
    if nan:
        live = np.zeros((n_blocks, bs), bool)
        for i in range(b):
            r = np.arange(hist[i])
            live[tab[i, r // bs], r % bs] = True
        dead = torch.from_numpy(~live).to(dev)
        ak[dead] = float("nan")
        av[dead] = float("nan")
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    args = (q, ak, av, tables, p, fk, fv, ks, vs)

    def kernel(q, ak, av, tables, p, fk, fv, ks, vs):
        return pa.paged_decode_attention(q, ak, av, tables, p, fk, fv, k_scale=ks, v_scale=vs)

    def plain(q, ak, av, tables, p, fk, fv, ks, vs):
        return pa.plain_paged_attention(q, ak, av, tables, p, fk, fv, ks, vs)

    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    if got.shape != (b, 1, h, d) or got.dtype != torch.float32 or not err <= tol:
        raise AssertionError(f"K4 {name}: kernel vs plain max_abs_err {err} > {tol}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"K4 {name}: non-finite output")

    esize = ak.element_size()
    rows = sum(hist)
    live_bytes = rows * kv * d * 2 * esize + (rows * kv * 2 * 4 if ks is not None else 0)
    n_bytes = (live_bytes + sum(n_live_blk) * 4 + q.numel() * q.element_size()
               + 2 * fk.numel() * fk.element_size() + b * h * d * 4 + b * 4)
    n_ops = (rows + b) * h * 4 * d  # q.k and p.v over the history and the fresh column
    copies = min(8, max(1, math.ceil(2 * L2_BYTES / max(live_bytes, 1))))
    pool = [(q, ak.clone(), av.clone(), tables, p, fk, fv, ks, vs) for _ in range(copies)]
    ms, records = device_ms(torch, kernel, pool, 50, per_launch=True)
    stream_ms = time_ms(torch, kernel, pool, 50)
    one_ms = alone_ms(torch, kernel, pool[0])
    plain_ms, _ = device_ms(torch, plain, pool, 5)

    # yardstick, two PyTorch calls (the port calls neither): index_select of
    # the live blocks, then scaled_dot_product_attention with the fresh
    # column appended (float arenas only)
    gather_ms = gather_err = None
    note = None
    if ks is None:
        n_take = max(n_live_blk)
        cols = torch.arange(n_take * bs + 1, device=dev)
        mask = ((cols[None, :] < torch.tensor(hist, device=dev)[:, None])
                | (cols[None, :] == n_take * bs))[:, None, None, :]

        def gather_sdpa(q, ak, av, tables, p, fk, fv, ks, vs):
            idx = tables[:, :n_take].reshape(-1)
            kk = torch.cat([ak.index_select(0, idx).reshape(b, n_take * bs, kv, d), fk], 1)
            vv = torch.cat([av.index_select(0, idx).reshape(b, n_take * bs, kv, d), fv], 1)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2), attn_mask=mask,
                enable_gqa=True).transpose(1, 2)

        try:
            lib = gather_sdpa(*args)
            torch.cuda.synchronize()
            gather_err = (lib.float() - want).abs().max().item()
            gather_ms, _ = device_ms(torch, gather_sdpa, pool, 20)
        except TypeError as exc:  # a PyTorch without enable_gqa
            note = f"scaled_dot_product_attention: {exc}"
    del pool
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = n_ops / PEAK_F32_OPS_S * 1e3
    return {
        "case": name, "b": b, "h": h, "kv": kv, "d": d, "bs": bs, "nb": nb, "n_blocks": n_blocks,
        "pos_min": min(pos), "pos_max": max(pos), "history_rows": rows,
        "dtype": dtype + (" (quantize_kv of float)" if from_float else ""),
        "nan_outside_history": nan, "max_abs_err": err, "tolerance": tol, "non_finite": 0,
        "kernel_ms": ms, "kernel_records": records, "kernel_stream_ms": stream_ms,
        "kernel_alone_ms": one_ms,
        "plain_ms": plain_ms, "library_ms": None,
        "library_note": "no PyTorch call attends through a block table",
        "gather_sdpa_ms": gather_ms, "gather_sdpa_calls": 2 if gather_ms is not None else None,
        "gather_sdpa_max_abs_err": gather_err, "gather_sdpa_note": note,
        "k3_ms_same_fills": k3_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": n_bytes, "operations": n_ops,
        "achieved_GBps": n_bytes / (ms * 1e-3) / 1e9,
        **split_report(da, b, h, kv, d, nb * bs, hist),
    }


def drive_paged(cb, prompts, budget, pump=8, eager=False):
    """Serve ``prompts`` through a paged batcher: submit while a slot is
    free; while prompts wait in the prefill queue, ``step_pump(1)`` (one
    prefill chunk interleaved with one decode step), else
    ``step_pump(pump)``; ``eager``: ``step_pump_eager``, the oracle.
    Host-clock timings; every pump ends in a read of the host, so it has
    waited for the card."""
    step_pump = cb.step_pump_eager if eager else cb.step_pump
    queue = list(enumerate(prompts))
    rid_of, t_sub, t_first = {}, {}, {}
    admit_ms, pump_ms, full_ms = [], [], []
    t_start = time.perf_counter()
    while queue or any(cb.result(r) is None for r in rid_of.values()):
        while queue and cb.n_free:
            i, p = queue[0]
            t0 = time.perf_counter()
            rid = cb.submit(p, budget)
            if rid is None:
                break
            queue.pop(0)
            rid_of[i], t_sub[rid] = rid, t0
        st = cb.stats()
        t0 = time.perf_counter()
        if st["kv_prefill_queue"]:
            step_pump(1)
            admit_ms.append((time.perf_counter() - t0) * 1e3)
        else:
            step_pump(pump)
            per = (time.perf_counter() - t0) * 1e3 / pump
            pump_ms.append(per)
            if st["slots_occupied"] == cb.n_slots:
                full_ms.append(per)
        now = time.perf_counter()
        for rid in rid_of.values():
            if rid not in t_first and cb.partial(rid):
                t_first[rid] = now
    wall = time.perf_counter() - t_start
    toks = [cb.result(rid_of[i]) for i in range(len(prompts))]
    return {
        "tokens": toks, "rids": [rid_of[i] for i in range(len(prompts))], "wall_s": wall,
        "admit_step_ms": sorted(admit_ms),
        "pump_ms_per_step": sorted(pump_ms), "full_batch_ms_per_step": sorted(full_ms),
        "ttft_ms": sorted((t_first[r] - t_sub[r]) * 1e3 for r in rid_of.values()),
    }


def paged_through_cache_logits(torch, np, tfm, dec, kvg, kvb, lm, prompt, toks, attn_fn,
                               compute_dtype=None, cache_dtype="auto"):
    """Teacher-forced paged serving path for one request: the prefill of
    ``prompt`` in prompt_len chunks into a stage, landed in arena blocks
    1..n (quantized for an int8 arena), then one
    ``batched_decode_step_block`` per generated token through the block
    table (``attn_fn``: K4; None: the inline attention). → logits
    [len(toks), V] float32: row j chose ``toks[j]``."""
    dev = lm.embed.device
    compute_dtype = compute_dtype or torch.float32
    quantized = cache_dtype == "int8"
    n_heads, P, max_len = MISTRAL["n_heads"], SERVE["prompt_len"], SERVE["max_len"]
    hd, bs = lm.d_model // n_heads, PAGED["block_size"]
    n_blk = -(-(len(prompt) + len(toks)) // bs)
    arena = kvg.init_arena(lm.n_layers, n_blk, bs, lm.n_kv_heads, hd, quantized, compute_dtype,
                           dev)
    tables = torch.zeros((1, max_len // bs), dtype=torch.int32, device=dev)
    tables[0, :n_blk] = torch.arange(1, n_blk + 1, device=dev)
    t = len(prompt)
    n_chunks = -(-t // P)
    stage = tuple(torch.zeros((lm.n_layers, 1, n_chunks * P, lm.n_kv_heads, hd),
                              dtype=compute_dtype, device=dev) for _ in range(2))
    for c in range(n_chunks):
        chunk = np.zeros((1, P), np.int64)
        part = prompt[c * P:(c + 1) * P]
        chunk[0, :len(part)] = part
        logits, stage, _ = dec.verify_chunk(
            lm, torch.as_tensor(chunk, device=dev), c * P, stage, n_heads,
            compute_dtype=compute_dtype, return_logits=c == n_chunks - 1,
        )
    rows = [logits[0, (t - 1) % P]]
    ids = np.zeros((n_chunks * P // bs,), np.int32)
    valid = np.zeros(ids.shape, bool)
    n_prompt_blk = -(-t // bs)
    ids[:n_prompt_blk] = np.arange(1, n_prompt_blk + 1)
    valid[:n_prompt_blk] = True
    kvg.make_staging_ops(quantized, compute_dtype)[1](arena, stage, ids, valid)
    pos = torch.tensor([t], dtype=torch.int32, device=dev)
    active = torch.ones((1,), dtype=torch.bool, device=dev)
    for j in range(len(toks) - 1):
        tok = torch.tensor([toks[j]], dtype=torch.int32, device=dev)
        lg, arena, pos = kvb.batched_decode_step_block(lm, tok, pos, active, arena, tables,
                                                       n_heads, compute_dtype, attn_fn=attn_fn)
        rows.append(lg[0])
    return torch.stack(rows)


def stream_check(torch, np, tfm, lm, prompt, got, want, rel, compute_dtype):
    """``got`` against ``want`` under the margin rule: equal, or the first
    token where they part is a near-tie of the no-cache forward on the
    common prefix (top-2 margin below ``rel`` × max |logit|). → (True if
    they part at a near-tie, else False; raises if they part elsewhere)."""
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None and len(got) == len(want):
        return False
    if i is None:
        raise AssertionError(f"stream lengths differ: {len(got)} vs {len(want)}")
    seq = torch.as_tensor(np.concatenate([prompt, np.asarray(want[:i], np.int32)])[None],
                          device=lm.embed.device)
    ref = tfm.apply(lm, seq, MISTRAL["n_heads"], compute_dtype=compute_dtype)[0, -1].float()
    top2 = ref.topk(2).values
    if not float(top2[0] - top2[1]) < rel * float(ref.abs().max()):
        raise AssertionError(f"streams part at token {i} ({got[i]} vs {want[i]}) where the "
                             f"no-cache forward's top-2 margin is {float(top2[0] - top2[1])}")
    return True


def k4_kernel_cases(torch, np, pa, dev, k3):
    """The paged_kernels phase's K4 cases; ``k3(name)``: K3's time in the
    attn_kernels case of that name, or None."""
    spread = [(i * 4095) // 7 for i in range(8)]
    serve = dict(b=8, h=32, kv=8, d=128, bs=16, nb=256, n_blocks=1025)
    return [
        # the JAX package's kernel registry shapes (paged_attention.py:385-406)
        paged_case(torch, np, pa, dev, "b2-full-and-empty", 2, 4, 4, 16, 8, 3, 8, [0, 24]),
        paged_case(torch, np, pa, dev, "gqa-partial-fill", 2, 4, 2, 16, 8, 4, 12, [5, 27]),
        paged_case(torch, np, pa, dev, "int8-arena", 2, 2, 2, 16, 8, 3, 8, [9, 24], "int8"),
        paged_case(torch, np, pa, dev, "serve-paged-2048", 8, 8, 8, 128, 128, 16, 128,
                   [(i * 2048) // 7 for i in range(8)]),
        # only the fresh column, a pos past the table, NaN outside the history
        paged_case(torch, np, pa, dev, "pos0-fresh-only", 2, 4, 4, 16, 8, 3, 8, [0, 0]),
        paged_case(torch, np, pa, dev, "pos-past-table", 2, 4, 2, 16, 8, 3, 8, [24, 90]),
        paged_case(torch, np, pa, dev, "nan-outside-history", 2, 4, 2, 16, 8, 4, 10, [5, 27],
                   nan=True),
        paged_case(torch, np, pa, dev, "serve-nan-outside-history", **serve, pos=[600] * 8,
                   nan=True),
        # the serving shape: fills spread over the window, and at pos 600
        paged_case(torch, np, pa, dev, "serve-f32-spread", **serve, pos=spread,
                   k3_ms=k3("serve-f32-spread")),
        paged_case(torch, np, pa, dev, "serve-bf16-spread", **serve, pos=spread, dtype="bfloat16",
                   k3_ms=k3("serve-bf16-spread")),
        paged_case(torch, np, pa, dev, "serve-int8-spread", **serve, pos=spread, dtype="int8",
                   from_float=True, k3_ms=k3("serve-int8-spread")),
        paged_case(torch, np, pa, dev, "serve-f32-pos600", **serve, pos=[600] * 8,
                   k3_ms=k3("serve-f32-pos600")),
        paged_case(torch, np, pa, dev, "serve-bf16-pos600", **serve, pos=[600] * 8,
                   dtype="bfloat16", k3_ms=k3("serve-bf16-pos600")),
        paged_case(torch, np, pa, dev, "serve-int8-pos600", **serve, pos=[600] * 8, dtype="int8",
                   from_float=True, k3_ms=k3("serve-int8-pos600")),
        paged_case(torch, np, pa, dev, "serve-f32-long1", **dict(serve, b=1), pos=[4095],
                   k3_ms=k3("serve-f32-long1")),
        # the kernel's other instances, as in attn_kernels: head dims 256
        # and 64, head groups of 32, 16 and 3, rows of 24 and 20 bytes
        paged_case(torch, np, pa, dev, "g32-d256", 2, 32, 1, 256, 16, 20, 41, [150, 320]),
        paged_case(torch, np, pa, dev, "g16-d64-bf16", 2, 32, 2, 64, 16, 32, 65, [37, 499],
                   dtype="bfloat16"),
        paged_case(torch, np, pa, dev, "g3-d20-int8", 2, 6, 2, 20, 8, 33, 67, [128, 259],
                   dtype="int8"),
        paged_case(torch, np, pa, dev, "d12-bf16", 2, 4, 2, 12, 16, 13, 27, [127, 128],
                   dtype="bfloat16"),
    ]

def paged_traffic(np, rng):
    """The paged layout's 16 prompts, alternating: 8 of their own (64-512
    tokens, the fourth 1500) and 8 chat prompts behind one 256-token
    system prompt."""
    vocab = MISTRAL["vocab"]
    own = [rng.integers(1, vocab, n).astype(np.int32) for n in rng.integers(64, 513, 8)]
    own[3] = rng.integers(1, vocab, LONG_PROMPT).astype(np.int32)
    system = rng.integers(1, vocab, SYSTEM_PROMPT).astype(np.int32)
    chat = [np.concatenate([system, rng.integers(1, vocab, n).astype(np.int32)])
            for n in rng.integers(64, 257, 8)]
    return [p for pair in zip(own, chat) for p in pair]


def paged_phases(torch, np, dev, parse_pipeline, k3_by_name, slot_serving):
    """The paged KV slice: paged_kernels, paged_serving, paged_preempt_int8
    and paged_pipeline. Returns (the K4 case at the main path's shape, K4
    launches in the serving run)."""
    from nnstreamer_tpu_torch.kv import block_attn as kvb
    from nnstreamer_tpu_torch.kv import gather as kvg
    from nnstreamer_tpu_torch.models import decode as dec
    from nnstreamer_tpu_torch.models import serving as sv
    from nnstreamer_tpu_torch.models import transformer as tfm
    from nnstreamer_tpu_torch.models import zoo
    from nnstreamer_tpu_torch.ops.kernels import decode_attention as da
    from nnstreamer_tpu_torch.ops.kernels import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False

    def k3(name):
        c = k3_by_name.get(name)
        return c["kernel_ms"] if c else None

    # paged_kernels ----------------------------------------------------------------
    k4_cases = k4_kernel_cases(torch, np, pa, dev, k3)
    emit({"phase": "paged_kernels", "cases": k4_cases})
    k4_main = next(c for c in k4_cases if c["case"] == "serve-f32-pos600")
    torch.cuda.empty_cache()

    # paged_serving: the full-width paged engine -----------------------------------------
    t0 = time.perf_counter()
    lm = tfm.init_params(torch.Generator(device=dev).manual_seed(0), **MISTRAL, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_heads, n_layers, vocab = MISTRAL["n_heads"], MISTRAL["n_layers"], MISTRAL["vocab"]
    rng = np.random.default_rng(0)
    prompts = paged_traffic(np, rng)
    long_idx = 2 * 3
    cb = sv.ContinuousBatcher(lm, n_heads, **SERVE, **PAGED, kv_blocks=KV_BLOCKS,
                              attn_impl="pallas", device=dev)
    hd = MISTRAL["d_model"] // n_heads
    arena_gb = 2 * n_layers * (KV_BLOCKS + 1) * PAGED["block_size"] * MISTRAL["n_kv_heads"] \
        * hd * 4 / 1e9
    slot_cache_gb = 2 * n_layers * SERVE["n_slots"] * SERVE["max_len"] * MISTRAL["n_kv_heads"] \
        * hd * 4 / 1e9
    drive_paged(cb, [rng.integers(1, vocab, 64).astype(np.int32)], 4)  # warm-up
    chunk_calls = []
    chunk_one = cb._prefill_chunk_one

    def spy(job):  # which request each chunk forward served, and past which match
        chunk_one(job)
        chunk_calls.append((job.req.rid, job.base, job.fill))

    cb._prefill_chunk_one = spy
    st0 = cb.stats()
    da.decode_attention_launches.reset()
    pa.paged_decode_attention_launches.reset()
    run = drive_paged(cb, prompts, NEW_TOKENS)
    k4_launches = pa.paged_decode_attention_launches.count
    k3_in_paged = da.decode_attention_launches.count
    st = cb.stats()
    programs = replayed_programs(st, "paged_serving")
    del cb._prefill_chunk_one  # the class's method again: no cycle keeps cb alive
    steps = st["steps"] - st0["steps"]
    if k4_launches != n_layers * steps or k3_in_paged != 0:
        raise AssertionError(f"paged_serving: K4 launched {k4_launches} times for {n_layers} "
                             f"layers x {steps} steps; K3 {k3_in_paged} times")
    if any(t is None or len(t) != NEW_TOKENS for t in run["tokens"]):
        raise AssertionError("paged_serving: a request did not return its 64 tokens")
    long_chunks = sum(1 for r, _, _ in chunk_calls if r == run["rids"][long_idx])
    seeded = sorted({r for r, base, _ in chunk_calls if base > 0})
    chat_rids = run["rids"][1::2]
    hit_tokens = st["kv_prefix_hit_tokens"] - st0["kv_prefix_hit_tokens"]
    if hit_tokens <= 0 or not set(chat_rids[1:]) <= set(seeded):
        raise AssertionError(f"paged_serving: prefix hits {hit_tokens} tokens; seeded chunk "
                             f"prefills for {seeded}, want every chat request after the first")
    if long_chunks < 2:
        raise AssertionError(f"paged_serving: the {LONG_PROMPT}-token prompt took "
                             f"{long_chunks} chunk forwards")
    if st["kv_blocks_in_use"] != 0:
        raise AssertionError(f"paged_serving: {st['kv_blocks_in_use']} blocks in use after "
                             "the drain")
    mismatches = exempt = 0
    with torch.no_grad():
        for p, toks in zip(prompts, run["tokens"]):
            seq = torch.as_tensor(np.concatenate([p, toks[:-1]])[None], device=dev)
            ref = tfm.apply(lm, seq, n_heads)[0, len(p) - 1:]
            if not torch.isfinite(ref).all():
                raise AssertionError("paged_serving: reference logits not finite")
            bad, near = margin_check(torch, ref, toks)
            mismatches += bad
            exempt += near
        if mismatches:
            raise AssertionError(f"paged_serving: {mismatches} greedy tokens differ from the "
                                 "no-cache reference's argmax (near-ties exempt)")
        # logits through the arena (K4) against the full forward, teacher-
        # forced on the long request and the second chat request
        pre_err = dec_err = 0.0
        for i in (long_idx, 3):
            p, toks = prompts[i], run["tokens"][i]
            got = paged_through_cache_logits(torch, np, tfm, dec, kvg, kvb, lm, p, toks,
                                             pa.make_paged_attention())
            seq = torch.as_tensor(np.concatenate([p, toks[:-1]])[None], device=dev)
            ref = tfm.apply(lm, seq, n_heads)[0, len(p) - 1:]
            rel = ((got - ref).abs().amax(dim=-1) / ref.abs().amax(dim=-1)).cpu()
            pre_err = max(pre_err, float(rel[0]))
            dec_err = max(dec_err, float(rel[1:].max()))
        if not (pre_err <= LOGIT_REL_TOL and dec_err <= LOGIT_REL_TOL):
            raise AssertionError(f"paged_serving: through-arena logits off the full forward: "
                                 f"prefill {pre_err}, decode {dec_err} > {LOGIT_REL_TOL}")

    # device time by class over 16 full-batch steps (two pumps of 8) at the
    # fills of the run's first 8 prompts
    from torch.profiler import ProfilerActivity, profile

    for p in prompts[:SERVE["n_slots"]]:
        cb.submit(p, 40)
    while cb.stats()["kv_prefill_queue"]:
        cb.step_pump(1)
    cb.step_pump(1)  # the last activation joins
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cb.step_pump(8)
        cb.step_pump(8)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    while cb.n_free < SERVE["n_slots"]:
        cb.step_pump(8)
    serve_profile = profile_classes(
        torch, prof, prof_wall, [("paged_decode_attention (K4)", "paged_attention")],
        main=MATMUL_KEYS)
    del cb
    torch.cuda.empty_cache()
    # yardstick: the same traffic's first 8 requests with the inline
    # attention (attn_impl="xla": a per-layer view through the tables)
    cbx = sv.ContinuousBatcher(lm, n_heads, **SERVE, **PAGED, kv_blocks=KV_BLOCKS,
                               attn_impl="xla", device=dev)
    drive_paged(cbx, [prompts[0][:64]], 4)
    yard = drive_paged(cbx, prompts[:8], NEW_TOKENS)
    del cbx
    gen_tokens = sum(len(t) for t in run["tokens"])
    full = run["full_batch_ms_per_step"] or run["pump_ms_per_step"]
    emit({
        "phase": "paged_serving", "config": "llm-serving-mistral7b-paged", **MISTRAL, **SERVE,
        **PAGED, "kv_blocks": KV_BLOCKS, "compute_dtype": "float32",
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32, "init_s": init_s,
        "requests": len(prompts), "prompt_lengths": [len(p) for p in prompts],
        "shared_system_prompt": SYSTEM_PROMPT, "new_tokens": NEW_TOKENS,
        "arena_gb": arena_gb, "slot_cache_gb": slot_cache_gb,
        "k4_launches": k4_launches, "k3_launches": k3_in_paged, "steps": steps,
        "layers_x_steps": n_layers * steps, "program_replays": programs,
        "greedy_mismatches": mismatches, "near_tie_exempt": exempt,
        "prefill_logit_max_rel_err": pre_err, "decode_logit_max_rel_err": dec_err,
        "logit_tolerance": LOGIT_REL_TOL,
        "prefix_hit_tokens": hit_tokens,
        "prefix_hits_blocks": st["kv_prefix_hits"] - st0["kv_prefix_hits"],
        "cow_copies": st["kv_cow_copies"] - st0["kv_cow_copies"],
        "seeded_chunk_prefills": len(seeded), "long_prompt_chunk_forwards": long_chunks,
        "prefill_chunk_forwards": len(chunk_calls), "preemptions": st["kv_preemptions"],
        "blocks_in_use_after_drain": st["kv_blocks_in_use"],
        "decode_tok_s": SERVE["n_slots"] * 1e3 / pct(full, 0.5),
        "full_batch_pumps": len(run["full_batch_ms_per_step"]),
        "tpot_ms_p50": pct(run["pump_ms_per_step"], 0.5),
        "tpot_ms_p99": pct(run["pump_ms_per_step"], 0.99),
        "admit_step_ms_p50": pct(run["admit_step_ms"], 0.5),
        "admit_steps": len(run["admit_step_ms"]),
        "ttft_ms_p50": pct(run["ttft_ms"], 0.5), "ttft_ms_p99": pct(run["ttft_ms"], 0.99),
        "served_tok_s": gen_tokens / run["wall_s"], "wall_s": run["wall_s"],
        "slot_layout_ttft_ms": slot_serving,
        "profile_steps": 16, **serve_profile,
        "yardstick_xla_8req": {
            "ms_per_step_p50": pct(yard["pump_ms_per_step"], 0.5),
            "decode_tok_s": SERVE["n_slots"] * 1e3 / pct(
                yard["full_batch_ms_per_step"] or yard["pump_ms_per_step"], 0.5),
            "served_tok_s": sum(len(t) for t in yard["tokens"]) / yard["wall_s"],
            "ttft_ms_p50": pct(yard["ttft_ms"], 0.5), "wall_s": yard["wall_s"],
        },
    })
    del lm
    torch.cuda.empty_cache()

    # paged_preempt_int8: a tight pool, then the int8 arena, 4 layers --------------------
    lm4 = tfm.init_params(torch.Generator(device=dev).manual_seed(1),
                          **dict(MISTRAL, n_layers=4), device=dev)
    long = [rng.integers(1, vocab, n).astype(np.int32) for n in rng.integers(600, 1201, 8)]
    pa.paged_decode_attention_launches.reset()
    tight = sv.ContinuousBatcher(lm4, n_heads, **SERVE, **PAGED, kv_blocks=PREEMPT_KV_BLOCKS,
                                 attn_impl="pallas", device=dev)
    s0 = tight.stats()["steps"]
    run_t = drive_paged(tight, long, PREEMPT_NEW)
    st_t = tight.stats()
    k4_tight = pa.paged_decode_attention_launches.count
    if k4_tight != 4 * (st_t["steps"] - s0):
        raise AssertionError(f"paged_preempt: K4 launched {k4_tight} times for 4 x "
                             f"{st_t['steps'] - s0}")
    if st_t["kv_preemptions"] <= 0:
        raise AssertionError("paged_preempt: the tight pool never ran dry")
    del tight
    roomy = sv.ContinuousBatcher(lm4, n_heads, **SERVE, **PAGED, attn_impl="pallas", device=dev)
    run_r = drive_paged(roomy, long, PREEMPT_NEW)
    if roomy.stats()["kv_preemptions"]:
        raise AssertionError("paged_preempt: the unpreempted reference was preempted")
    del roomy
    parted = bad = near = 0
    with torch.no_grad():
        for p, got, want in zip(long, run_t["tokens"], run_r["tokens"]):
            parted += stream_check(torch, np, tfm, lm4, p, got, want, MARGIN_REL, torch.float32)
            seq = torch.as_tensor(np.concatenate([p, got[:-1]])[None], device=dev)
            b_, n_ = margin_check(torch, tfm.apply(lm4, seq, n_heads)[0, len(p) - 1:], got)
            bad += b_
            near += n_
    if bad:
        raise AssertionError(f"paged_preempt: {bad} tokens differ from the no-cache argmax")
    # int8 arena, bfloat16 compute: K4 against the inline attention
    budget8 = NEW_TOKENS
    streams = {}
    launches8 = steps8 = 0
    for impl in ("pallas", "xla"):
        cb8 = sv.ContinuousBatcher(lm4, n_heads, **SERVE, **PAGED, attn_impl=impl,
                                   cache_dtype="int8", compute_dtype=torch.bfloat16, device=dev)
        pa.paged_decode_attention_launches.reset()
        s0 = cb8.stats()["steps"]
        streams[impl] = drive_paged(cb8, long, budget8)
        if impl == "pallas":
            launches8 = pa.paged_decode_attention_launches.count
            steps8 = cb8.stats()["steps"] - s0
        del cb8
    if launches8 != 4 * steps8:
        raise AssertionError(f"paged_int8: K4 launched {launches8} times for 4 x {steps8}")
    parted8 = bad8 = near8 = 0
    int8_f32_rel = 0.0
    attn = pa.make_paged_attention()
    with torch.no_grad():
        for p, got, want in zip(long, streams["pallas"]["tokens"], streams["xla"]["tokens"]):
            parted8 += stream_check(torch, np, tfm, lm4, p, got, want, MARGIN_REL_BF16,
                                    torch.bfloat16)
            # teacher-forced on the xla batcher's tokens, one request alone:
            # K4's greedy choices equal the inline attention's on the same
            # int8 arena (near-ties exempt), in bfloat16 and in float32
            for dt, rel in ((torch.bfloat16, MARGIN_REL_BF16), (torch.float32, MARGIN_REL)):
                xla = paged_through_cache_logits(torch, np, tfm, dec, kvg, kvb, lm4, p, want,
                                                 None, dt, "int8")
                k4 = paged_through_cache_logits(torch, np, tfm, dec, kvg, kvb, lm4, p, want,
                                                attn, dt, "int8")
                b_, n_ = margin_check(torch, xla, k4.argmax(dim=-1).tolist(), rel)
                bad8 += b_
                near8 += n_
            int8_f32_rel = max(int8_f32_rel, float(
                ((k4 - xla).abs().amax(-1) / xla.abs().amax(-1)).max()))
    if bad8 or not int8_f32_rel <= INT8_F32_LOGIT_TOL:
        raise AssertionError(f"paged_int8: {bad8} K4 choices differ from the xla path's argmax; "
                             f"float32 logits rel err {int8_f32_rel}")
    int8_arena_gb = 2 * 4 * (2048 + 1) * 16 * (MISTRAL["n_kv_heads"] * hd
                                              + MISTRAL["n_kv_heads"] * 4) / 1e9
    emit({
        "phase": "paged_preempt_int8", "layers": 4, "requests": len(long),
        "prompt_lengths": [len(p) for p in long],
        "tight": {"kv_blocks": PREEMPT_KV_BLOCKS, "new_tokens": PREEMPT_NEW,
                  "compute_dtype": "float32", "preemptions": st_t["kv_preemptions"],
                  "prefill_chunk_forwards": st_t["kv_prefill_chunks"],
                  "k4_launches": k4_tight, "layers_x_steps": 4 * (st_t["steps"] - s0),
                  "streams_parted_at_near_tie": parted, "greedy_mismatches": bad,
                  "near_tie_exempt": near, "margin_rel": MARGIN_REL,
                  "blocks_in_use_after_drain": st_t["kv_blocks_in_use"],
                  "wall_s": run_t["wall_s"], "unpreempted_wall_s": run_r["wall_s"]},
        "int8": {"compute_dtype": "bfloat16", "cache_dtype": "int8", "new_tokens": budget8,
                 "k4_launches": launches8, "layers_x_steps": 4 * steps8,
                 "streams_parted_at_near_tie_vs_xla": parted8,
                 "teacher_forced_mismatches": bad8, "teacher_forced_near_tie_exempt": near8,
                 "k4_vs_xla_logit_max_rel_err_f32": int8_f32_rel,
                 "f32_logit_tolerance": INT8_F32_LOGIT_TOL,
                 "margin_rel_bf16": MARGIN_REL_BF16, "arena_gb": int8_arena_gb,
                 "ms_per_step_p50": pct(streams["pallas"]["pump_ms_per_step"], 0.5),
                 "xla_ms_per_step_p50": pct(streams["xla"]["pump_ms_per_step"], 0.5)},
    })
    del lm4
    torch.cuda.empty_cache()

    # paged_pipeline: the element pair with kv-layout=paged ------------------------------
    pipe_prompts = [rng.integers(1, vocab, n).astype(np.int32)
                    for n in rng.integers(32, 257, 12)]
    budgets = [16 if i % 3 == 0 else 32 for i in range(len(pipe_prompts))]
    pl = parse_pipeline(LLM_PIPELINE_PAGED.format(opts=PIPE_OPTS), device=dev)
    pa.paged_decode_attention_launches.reset()
    ex = pl.start()
    from nnstreamer_tpu_torch.tensors.frame import Frame

    for i, (p, n) in enumerate(zip(pipe_prompts, budgets)):
        meta = {"req": i} if n == 32 else {"req": i, "max_new_tokens": n}
        pl["src"].push(Frame((p,), meta=meta))
    pl["src"].end_of_stream()
    done = ex.wait(600)
    ex.stop()
    if ex.errors or not done:
        raise AssertionError(f"paged_pipeline: {ex.errors or 'no EOS within 600 s'}")
    pipe_k4 = pa.paged_decode_attention_launches.count
    pipe_stats = pl["ssrc"].serving_stats()
    pipe_programs = replayed_programs(pipe_stats, "paged_pipeline")
    got = {f.meta["req"]: f.tensors[0][0].tolist() for f in pl["out"].frames}
    if sorted(got) != list(range(len(pipe_prompts))):
        raise AssertionError(f"paged_pipeline: requests back {sorted(got)}")
    if pipe_k4 != 2 * pipe_stats["steps"]:
        raise AssertionError(f"paged_pipeline: K4 launched {pipe_k4} times for 2 x "
                             f"{pipe_stats['steps']}")
    if pipe_stats["kv_blocks_in_use"] != 0 or pipe_stats["kv_blocks"] != KV_BLOCKS:
        raise AssertionError(f"paged_pipeline: kv stats {pipe_stats}")
    m = zoo.get("transformer_lm", device=dev,
                **dict(kv.split(":") for kv in PIPE_OPTS.split(",")))
    direct = sv.ContinuousBatcher(m.params, n_heads, **SERVE, **PAGED, kv_blocks=KV_BLOCKS,
                                  attn_impl="pallas", device=dev)
    rids = []
    for p, n in zip(pipe_prompts, budgets):
        while (rid := direct.submit(p, n)) is None:
            direct.step()
        rids.append(rid)
    while any(direct.result(r) is None for r in rids):
        direct.step()
    want = [direct.result(r) for r in rids]
    diff = [i for i in range(len(pipe_prompts)) if got[i] != want[i]]
    if diff:
        raise AssertionError(f"paged_pipeline: requests {diff} differ from the direct batcher")
    del m, direct
    torch.cuda.empty_cache()
    emit({"phase": "paged_pipeline", "requests": len(pipe_prompts), "layers": 2,
          "k4_launches": pipe_k4, "steps": pipe_stats["steps"],
          "layers_x_steps": 2 * pipe_stats["steps"], "program_replays": pipe_programs,
          "equal_to_direct_batcher": True,
          "meta_returned": True, "kv_blocks": pipe_stats["kv_blocks"],
          "kv_blocks_in_use": pipe_stats["kv_blocks_in_use"],
          "tokens_first_request": got[0][:8]})
    return k4_main, k4_launches


# -- the serving engine's one-program pump (CUDA graphs of the decode steps) --------------

# eager oracle and replays in turns, each run on a fresh batcher
GRAPH_MODES = ("eager", "replay", "replay", "eager")
# serving_graphs' depth: its checks (eager = replayed streams, launches,
# device records, one graph launch a pump) do not depend on it, and the
# full-width replayed step is measured by serving, paged_serving and
# windowed_ring; cut from 32 so that the whole script keeps its time limit
GRAPH_LAYERS = 8
GRAPH_PROFILE_PUMPS = 2  # two pumps of 8: a 16-step window
# the sampling check's per-request settings, cycled
SAMPLING_KW = (dict(temperature=0.8, top_k=40, seed=1), dict(temperature=1.0, top_p=0.9, seed=2),
               {}, dict(temperature=0.6, top_k=5, top_p=0.95, seed=4))


def sampling_traffic(np):
    """The sampling check's 12 prompts of 64-256 tokens."""
    rng = np.random.default_rng(5)
    return [rng.integers(1, MISTRAL["vocab"], n).astype(np.int32)
            for n in rng.integers(64, 257, 12)]


def settle(cb, pump):
    """Pumps of one until every claimed slot decodes (the paged layout
    admits one prefilled request a pump)."""
    while any(r is not None and not cb._active[s] for s, r in enumerate(cb._slots)):
        pump(1)


def graph_profile(torch, cb, prompts, eager, extra, counter, n_layers):
    """A full batch (the run's first 8 prompts, 48 new tokens each) for
    GRAPH_PROFILE_PUMPS pumps of 8 in one mode under torch.profiler: host
    runtime-API launches a pump, device time a step by class, the busy
    share. One pump of 8 runs before the profile (in replay mode it fills
    the n = 8 program) and one in the profiler's warm-up step, whose
    records are dropped. The attention kernel's device records in the
    window (its split and its combine kernel, ``extra``'s key) must equal
    2 x the launches ``counter`` took, and those layers x steps: in replay
    mode the counts come from the capture's tally, so this shows they are
    the kernels the replays ran. As in ``launches_eager_vs_replay``, the
    counted pumps start and end 10 ms inside the recorded window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    pump = cb.step_pump_eager if eager else cb.step_pump
    for p in prompts[:SERVE["n_slots"]]:
        cb.submit(p, 48)
    settle(cb, pump)
    pump(8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        pump(8)
        torch.cuda.synchronize()
        prof.step()
        counter.reset()
        time.sleep(0.01)
        t0 = time.perf_counter()
        for _ in range(GRAPH_PROFILE_PUMPS):
            pump(8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(0.01)
    launched = counter.count
    if not all(cb._active):
        raise AssertionError("serving_graphs: a slot went idle inside the profiled window")
    while cb.n_free < SERVE["n_slots"]:
        pump(8)
    k, g, m = host_launches(prof)
    steps = 8 * GRAPH_PROFILE_PUMPS
    (cls, sub), = extra
    records = sum(ev.count for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA and sub in ev.key)
    if launched != n_layers * steps or records != 2 * launched:
        raise AssertionError(f"serving_graphs {'eager' if eager else 'replay'}: {cls} counted "
                             f"{launched} launches for {n_layers} x {steps} steps, "
                             f"{records} device records (2 a launch)")
    prof_cls = profile_classes(torch, prof, wall, extra, main=MATMUL_KEYS)
    return {
        "kernel_launches_per_pump": k / GRAPH_PROFILE_PUMPS,
        "graph_launches_per_pump": g / GRAPH_PROFILE_PUMPS,
        "memcpy_calls_per_pump": m / GRAPH_PROFILE_PUMPS,
        "window_steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
        "attention_launches": launched, "attention_device_records": records,
        **per_step(prof_cls, steps),
    }


def matmul_capture_check(torch, capture, lm, dev):
    """Each matmul shape of the decode step (layer 0's four and the head) at
    M = 8, eager against one CUDA-graph replay on the same input: whether
    cuBLAS gives the same bits under capture."""
    import torch.nn.functional as F

    blk = lm.blocks[0]
    out = {}
    g = torch.Generator(device=dev).manual_seed(3)
    for name, w in (("wqkv", blk.wqkv.weight), ("wo", blk.wo.weight),
                    ("w_gate", blk.w_gate.weight), ("w_down", blk.w_down.weight),
                    ("head", lm.head.weight)):
        x = torch.randn((8, 1, w.shape[1]), generator=g, device=dev)
        with torch.no_grad():
            want = F.linear(x, w)
            cap = capture(lambda x=x, w=w: F.linear(x, w), dev)
            cap.graph.replay()
            torch.cuda.synchronize()
            out[name] = {"shape": list(w.shape),
                         "bit_equal": bool(torch.equal(cap.outputs, want)),
                         "max_abs_diff": float((cap.outputs - want).abs().max())}
        del cap
    return out


def graphs_cell(torch, np, sv, tfm, lm, dev, name, prompts, kw, counter, zero_counter, extra):
    """One layout at full width: its 16-request traffic on a fresh batcher
    per mode of GRAPH_MODES, each after the same warm-up (which fills the
    n = 1 and n = 8 programs in replay mode); counted launches = layers x
    steps in every run; every run's streams against the first eager run's
    under the margin rule; then the eager and replay profiles."""
    paged = kw.get("kv_layout") == "paged"
    drive = drive_paged if paged else drive_requests
    n_layers = lm.n_layers
    runs, parted, programs = [], 0, None
    for mode in GRAPH_MODES:
        eager = mode == "eager"
        cb = sv.ContinuousBatcher(lm, MISTRAL["n_heads"], **SERVE, **kw, attn_impl="pallas",
                                  device=dev)
        drive(cb, [prompts[0][:64]], 4, eager=eager)  # warm-up: cuBLAS, the programs' fills
        st0 = cb.stats()
        counter.reset()
        zero_counter.reset()
        run = drive(cb, prompts, NEW_TOKENS, eager=eager)
        st = cb.stats()
        steps = st["steps"] - st0["steps"]
        if counter.count != n_layers * steps or zero_counter.count:
            raise AssertionError(f"serving_graphs {name} {mode}: counted {counter.count} "
                                 f"launches for {n_layers} x {steps} steps "
                                 f"(the other kernel {zero_counter.count})")
        if any(t is None or len(t) != NEW_TOKENS for t in run["tokens"]):
            raise AssertionError(f"serving_graphs {name} {mode}: a request came back short")
        progs = st["programs"]
        if eager and progs:
            raise AssertionError(f"serving_graphs {name}: the eager oracle filled {list(progs)}")
        if not eager:
            if not progs or not all(p["captured"] for p in progs.values()):
                raise AssertionError(f"serving_graphs {name}: programs not captured: {progs}")
            if programs is None:
                programs = {"programs": progs, "build_s": st["build_s"],
                            "host_state_builds": st["host_state_builds"]}
        if runs:
            for p, got, want in zip(prompts, run["tokens"], runs[0]["tokens"]):
                parted += stream_check(torch, np, tfm, lm, p, got, want, MARGIN_REL,
                                       torch.float32)
        full = run.get("full_batch_ms_per_step") or run["pump_ms_per_step"]
        tpot = run["pump_ms_per_step"] if paged else run["step_ms"]
        runs.append({
            "mode": mode, "tokens": run["tokens"], "steps": steps,
            "launches": counter.count, "layers_x_steps": n_layers * steps,
            "tpot_ms_p50": pct(tpot, 0.5), "tpot_ms_p99": pct(tpot, 0.99),
            "pump_ms_per_step_p50": pct(run["pump_ms_per_step"], 0.5),
            "pump_ms_per_step_p99": pct(run["pump_ms_per_step"], 0.99),
            "decode_tok_s": SERVE["n_slots"] * 1e3 / pct(full if paged else tpot, 0.5),
            "served_tok_s": sum(len(t) for t in run["tokens"]) / run["wall_s"],
            "wall_s": run["wall_s"], "admit_step_ms_p50": pct(run["admit_step_ms"], 0.5),
            "ttft_ms_p50": pct(run["ttft_ms"], 0.5),
            "host_state_builds": st["host_state_builds"] - st0["host_state_builds"],
        })
        del cb
        torch.cuda.empty_cache()
    cb = sv.ContinuousBatcher(lm, MISTRAL["n_heads"], **SERVE, **kw, attn_impl="pallas",
                              device=dev)
    drive(cb, [prompts[0][:64]], 4)
    prof = {mode: graph_profile(torch, cb, prompts, mode == "eager", extra, counter, n_layers)
            for mode in ("eager", "replay")}
    del cb
    torch.cuda.empty_cache()
    if prof["replay"]["graph_launches_per_pump"] != 1:
        raise AssertionError(f"serving_graphs {name}: {prof['replay']['graph_launches_per_pump']}"
                             " cudaGraphLaunch records a replayed pump, want 1")
    for r in runs:
        del r["tokens"]
    return {"runs": runs, "streams_parted_at_near_tie": parted, "profile": prof, **programs}


def serving_graphs_phases(torch, np, dev):
    """The serving_graphs group: slot (K3) and paged (K4) at Mistral-7B's
    widths, GRAPH_LAYERS layers, eager oracle against replays; the matmuls
    under capture; the sampling pump at 4 layers, replayed against eager."""
    from nnstreamer_tpu_torch.capture import capture
    from nnstreamer_tpu_torch.models import serving as sv
    from nnstreamer_tpu_torch.models import transformer as tfm
    from nnstreamer_tpu_torch.ops.kernels import decode_attention as da
    from nnstreamer_tpu_torch.ops.kernels import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    t_group = time.perf_counter()
    lm = tfm.init_params(torch.Generator(device=dev).manual_seed(0),
                         **dict(MISTRAL, n_layers=GRAPH_LAYERS), device=dev)
    weights_gb = sum(p.numel() * p.element_size() for p in lm.parameters()) / 1e9
    matmul_gb = sum(m.weight.numel() * m.weight.element_size() for m in lm.modules()
                    if isinstance(m, torch.nn.Linear)) / 1e9
    out = {"phase": "serving_graphs", **MISTRAL, "n_layers": GRAPH_LAYERS, **SERVE,
           "compute_dtype": "float32",
           "new_tokens": NEW_TOKENS, "modes": list(GRAPH_MODES), "weights_gb": weights_gb,
           "matmul_weights_gb": matmul_gb,
           # the matmuls read every weight once a step: their bound a step
           "matmul_bound_ms_per_step": matmul_gb * 1e9 / PEAK_BYTES_S * 1e3,
           "matmul_capture": matmul_capture_check(torch, capture, lm, dev)}
    with torch.no_grad():
        out["slot"] = graphs_cell(
            torch, np, sv, tfm, lm, dev, "slot", slot_traffic(np, np.random.default_rng(0)), {},
            da.decode_attention_launches, pa.paged_decode_attention_launches,
            [("decode_attention (K3)", "decode_attention")])
        emit({"phase": "serving_graphs_slot", **out["slot"]})
        out["paged"] = graphs_cell(
            torch, np, sv, tfm, lm, dev, "paged", paged_traffic(np, np.random.default_rng(0)),
            dict(PAGED, kv_blocks=KV_BLOCKS), pa.paged_decode_attention_launches,
            da.decode_attention_launches, [("paged_decode_attention (K4)", "paged_attention")])
        emit({"phase": "serving_graphs_paged", **out["paged"]})
    del lm
    torch.cuda.empty_cache()
    # the sampling pump, 4 layers: replayed tokens equal the eager oracle's
    lm4 = tfm.init_params(torch.Generator(device=dev).manual_seed(1),
                          **dict(MISTRAL, n_layers=4), device=dev)
    prompts = sampling_traffic(np)
    sampled = {}
    for name, kw in (("slot", {}), ("paged", dict(PAGED, kv_blocks=KV_BLOCKS))):
        streams = []
        for mode in ("eager", "replay"):
            cb = sv.ContinuousBatcher(lm4, MISTRAL["n_heads"], **SERVE, **kw, attn_impl="pallas",
                                      device=dev)
            pump = cb.step_pump_eager if mode == "eager" else cb.step_pump
            rids, todo = [], list(enumerate(prompts))
            while todo or any(cb.result(r) is None for r in rids):
                while todo and (rid := cb.submit(todo[0][1], 48,
                                                 **SAMPLING_KW[todo[0][0] % 4])) is not None:
                    rids.append(rid)
                    todo.pop(0)
                pump(8)
            streams.append([cb.result(r) for r in rids])
            keys = sorted(cb.stats()["programs"])
            del cb
        if streams[0] != streams[1]:
            diff = [i for i, (a, b) in enumerate(zip(*streams)) if a != b]
            raise AssertionError(f"serving_graphs sampling {name}: requests {diff} differ "
                                 "between the replays and the eager oracle")
        if not any("sampling" in k for k in keys):
            raise AssertionError(f"serving_graphs sampling {name}: no sampling program: {keys}")
        sampled[name] = {"requests": len(prompts), "tokens": sum(len(t) for t in streams[1]),
                         "programs": keys, "equal": True}
    del lm4
    torch.cuda.empty_cache()
    emit({"phase": "serving_graphs_sampling", "layers": 4, **sampled})
    out["sampling"] = sampled
    out["seconds"] = time.perf_counter() - t_group
    return out


# -- speculative decoding and registered prefixes (ROADMAP A.4, first half) ------------

SPEC_ROUNDS, SPEC_K, SPEC_G = 2, 4, 2  # the spec pump of every speculative phase
# the speculative group's depth (spec_ngram, prefixes): its checks (replayed
# spec = eager, launches = layers x steps, one graph launch a spec pump) do
# not depend on it; cut from 32 so that the whole script keeps its time limit
SPEC_LAYERS = 8
SPEC_PROFILE_PUMPS = 2
SPEC_PROFILE_NEW = 200  # the profiled batch's budget: no slot finishes in the window
DRAFT_REQUESTS, DRAFT_NEW = 8, 32
PREFIX_LEN, PREFIX_REQUESTS, PREFIX_NEW = 256, 8, 32


def spec_traffic(np, rng):
    """The speculative group's 16 prompts of 64-256 tokens, alternating: a
    periodic one (a random 3-7-token pattern tiled, as
    tests/test_speculative.py builds them: n-gram lookup can hit it) and a
    random one."""
    vocab = MISTRAL["vocab"]
    out = []
    for i, n in enumerate(rng.integers(64, 257, 16)):
        if i % 2 == 0:
            pat = rng.integers(1, vocab, int(rng.integers(3, 8)))
            out.append(np.tile(pat, -(-int(n) // len(pat)))[:n].astype(np.int32))
        else:
            out.append(rng.integers(1, vocab, n).astype(np.int32))
    return out


def spec_pump_of(eager, rounds=SPEC_ROUNDS, k=SPEC_K, g=SPEC_G):
    if eager:
        return lambda cb: cb.spec_pump_eager(rounds, k, g)
    return lambda cb: cb.spec_pump(rounds, k, g)


def drive_runs(cb, prompts, budget, run):
    """Serve ``prompts`` through ``cb``: submit while a slot is free, then
    one ``run(cb)`` (a pump or a spec pump → {rid: tokens}) a turn. For
    each run on a full batch (every slot decoding, nothing queued, every
    slot emitting): its wall ms over the tokens it emitted a slot, the
    time a stream waits for each token. Host clock; every run ends in a
    read of the host."""
    queue = list(enumerate(prompts))
    rid_of, per_token = {}, []
    t_start = time.perf_counter()
    while queue or any(cb.result(r) is None for r in rid_of.values()):
        while queue and cb.n_free:
            rid = cb.submit(queue[0][1], budget)
            if rid is None:
                break
            rid_of[queue.pop(0)[0]] = rid
        full = (not cb.n_free and not cb._pending and cb._active.all()
                and not (cb._paged and cb._prefill_q))
        t0 = time.perf_counter()
        got = run(cb)
        ms = (time.perf_counter() - t0) * 1e3
        n = sum(len(t) for t in got.values())
        if full and len(got) == cb.n_slots:
            per_token.append(ms * cb.n_slots / n)
    return {"tokens": [cb.result(rid_of[i]) for i in range(len(prompts))],
            "wall_s": time.perf_counter() - t_start, "ms_per_token": sorted(per_token)}


def wait_pcts(per_token):
    """p50 and p99 of a drive's full-batch ms a token, None without one."""
    if not per_token:
        return {"ms_per_token_p50": None, "ms_per_token_p99": None}
    return {"ms_per_token_p50": pct(per_token, 0.5), "ms_per_token_p99": pct(per_token, 0.99)}


def spec_counters(st, st0=None):
    """The speculative counters of ``st`` (less those of ``st0``)."""
    keys = ("spec_rounds", "spec_accepted_tokens", "spec_columns", "tokens_emitted", "steps")
    out = {k: st[k] - (st0[k] if st0 else 0) for k in keys}
    out["spec_acceptance_rate"] = (out["spec_accepted_tokens"] / out["spec_columns"]
                                   if out["spec_columns"] else 0.0)
    out["tokens_per_round"] = (out["tokens_emitted"] / out["spec_rounds"]
                               if out["spec_rounds"] else 0.0)
    return out


def spec_programs(st):
    """The spec programs a batcher filled: {name: (captured, replays,
    allocated bytes, reserved bytes)} and their reserved bytes in all."""
    progs = {n: [p["captured"], p["replays"], p["allocated_bytes"], p["reserved_bytes"]]
             for n, p in st["programs"].items() if "/spec-" in n}
    return {"programs": progs, "reserved_bytes": sum(p[3] for p in progs.values())}


def kernel_subtree(ev):
    """The device kernels a profiler event and its CPU children launched."""
    yield from ev.kernels
    for child in ev.cpu_children:
        yield from kernel_subtree(child)


def spec_profile(torch, tfm, make, prompts, eager):
    """A full batch (8 of ``prompts``) for SPEC_PROFILE_PUMPS spec pumps in
    one mode under torch.profiler, after the batch settled and one pump
    more (the replay mode's fill), a warm-up step dropped: host kernel /
    graph launches and memcpy calls a pump, device ms a round and the busy
    share. In the eager mode the verify attention (``cache_attention``) is
    annotated, so its kernels are told from the weight matmuls'."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    cb = make()
    run = spec_pump_of(eager)
    for p in prompts[:SERVE["n_slots"]]:
        cb.submit(p, SPEC_PROFILE_NEW)
    settle(cb, lambda n: run(cb))
    run(cb)
    torch.cuda.synchronize()
    orig = tfm.cache_attention

    def annotated(*a, **kw):
        with record_function("verify_attention"):
            return orig(*a, **kw)

    if eager:
        tfm.cache_attention = annotated
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            run(cb)
            torch.cuda.synchronize()
            prof.step()
            time.sleep(0.01)
            t0 = time.perf_counter()
            for _ in range(SPEC_PROFILE_PUMPS):
                run(cb)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(0.01)
    finally:
        tfm.cache_attention = orig
    if not cb._active.all():
        raise AssertionError("speculative: a slot went idle inside the profiled window")
    del cb
    k, g, m = host_launches(prof)
    rounds = SPEC_PROFILE_PUMPS * SPEC_ROUNDS
    cls = profile_classes(torch, prof, wall, [], main=MATMUL_KEYS,
                          annotations=("verify_attention",))
    out = {"kernel_launches_per_pump": k / SPEC_PROFILE_PUMPS,
           "graph_launches_per_pump": g / SPEC_PROFILE_PUMPS,
           "memcpy_calls_per_pump": m / SPEC_PROFILE_PUMPS, "window_rounds": rounds,
           "wall_ms_per_round": wall * 1e3 / rounds,
           "device_busy_share": cls["device_busy_share"],
           "top_kernels": cls["top_kernels"][:5]}
    if not cls["device_kernels"]:
        out["device_ms_per_round"] = "not measured"
        return out
    out["device_ms_per_round"] = cls["device_ms"] / rounds
    if eager:
        att = [kk for ev in prof.events() if ev.name == "verify_attention"
               for kk in kernel_subtree(ev)]
        att_ms = sum(kk.duration for kk in att) / 1e3
        att_mm = sum(kk.duration for kk in att
                     if any(t in kk.name.lower() for t in MATMUL_KEYS[1])) / 1e3
        mm = cls["device_ms_by_class"]["matmul"]
        out["device_ms_per_round_by_class"] = (
            {"matmul": (mm - att_mm) / rounds, "verify_attention": att_ms / rounds,
             "other": (cls["device_ms"] - mm - att_ms + att_mm) / rounds}
            if att else "not measured (no kernel linked to the annotation)")
    return out


def near_ties(torch, np, tfm, lm, prompt, toks, rel=MARGIN_REL):
    """Positions of ``toks`` whose no-cache top-2 margin (teacher-forced on
    the prompt and the stream) is below ``rel`` x max |logit|."""
    seq = torch.as_tensor(np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])[None],
                          device=lm.embed.device)
    logits = tfm.apply(lm, seq, MISTRAL["n_heads"])[0, len(prompt) - 1:].float()
    return margin_check(torch, logits, toks, rel)[1]


def spec_ngram_cell(torch, np, sv, tfm, lm, dev, name, prompts, kw, counter, zero_counter):
    """One layout at full width: the plain pump's streams (the oracle,
    counted K3 / K4 = layers x steps), then spec pumps eager and replayed
    on fresh batchers; the checks and numbers of phase 18b's spec_ngram."""
    n_layers = lm.n_layers

    def make(**extra):
        return sv.ContinuousBatcher(lm, MISTRAL["n_heads"], **SERVE, **kw, **extra,
                                    attn_impl="pallas", device=dev)

    cb = make()
    drive_runs(cb, [prompts[0][:64]], 4, lambda c: c.step_pump(8))  # fills, cuBLAS
    st0 = cb.stats()
    counter.reset()
    zero_counter.reset()
    plain = drive_runs(cb, prompts, NEW_TOKENS, lambda c: c.step_pump(8))
    steps = cb.stats()["steps"] - st0["steps"]
    if counter.count != n_layers * steps or zero_counter.count:
        raise AssertionError(f"speculative {name} plain: counted {counter.count} launches for "
                             f"{n_layers} x {steps} steps (the other kernel {zero_counter.count})")
    plain_launches = counter.count
    del cb
    torch.cuda.empty_cache()
    runs = {}
    for mode in ("eager", "replay"):
        cb = make()
        run = spec_pump_of(mode == "eager")
        drive_runs(cb, [prompts[0][:64]], 4, run)
        st0 = cb.stats()
        counter.reset()
        res = drive_runs(cb, prompts, NEW_TOKENS, run)
        st = cb.stats()
        runs[mode] = {"tokens": res["tokens"], "wall_s": res["wall_s"],
                      **wait_pcts(res["ms_per_token"]),
                      "full_batch_runs": len(res["ms_per_token"]),
                      "attention_kernel_launches": counter.count,
                      **spec_counters(st, st0), **spec_programs(st)}
        if mode == "replay" and not all(p[0] for p in runs[mode]["programs"].values()):
            raise AssertionError(f"speculative {name}: spec programs not captured: "
                                 f"{runs[mode]['programs']}")
        if mode == "eager" and runs[mode]["programs"]:
            raise AssertionError(f"speculative {name}: the eager oracle filled programs")
        del cb
        torch.cuda.empty_cache()
    if runs["eager"]["tokens"] != runs["replay"]["tokens"]:
        diff = [i for i, (a, b) in enumerate(zip(runs["eager"]["tokens"],
                                                 runs["replay"]["tokens"])) if a != b]
        raise AssertionError(f"speculative {name}: replayed spec streams {diff} differ from eager")
    if any(t is None or len(t) != NEW_TOKENS for t in runs["replay"]["tokens"]):
        raise AssertionError(f"speculative {name}: a request came back short")
    parted = sum(stream_check(torch, np, tfm, lm, p, got, want, MARGIN_REL, torch.float32)
                 for p, got, want in zip(prompts, runs["replay"]["tokens"], plain["tokens"]))
    if runs["replay"]["spec_accepted_tokens"] <= 0:
        raise AssertionError(f"speculative {name}: no proposal accepted on periodic prompts")
    prof = {mode: spec_profile(torch, tfm, make, prompts, mode == "eager")
            for mode in ("replay", "eager")}
    if prof["replay"]["graph_launches_per_pump"] != 1 or prof["replay"]["kernel_launches_per_pump"]:
        raise AssertionError(f"speculative {name}: a replayed spec pump launched "
                             f"{prof['replay']['graph_launches_per_pump']} graphs and "
                             f"{prof['replay']['kernel_launches_per_pump']} kernels, want 1 and 0")
    for r in runs.values():
        del r["tokens"]
    return {"plain": {**wait_pcts(plain["ms_per_token"]),
                      "full_batch_runs": len(plain["ms_per_token"]), "wall_s": plain["wall_s"],
                      "steps": steps,
                      "attention_launches": plain_launches, "layers_x_steps": n_layers * steps},
            "spec": runs, "streams_parted_at_near_tie": parted, "profile": prof}


def draft_self_phase(torch, np, sv, tfm, lm, dev, prompts, want):
    """spec_draft_self: the target as its own draft, spec pumps with plain
    pumps between them (which step the draft too): every proposal is
    accepted unless the no-cache forward has a near-tie there, and the
    streams are the plain pump's (``want``) under the margin rule."""
    cb = sv.ContinuousBatcher(lm, MISTRAL["n_heads"], **SERVE, attn_impl="pallas", device=dev,
                              draft_params=lm, draft_n_heads=MISTRAL["n_heads"])
    turn = [0]

    def run(c):
        turn[0] += 1
        return c.step_pump(2) if turn[0] % 3 == 0 else c.spec_pump(SPEC_ROUNDS, SPEC_K)

    drive_runs(cb, [prompts[0][:64]], 8, run)
    st0 = cb.stats()
    res = drive_runs(cb, prompts, DRAFT_NEW, run)
    st = cb.stats()
    out = {"requests": len(prompts), "new_tokens": DRAFT_NEW, **spec_counters(st, st0),
           **spec_programs(st), "wall_s": res["wall_s"], **wait_pcts(res["ms_per_token"])}
    del cb
    torch.cuda.empty_cache()
    rejected = out["spec_columns"] - out["spec_accepted_tokens"]
    ties = sum(near_ties(torch, np, tfm, lm, p, t) for p, t in zip(prompts, res["tokens"])
               ) if rejected else 0
    if rejected > ties:
        raise AssertionError(f"spec_draft_self: {rejected} proposals rejected, {ties} near-ties")
    out["rejected"], out["near_ties"] = rejected, ties
    out["streams_parted_at_near_tie"] = sum(
        stream_check(torch, np, tfm, lm, p, got, w[:DRAFT_NEW], MARGIN_REL, torch.float32)
        for p, got, w in zip(prompts, res["tokens"], want))
    return out


def prefix_cell(torch, np, sv, tfm, lm, dev, name, kw, counter, system, tails):
    """One layout: the registered prefix and PREFIX_REQUESTS prefix=
    requests, then the same requests concatenated on a fresh batcher;
    admission ms (submits until every request decodes), K3 / K4 = layers x
    steps on the decode that follows, the streams under the margin rule."""
    out, streams = {}, {}
    for mode in ("prefix", "concatenated"):
        cb = sv.ContinuousBatcher(lm, MISTRAL["n_heads"], **SERVE, **kw, attn_impl="pallas",
                                  device=dev)
        drive_runs(cb, [tails[0][:64]], 4, lambda c: c.step_pump(8))  # fills, cuBLAS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pid = cb.register_prefix(system) if mode == "prefix" else None
        torch.cuda.synchronize()
        register_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rids = [cb.submit(t, PREFIX_NEW, prefix=pid) if pid is not None
                else cb.submit(np.concatenate([system, t]), PREFIX_NEW) for t in tails]
        if None in rids:
            raise AssertionError(f"prefixes {name}: {len(tails)} requests, {cb.n_slots} slots")
        settle(cb, cb.step_pump)
        torch.cuda.synchronize()
        admit_ms = (time.perf_counter() - t0) * 1e3
        st0 = cb.stats()
        counter.reset()
        while any(cb.result(r) is None for r in rids):
            cb.step_pump(8)
        steps = cb.stats()["steps"] - st0["steps"]
        if counter.count != lm.n_layers * steps:
            raise AssertionError(f"prefixes {name} {mode}: counted {counter.count} launches "
                                 f"for {lm.n_layers} x {steps} steps")
        streams[mode] = [cb.result(r) for r in rids]
        out[mode] = {"admission_ms": admit_ms, "register_ms": register_ms,
                     "decode_steps": steps, "attention_launches": counter.count,
                     "prefix_hits": cb.stats().get("kv_prefix_hits"),
                     "prefixes_registered": cb.stats()["prefixes_registered"]}
        del cb
        torch.cuda.empty_cache()
    out["streams_parted_at_near_tie"] = sum(
        stream_check(torch, np, tfm, lm, np.concatenate([system, t]), a, b, MARGIN_REL,
                     torch.float32)
        for t, a, b in zip(tails, streams["prefix"], streams["concatenated"]))
    return out


def speculative_phases(torch, np, dev):
    """The speculative group (phase 18b): spec_ngram (slot K3 / paged K4
    oracles), spec_draft_self and prefixes at Mistral-7B's full width
    (SPEC_LAYERS layers);
    spec_sampling at 4 layers. → the group's summary, with K3's and K4's
    counted launches on its plain pumps."""
    from nnstreamer_tpu_torch.models import serving as sv
    from nnstreamer_tpu_torch.models import transformer as tfm
    from nnstreamer_tpu_torch.ops.kernels import decode_attention as da
    from nnstreamer_tpu_torch.ops.kernels import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    t_group = time.perf_counter()
    out = {"phase": "speculative", **MISTRAL, "n_layers": SPEC_LAYERS, **SERVE,
           "compute_dtype": "float32", "rounds": SPEC_ROUNDS, "k": SPEC_K, "ngram": SPEC_G,
           "new_tokens": NEW_TOKENS}
    lm = tfm.init_params(torch.Generator(device=dev).manual_seed(0),
                         **dict(MISTRAL, n_layers=SPEC_LAYERS), device=dev)
    prompts = spec_traffic(np, np.random.default_rng(14))
    k3 = da.decode_attention_launches
    k4 = pa.paged_decode_attention_launches
    with torch.no_grad():
        cells = {}
        for name, kw, counter, other in (("slot", {}, k3, k4),
                                         ("paged", dict(PAGED, kv_blocks=KV_BLOCKS), k4, k3)):
            cells[name] = spec_ngram_cell(torch, np, sv, tfm, lm, dev, name, prompts, kw,
                                          counter, other)
            emit({"phase": f"spec_ngram_{name}", **cells[name]})
        out["spec_ngram"] = cells
        rng = np.random.default_rng(15)
        system = rng.integers(1, MISTRAL["vocab"], PREFIX_LEN).astype(np.int32)
        tails = [rng.integers(1, MISTRAL["vocab"], n).astype(np.int32)
                 for n in rng.integers(64, 257, PREFIX_REQUESTS)]
        prefixes = {}
        for name, kw, counter in (("slot", {}, k3),
                                  ("paged", dict(PAGED, kv_blocks=KV_BLOCKS), k4)):
            prefixes[name] = prefix_cell(torch, np, sv, tfm, lm, dev, name, kw, counter,
                                         system, tails)
        emit({"phase": "prefixes", "prefix_len": PREFIX_LEN, "requests": PREFIX_REQUESTS,
              "new_tokens": PREFIX_NEW, **prefixes})
        out["prefixes"] = prefixes
    del lm
    torch.cuda.empty_cache()
    # the self-draft and the sampling spec pump, 4 layers
    lm4 = tfm.init_params(torch.Generator(device=dev).manual_seed(1),
                          **dict(MISTRAL, n_layers=4), device=dev)
    with torch.no_grad():
        # the plain streams of the first DRAFT_REQUESTS prompts, 32 tokens: what
        # the plain pump gave (greedy streams do not depend on the batch)
        ref = sv.ContinuousBatcher(lm4, MISTRAL["n_heads"], **SERVE, attn_impl="pallas",
                                   device=dev)
        want = drive_runs(ref, prompts[:DRAFT_REQUESTS], DRAFT_NEW,
                          lambda c: c.step_pump(8))["tokens"]
        del ref
        torch.cuda.empty_cache()
        draft = draft_self_phase(torch, np, sv, tfm, lm4, dev, prompts[:DRAFT_REQUESTS], want)
    emit({"phase": "spec_draft_self", "layers": 4, **draft})
    out["spec_draft_self"] = draft
    # the sampling spec pump: replayed tokens equal the eager oracle's
    sprompts = sampling_traffic(np)
    sampled = {}
    for name, kw in (("slot", {}), ("paged", dict(PAGED, kv_blocks=KV_BLOCKS))):
        streams, keys = [], []
        for eager in (True, False):
            cb = sv.ContinuousBatcher(lm4, MISTRAL["n_heads"], **SERVE, **kw, attn_impl="pallas",
                                      device=dev)
            run = spec_pump_of(eager)
            rids, todo = [], list(enumerate(sprompts))
            while todo or any(cb.result(r) is None for r in rids):
                while todo and (rid := cb.submit(todo[0][1], 48,
                                                 **SAMPLING_KW[todo[0][0] % 4])) is not None:
                    rids.append(rid)
                    todo.pop(0)
                run(cb)
            streams.append([cb.result(r) for r in rids])
            st = cb.stats()
            keys = sorted(st["programs"])
            counters = spec_counters(st)
            del cb
        if streams[0] != streams[1]:
            diff = [i for i, (a, b) in enumerate(zip(*streams)) if a != b]
            raise AssertionError(f"spec_sampling {name}: requests {diff} differ between the "
                                 "replays and the eager oracle")
        if not any("spec-" in k and "sampling" in k for k in keys):
            raise AssertionError(f"spec_sampling {name}: no sampling spec program: {keys}")
        sampled[name] = {"requests": len(sprompts), "tokens": sum(len(t) for t in streams[1]),
                         "programs": keys, "equal": True, **counters}
    del lm4
    torch.cuda.empty_cache()
    emit({"phase": "spec_sampling", "layers": 4, **sampled})
    out["spec_sampling"] = sampled
    out["seconds"] = time.perf_counter() - t_group
    out["k3_launches"] = (cells["slot"]["plain"]["attention_launches"]
                          + sum(prefixes["slot"][m]["attention_launches"]
                                for m in ("prefix", "concatenated")))
    out["k4_launches"] = (cells["paged"]["plain"]["attention_launches"]
                          + sum(prefixes["paged"][m]["attention_launches"]
                                for m in ("prefix", "concatenated")))
    return out


# -- the serving engine's state: the sliding-window ring, snapshot/restore, spans ----------

# the serving_state group's depth (windowed_ring, windowed_spec,
# snapshot_restore_paged, migrate_spans): the ring, the snapshots and the
# spans are checked bit for bit at any depth; cut from 32 so that the whole
# script keeps its time limit
STATE_LAYERS = 8
RING_PROMPT, RING_NEW = 3584, 1024  # 7 prefill buckets; every slot wraps at its 512th token
RING_SNAP_AT = 480  # new tokens a request has when the ring phase snapshots
RING_PROFILE_AT = 576  # ... when the wrapped ring's profile runs (every slot past the wrap)
RING_EAGER_STEPS = 64  # the eager oracle's steps from the snapshot, across the wrap
RING_SPEC_ROUNDS = 32  # the spec phase's rounds from the snapshot, across the wrap
RING_PROFILE_PUMPS = 2
STATE_NEW = 64  # new tokens a request in the paged, span and checkpoint phases
SPAN_REQUESTS = 4
CKPT_OPTS = "vocab:32000,d_model:4096,n_heads:32,n_kv_heads:8,n_layers:4,seed:0"


def ring_traffic(np, rng):
    """The ring phase's 8 prompts of RING_PROMPT tokens, alternating a
    periodic one (a random 3-7-token pattern tiled, as spec_traffic builds
    them) and a random one."""
    vocab = MISTRAL["vocab"]
    out = []
    for i in range(SERVE["n_slots"]):
        if i % 2 == 0:
            pat = rng.integers(1, vocab, int(rng.integers(3, 8)))
            out.append(np.tile(pat, -(-RING_PROMPT // len(pat)))[:RING_PROMPT].astype(np.int32))
        else:
            out.append(rng.integers(1, vocab, RING_PROMPT).astype(np.int32))
    return out


def snapshot_bytes(snap):
    """The host bytes of a snapshot's arrays (device state and prefixes)."""
    def size(x):
        if isinstance(x, (tuple, list)):
            return sum(size(t) for t in x)
        if isinstance(x, dict):
            return sum(size(t) for t in x.values())
        return getattr(x, "nbytes", 0)

    return size(snap["device"]) + size(snap.get("prefixes", {}))


def timed(torch, fn):
    """(fn's result, its ms): the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def slot_positions(cb):
    """The fill of every occupied slot, from the host's record."""
    return [r.fill0 + len(r.tokens) - 1 for r in cb._slots if r is not None]


def pump_profile(torch, run, n_layers, counter, steps_per_pump, extra):
    """RING_PROFILE_PUMPS runs of ``run`` (one warm-up run in the profiler's
    first step, dropped) under torch.profiler: host kernel / graph launches
    a run, device ms a step by class, the busy share; the attention kernel's
    counted launches over the window (the counter runs on)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        c0 = counter.count
        time.sleep(0.01)
        t0 = time.perf_counter()
        for _ in range(RING_PROFILE_PUMPS):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(0.01)
    k, g, m = host_launches(prof)
    steps = RING_PROFILE_PUMPS * steps_per_pump
    cls = profile_classes(torch, prof, wall, extra, main=MATMUL_KEYS)
    return {"kernel_launches_per_pump": k / RING_PROFILE_PUMPS,
            "graph_launches_per_pump": g / RING_PROFILE_PUMPS,
            "memcpy_calls_per_pump": m / RING_PROFILE_PUMPS,
            "window_steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "attention_launches": counter.count - c0, **per_step(cls, steps),
            "top_kernels": cls["top_kernels"][:5]}


def sliding_oracle(torch, np, tfm, lm, prompt, toks, window):
    """Teacher-forced sliding-window logits of ``toks`` after ``prompt``:
    the no-cache forward of prompt ‖ toks[:-1] with each position attending
    itself and the window - 1 before it (a causal band of width
    ``window``), plain torch, float32 → [len(toks), V]."""
    import torch.nn.functional as F

    def band(q, k, v, causal=True):
        t = q.shape[1]
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
        i = torch.arange(t, device=q.device)
        keep = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        s = s.masked_fill_(~keep[None, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        del s
        return torch.einsum("bhqk,bkhd->bqhd", p, v.float())

    seq = torch.as_tensor(np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])[None],
                          device=lm.embed.device)
    x = tfm.embed_lookup(lm.embed, seq, torch.float32)
    x = tfm.apply_layers(lm, x, MISTRAL["n_heads"], torch.arange(seq.shape[1],
                                                                  device=seq.device), band)
    x = tfm.rmsnorm(x[:, len(prompt) - 1:], lm.ln_f)
    return F.linear(x, tfm.wt(lm.head.weight, x.dtype)).float()[0]


def parted_at_tie(torch, logits, got, want, start, rel=MARGIN_REL):
    """``got`` against ``want`` (token lists from ``start`` on), ``logits``
    the oracle teacher-forced on ``want``: equal, or the first token where
    they part has a top-2 margin below ``rel`` × max |logit| there. → True
    if they part at a near-tie (raises if elsewhere)."""
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        return False
    row = logits[start + i]
    top2 = row.topk(2).values
    if not float(top2[0] - top2[1]) < rel * float(row.abs().max()):
        raise AssertionError(f"streams part at token {start + i} ({got[i]} vs {want[i]}) where "
                             f"the oracle's top-2 margin is {float(top2[0] - top2[1])}")
    return True


def drive_to(cb, rids, pump, until, pump_ms=None, before=None, after=None):
    """Pumps until ``until()``; each pump's ms a step into ``before`` (every
    slot's writes inside the first W positions), ``after`` (every slot past
    the wrap) or neither."""
    W = cb.max_len
    while not until():
        pos = slot_positions(cb)
        t0 = time.perf_counter()
        n = pump(cb)
        ms = (time.perf_counter() - t0) * 1e3 / n
        if before is not None and pos and max(pos) + n <= W:
            before.append(ms)
        elif after is not None and pos and min(pos) >= W:
            after.append(ms)
    return [list(cb.result(r) or cb.partial(r)) for r in rids]


def ring_phase(torch, np, sv, tfm, da, lm, dev):
    """windowed_ring and windowed_spec (phase 18c): Mistral-7B's full width
    (STATE_LAYERS layers) on its published window, 8 requests that wrap the
    ring; → (the phase summary, K3's counted launches)."""
    n_layers = lm.n_layers
    k3 = da.decode_attention_launches
    prompts = ring_traffic(np, np.random.default_rng(16))

    def make(**kw):
        return sv.ContinuousBatcher(lm, MISTRAL["n_heads"], **SERVE, windowed=True,
                                    attn_impl="pallas", device=dev, **kw)

    def pump8(c):
        c.step_pump(8)
        return 8

    out = {}
    t_phase = time.perf_counter()
    cb = make()
    prefill_ms = []
    rids = []
    for p in prompts:
        rid, ms = timed(torch, lambda p=p: cb.submit(p, RING_NEW))
        rids.append(rid)
        prefill_ms.append(ms)
    k3.reset()
    st0 = cb.stats()
    before, after = [], []

    def n_tok():
        return min(len(cb.partial(r) or ()) for r in rids)

    drive_to(cb, rids, pump8, lambda: n_tok() >= RING_SNAP_AT // 2, before=before)
    prof_before = pump_profile(torch, lambda: cb.step_pump(8), n_layers, k3, 8,
                               [("decode_attention (K3)", "decode_attention")])
    drive_to(cb, rids, pump8, lambda: n_tok() >= RING_SNAP_AT, before=before)
    torch.cuda.synchronize()
    mem_before_wrap = torch.cuda.memory_allocated(dev)
    snap, snapshot_ms = timed(torch, cb.snapshot)
    snap_pos = slot_positions(cb)
    snap_tokens = {r: list(cb.partial(r)) for r in rids}
    drive_to(cb, rids, pump8, lambda: n_tok() >= RING_PROFILE_AT, after=after)
    prof_after = pump_profile(torch, lambda: cb.step_pump(8), n_layers, k3, 8,
                              [("decode_attention (K3)", "decode_attention")])
    R = drive_to(cb, rids, pump8, lambda: all(cb.result(r) is not None for r in rids),
                 after=after)
    torch.cuda.synchronize()
    mem_end = torch.cuda.memory_allocated(dev)
    st = cb.stats()
    steps = st["steps"] - st0["steps"]
    launches = k3.count
    progs = replayed_programs(st, "windowed_ring")
    del cb
    torch.cuda.empty_cache()
    if launches != n_layers * steps:
        raise AssertionError(f"windowed_ring: K3 counted {launches} launches for {n_layers} x "
                             f"{steps} steps")
    if any(len(t) != RING_NEW for t in R):
        raise AssertionError("windowed_ring: a request came back short")
    for name, prof in (("before", prof_before), ("after", prof_after)):
        if prof["graph_launches_per_pump"] != 1 or prof["kernel_launches_per_pump"]:
            raise AssertionError(f"windowed_ring {name} the wrap: a replayed pump launched "
                                 f"{prof['graph_launches_per_pump']} graphs and "
                                 f"{prof['kernel_launches_per_pump']} kernels, want 1 and 0")
    if mem_end != mem_before_wrap:
        raise AssertionError(f"windowed_ring: {mem_before_wrap} bytes allocated before the wrap, "
                             f"{mem_end} after the last step")
    for r, got in zip(rids, R):
        if got[:len(snap_tokens[r])] != snap_tokens[r]:
            raise AssertionError("windowed_ring: a stream changed before the snapshot point")

    # the eager oracle from the snapshot, across the wrap
    cb = make()
    _, restore_ms = timed(torch, lambda: cb.restore(snap))
    for _ in range(RING_EAGER_STEPS // 8):
        cb.step_pump_eager(8)
    eager = [list(cb.partial(r)) for r in rids]
    eager_pos = slot_positions(cb)
    if cb._programs:
        raise AssertionError(f"windowed_ring: the eager oracle filled {list(cb._programs)}")
    del cb
    torch.cuda.empty_cache()
    for r, got, want in zip(rids, eager, R):
        if got != want[:len(got)] or len(got) < len(snap_tokens[r]) + RING_EAGER_STEPS:
            raise AssertionError("windowed_ring: the eager steps across the wrap differ from R")
    # restored and replayed to the end: R bit for bit
    cb = make()
    cb.restore(snap)
    k3.reset()
    st0 = cb.stats()
    restored = drive_to(cb, rids, pump8, lambda: all(cb.result(r) is not None for r in rids))
    st = cb.stats()
    if k3.count != n_layers * (st["steps"] - st0["steps"]):
        raise AssertionError("windowed_ring restored: K3 launches != layers x steps")
    del cb
    torch.cuda.empty_cache()
    if restored != R:
        raise AssertionError("windowed_ring: the restored streams differ from R")

    # the sliding-window oracle at T = prompt + new tokens
    t_oracle = time.perf_counter()
    parted = 0
    oracle = []
    with torch.no_grad():
        for p, toks in zip(prompts, R):
            logits = sliding_oracle(torch, np, tfm, lm, p, toks, SERVE["max_len"])
            wrong, ties = margin_check(torch, logits, toks)
            if wrong:
                raise AssertionError(f"windowed_ring: {wrong} tokens differ from the "
                                     f"sliding-window oracle outside near-ties ({ties} near-ties)")
            parted += ties
            oracle.append(logits)
            torch.cuda.empty_cache()
    t_oracle = time.perf_counter() - t_oracle
    # K3 at the ring's positions against its plain version
    k3_cases = [
        attn_case(torch, np, da, "ring-pos3600", 8, 32, 8, 128, 4096, [3600] * 8),
        attn_case(torch, np, da, "wrapped-s4096", 8, 32, 8, 128, 4096,
                  [4096 + (i * 4095) // 7 for i in range(8)]),
    ]
    out["windowed_ring"] = {
        "requests": len(prompts), "prompt_tokens": RING_PROMPT, "new_tokens": RING_NEW,
        "window": SERVE["max_len"], "snapshot_at_tokens": RING_SNAP_AT,
        "ring_prefill_ms_per_request": prefill_ms,
        "ring_prefill_ms_per_request_p50": pct(sorted(prefill_ms), 0.5),
        "tpot_ms_before_wrap_p50": pct(sorted(before), 0.5),
        "tpot_ms_before_wrap_p99": pct(sorted(before), 0.99),
        "tpot_ms_after_wrap_p50": pct(sorted(after), 0.5),
        "tpot_ms_after_wrap_p99": pct(sorted(after), 0.99),
        "pumps_before_wrap": len(before), "pumps_after_wrap": len(after),
        "steps": steps, "k3_launches": launches, "layers_x_steps": n_layers * steps,
        "programs": progs,
        "allocated_bytes_before_wrap": mem_before_wrap, "allocated_bytes_end": mem_end,
        "snapshot_ms": snapshot_ms, "restore_ms": restore_ms,
        "snapshot_host_bytes": snapshot_bytes(snap), "snapshot_positions": snap_pos,
        "eager_steps": RING_EAGER_STEPS, "eager_positions_end": eager_pos,
        "eager_equal": True, "restored_equal": True,
        "oracle_near_ties": parted, "oracle_mismatches_outside_near_ties": 0,
        "profile_before_wrap": prof_before, "profile_after_wrap": prof_after,
        "k3_cases": k3_cases, "oracle_seconds": t_oracle,
        "seconds": time.perf_counter() - t_phase,
    }
    emit({"phase": "windowed_ring", **out["windowed_ring"]})

    # windowed_spec: the same state, spec pumps across the wrap
    t_phase = time.perf_counter()
    runs = {}
    for mode in ("replay", "eager"):
        cb = make()
        cb.restore(snap)
        st0 = cb.stats()
        run = spec_pump_of(mode == "eager")
        for _ in range(RING_SPEC_ROUNDS // SPEC_ROUNDS):
            run(cb)
        st = cb.stats()
        toks = [list(cb.partial(r)) for r in rids]
        runs[mode] = {"tokens": toks, "positions_end": slot_positions(cb),
                      **spec_counters(st, st0), **spec_programs(st)}
        if mode == "replay":
            runs[mode]["profile"] = pump_profile(
                torch, lambda: run(cb), n_layers, k3, SPEC_ROUNDS,
                [("decode_attention (K3)", "decode_attention")])
        del cb
        torch.cuda.empty_cache()
    if runs["replay"]["tokens"] != runs["eager"]["tokens"]:
        raise AssertionError("windowed_spec: replayed spec streams differ from eager")
    prof = runs["replay"]["profile"]
    if prof["graph_launches_per_pump"] != 1 or prof["kernel_launches_per_pump"]:
        raise AssertionError(f"windowed_spec: a replayed spec pump launched "
                             f"{prof['graph_launches_per_pump']} graphs and "
                             f"{prof['kernel_launches_per_pump']} kernels, want 1 and 0")
    spec_parted = 0
    accepted_periodic = 0
    for i, (r, got, want, logits) in enumerate(zip(rids, runs["replay"]["tokens"], R, oracle)):
        start = len(snap_tokens[r])
        spec_parted += parted_at_tie(torch, logits, got[start:], want[start:], start)
        if i % 2 == 0:
            accepted_periodic += len(got) - start - RING_SPEC_ROUNDS
    if accepted_periodic <= 0:
        raise AssertionError("windowed_spec: no proposal accepted on the periodic half")
    for r in runs.values():
        del r["tokens"]
    out["windowed_spec"] = {"rounds": RING_SPEC_ROUNDS, "k": SPEC_K, "ngram": SPEC_G,
                            "accepted_tokens_periodic_half": accepted_periodic,
                            "streams_parted_at_near_tie": spec_parted, "replay_equal_eager": True,
                            **runs, "seconds": time.perf_counter() - t_phase}
    emit({"phase": "windowed_spec", **out["windowed_spec"]})
    return out, launches


def ring_self_draft(torch, np, sv, tfm, dev):
    """windowed_spec's self-draft at 4 layers: the target as its own draft
    on the ring (its spec_pump runs spec_step rounds, each one replayed
    program), from a snapshot at RING_SNAP_AT tokens, replayed and eager."""
    lm4 = tfm.init_params(torch.Generator(device=dev).manual_seed(2),
                          **dict(MISTRAL, n_layers=4), device=dev)
    prompts = ring_traffic(np, np.random.default_rng(17))

    def make():
        return sv.ContinuousBatcher(lm4, MISTRAL["n_heads"], **SERVE, windowed=True,
                                    attn_impl="pallas", device=dev, draft_params=lm4,
                                    draft_n_heads=MISTRAL["n_heads"])

    cb = make()
    rids = [cb.submit(p, RING_SNAP_AT + 2 * RING_SPEC_ROUNDS * SPEC_K) for p in prompts]
    while min(len(cb.partial(r) or ()) for r in rids) < RING_SNAP_AT:
        cb.step_pump(8)
    snap = cb.snapshot()
    start = {r: len(cb.partial(r)) for r in rids}
    del cb
    runs = {}
    for mode in ("replay", "eager"):
        cb = make()
        cb.restore(snap)
        st0 = cb.stats()
        for _ in range(RING_SPEC_ROUNDS // SPEC_ROUNDS):
            (cb.spec_pump_eager if mode == "eager" else cb.spec_pump)(SPEC_ROUNDS, SPEC_K)
        st = cb.stats()
        runs[mode] = {"tokens": [list(cb.partial(r)) for r in rids],
                      "positions_end": slot_positions(cb), **spec_counters(st, st0),
                      **spec_programs(st)}
        del cb
        torch.cuda.empty_cache()
    if runs["replay"]["tokens"] != runs["eager"]["tokens"]:
        raise AssertionError("windowed_spec self-draft: replayed rounds differ from eager")
    rep = runs["replay"]
    rejected = rep["spec_columns"] - rep["spec_accepted_tokens"]
    ties = 0
    if rejected:
        with torch.no_grad():
            for p, r, toks in zip(prompts, rids, rep["tokens"]):
                logits = sliding_oracle(torch, np, tfm, lm4, p, toks, SERVE["max_len"])
                ties += margin_check(torch, logits[start[r]:], toks[start[r]:])[1]
    if rejected > ties:
        raise AssertionError(f"windowed_spec self-draft: {rejected} proposals rejected, "
                             f"{ties} near-ties")
    for r in runs.values():
        del r["tokens"]
    del lm4
    torch.cuda.empty_cache()
    return {"layers": 4, "rejected": rejected, "near_ties": ties, **runs}


def paged_state_phase(torch, np, sv, tfm, pa, lm, dev):
    """snapshot_restore_paged (phase 18c): the paged_serving configuration
    at full width, a snapshot with 8 live requests, restored into a fresh
    batcher and into one that has replayed its programs."""
    n_layers = lm.n_layers
    k4 = pa.paged_decode_attention_launches
    prompts = paged_traffic(np, np.random.default_rng(18))

    def make():
        return sv.ContinuousBatcher(lm, MISTRAL["n_heads"], **SERVE, **PAGED,
                                    kv_blocks=KV_BLOCKS, attn_impl="pallas", device=dev)

    def run_rest(cb, rids, queue):
        """Submit the queue as slots free; pump to the end → streams in
        order, steps, K4 launches."""
        k4.reset()
        st0 = cb.stats()
        rids = list(rids)
        queue = list(queue)
        while queue or any(cb.result(r) is None for r in rids):
            while queue and cb.n_free and (rid := cb.submit(queue[0], STATE_NEW)) is not None:
                rids.append(rid)
                queue.pop(0)
            cb.step_pump(1 if cb.stats()["kv_prefill_queue"] else 8)
        steps = cb.stats()["steps"] - st0["steps"]
        if k4.count != n_layers * steps:
            raise AssertionError(f"snapshot_restore_paged: K4 counted {k4.count} launches for "
                                 f"{n_layers} x {steps} steps")
        return [list(cb.result(r)) for r in rids], steps

    cb = make()
    rids = [cb.submit(p, STATE_NEW) for p in prompts[:SERVE["n_slots"]]]
    while cb.stats()["kv_prefill_queue"] or cb._pending:
        cb.step_pump(1)
    cb.step_pump(8)
    if not cb._active.all():
        raise AssertionError("snapshot_restore_paged: a request finished before the snapshot")
    snap, snapshot_ms = timed(torch, cb.snapshot)
    pool_snap = snap["pool"]
    want, steps_a = run_rest(cb, rids, prompts[SERVE["n_slots"]:])
    del cb
    torch.cuda.empty_cache()
    out = {"requests": len(prompts), "live_at_snapshot": len(rids), "new_tokens": STATE_NEW,
           "snapshot_ms": snapshot_ms, "snapshot_host_bytes": snapshot_bytes(snap),
           "uninterrupted_steps": steps_a}
    n_live = len(rids)
    for name in ("fresh", "after_replays"):
        cb = make()
        if name == "after_replays":
            warm = cb.submit(prompts[1][:64], 16)
            while cb.result(warm) is None:
                cb.step_pump(8 if not cb.stats()["kv_prefill_queue"] else 1)
            replayed_programs(cb.stats(), "snapshot_restore_paged")
            progs = sorted(cb._programs)
        _, ms = timed(torch, lambda: cb.restore(snap))
        if cb._pool.snapshot() != pool_snap:
            raise AssertionError(f"snapshot_restore_paged {name}: the restored pool's refcounts, "
                                 "cached tier or prefix index differ from the snapshot's")
        got, steps = run_rest(cb, rids, prompts[SERVE["n_slots"]:])
        if name == "after_replays" and sorted(cb._programs) != progs:
            raise AssertionError("snapshot_restore_paged: the restore filled new programs")
        del cb
        torch.cuda.empty_cache()
        if got[:n_live] != want[:n_live]:
            raise AssertionError(f"snapshot_restore_paged {name}: continued streams differ")
        parted = sum(stream_check(torch, np, tfm, lm, p, g, w, MARGIN_REL, torch.float32)
                     for p, g, w in zip(prompts[n_live:], got[n_live:], want[n_live:]))
        out[name] = {"restore_ms": ms, "steps": steps, "k4_launches": n_layers * steps,
                     "continued_equal": True,
                     "later_requests_equal": got[n_live:] == want[n_live:],
                     "later_parted_at_near_tie": parted}
    return out, steps_a + sum(out[n]["steps"] for n in ("fresh", "after_replays"))


def span_phase(torch, np, sv, tfm, pa, lm, dev, n_layers_note="full"):
    """migrate_spans (phase 18c): two paged batchers sharing one weight set;
    SPAN_REQUESTS requests behind a shared 256-token system prompt moved
    cold, warm (the destination holds the system prompt) and by
    resume_from_span; → the flows' numbers."""
    from nnstreamer_tpu_torch.kv import migrate

    k4 = pa.paged_decode_attention_launches
    rng = np.random.default_rng(19)
    vocab = MISTRAL["vocab"]
    system = rng.integers(1, vocab, SYSTEM_PROMPT).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(1, vocab, int(n)).astype(np.int32)])
               for n in rng.integers(100, 300, SPAN_REQUESTS)]
    cache_dtype = "int8" if n_layers_note == "int8" else "auto"

    def make():
        return sv.ContinuousBatcher(lm, MISTRAL["n_heads"], **SERVE, **PAGED,
                                    kv_blocks=KV_BLOCKS // 2, attn_impl="pallas", device=dev,
                                    cache_dtype=cache_dtype)

    def serve(cb, rids):
        while any(cb.result(r) is None for r in rids):
            cb.step_pump(1 if cb.stats()["kv_prefill_queue"] else 8)
        return [list(cb.result(r)) for r in rids]

    def mid(cb):
        rids = [cb.submit(p, STATE_NEW) for p in prompts]
        while cb.stats()["kv_prefill_queue"] or not all(
                cb._active[s] for s, r in enumerate(cb._slots) if r is not None):
            cb.step_pump(1)
        cb.step_pump(8)
        return rids

    src, dst = make(), make()
    # the unmigrated streams, from a second run: its prompts hit the prefix
    # index the first run filled, as every later run on src does (an int8
    # arena's matched blocks seed the prefill dequantized, so a run with
    # hits is the reference of runs with hits)
    serve(src, [src.submit(p, STATE_NEW) for p in prompts])
    ref = serve(src, [src.submit(p, STATE_NEW) for p in prompts])
    out = {"requests": SPAN_REQUESTS, "system_prompt": SYSTEM_PROMPT,
           "cache_dtype": cache_dtype}
    for flow in ("cold", "warm", "resume"):
        if flow == "warm":
            dst.register_prefix(system)
        rids = mid(src)
        out0, in0 = src.stats()["kv_migrations_out"], dst.stats()["kv_migrations_in"]
        per, new = [], []
        for rid in rids:
            span, t_ext = timed(torch, lambda rid=rid: src.extract_request(rid))
            row = {"extract_ms": t_ext, "kv_positions": span.n_kv}
            if flow == "warm":
                shared = dst.probe_prefix(span.kv_tokens)
                warm = span.strip_shared(shared)
                stripped = sum(len(b) for r, w in zip(span.blocks, warm.blocks)
                               if w.payload is None for b in r.payload)
                cold_bytes = len(migrate.encode_span(span))
                row.update(shared_tokens=shared, stripped_payload_bytes=stripped,
                           cold_wire_bytes=cold_bytes)
                if shared < SYSTEM_PROMPT or span.payload_bytes() - warm.payload_bytes() \
                        != stripped or stripped <= 0:
                    raise AssertionError(f"migrate_spans warm: {shared} tokens shared, "
                                         f"{stripped} bytes stripped")
                span = warm
            wire, t_enc = timed(torch, lambda span=span: migrate.encode_span(span))
            back, t_dec = timed(torch, lambda: migrate.decode_span(wire))
            if flow == "resume":
                nr, t_adopt = timed(torch, lambda: dst.resume_from_span(back))
            else:
                nr, t_adopt = timed(torch, lambda: dst.adopt_request(back))
            if flow == "warm":
                # the payloads stripped, and each stripped record's header
                # flag one byte shorter ("true" for "false")
                n_strip = sum(w.payload is None for w in span.blocks)
                row.update(wire_bytes_saved=row["cold_wire_bytes"] - len(wire),
                           blocks_stripped=n_strip)
                if row["wire_bytes_saved"] != row["stripped_payload_bytes"] + n_strip:
                    raise AssertionError("migrate_spans warm: the stripped span is not smaller "
                                         "by its stripped blocks")
            row.update(encode_ms=t_enc, decode_ms=t_dec, adopt_ms=t_adopt,
                       wire_mb=len(wire) / 1e6,
                       gbps=len(wire) / 1e9 / ((t_ext + t_enc + t_dec + t_adopt) / 1e3))
            per.append(row)
            new.append(nr)
        k4.reset()
        st0 = dst.stats()
        got = serve(dst, new)
        steps = dst.stats()["steps"] - st0["steps"]
        if k4.count != lm.n_layers * steps:
            raise AssertionError(f"migrate_spans {flow}: K4 {k4.count} != layers x steps")
        parted = 0
        if flow == "resume":
            # a re-prefill chunks the context at other bucket edges: its K/V
            # may differ in the last bits, so the margin rule
            parted = sum(stream_check(torch, np, tfm, lm, p, g, w, MARGIN_REL, torch.float32)
                         for p, g, w in zip(prompts, got, ref))
        elif got != ref:
            raise AssertionError(f"migrate_spans {flow}: continued streams differ from the "
                                 "unmigrated run")
        moved = (src.stats()["kv_migrations_out"] - out0, dst.stats()["kv_migrations_in"] - in0)
        if moved != (SPAN_REQUESTS, 0 if flow == "resume" else SPAN_REQUESTS):
            raise AssertionError(f"migrate_spans {flow}: migrations out/in {moved}")
        out[flow] = {"per_request": per, "migrations_out_in": list(moved),
                     "bitwise_equal": got == ref, "parted_at_near_tie": parted,
                     "decode_steps": steps, "k4_launches": k4.count}
    del src, dst
    torch.cuda.empty_cache()
    return out


def checkpoint_phase(torch, np, dev):
    """checkpoints (phase 18c): tensor_llm_serversink kv-layout=paged
    checkpoint-every-tokens=8 at 4 layers; the server dropped without a
    drain, a new one on the same directory adopts every span and finishes
    the streams as the uninterrupted run, reaping the files."""
    import gc

    from nnstreamer_tpu_torch.elements.llm_serve import LlmServerSink, _LlmServer
    from nnstreamer_tpu_torch.tensors.frame import Frame

    rng = np.random.default_rng(20)
    prompts = [rng.integers(1, MISTRAL["vocab"], int(n)).astype(np.int32)
               for n in rng.integers(100, 400, 4)]
    with tempfile.TemporaryDirectory() as tmp:
        ckdir = os.path.join(tmp, "spans")
        props = {"id": "ckpt", "custom": CKPT_OPTS, "kv-layout": "paged", "block-size": 16,
                 "kv-blocks": 512, "n-slots": 4, "max-len": 1024, "prompt-len": 256,
                 "max-new-tokens": STATE_NEW, "attn-impl": "pallas"}
        kw = dict(LlmServerSink(**props)._create_kw, device=dev)
        ck_kw = dict(LlmServerSink(**props, **{"checkpoint-every-tokens": 8,
                                                 "checkpoint-dir": ckdir})._create_kw, device=dev)

        def submit_all(srv):
            for i, p in enumerate(prompts):
                srv.submit(Frame((p,), meta={"req": f"c{i}"}))

        def finish(srv):
            out = {}
            while len(out) < len(prompts):
                srv.pump()
                while (item := srv.pop()) is not None:
                    out[item[1]["req"]] = [int(t) for t in item[0]]
            return out

        srv = _LlmServer(**kw)
        submit_all(srv)
        want = finish(srv)
        del srv
        gc.collect()
        torch.cuda.empty_cache()
        srv = _LlmServer(**ck_kw)
        submit_all(srv)
        while min(len(srv.cb.partial(r) or ()) for r in srv._pending) < STATE_NEW // 2:
            srv.pump()
        files = sorted(os.listdir(ckdir))
        del srv  # no drain, no extraction: only the files survive
        gc.collect()
        torch.cuda.empty_cache()
        srv, build_ms = timed(torch, lambda: _LlmServer(**ck_kw))
        adopted = len(srv._pending)
        queue = srv.cb.stats()["kv_prefill_queue"]
        migrations_in = srv.cb.stats()["kv_migrations_in"]
        got = finish(srv)
        left = [f for f in os.listdir(ckdir) if f.endswith(".span")]
        del srv
        gc.collect()
        torch.cuda.empty_cache()
    if len(files) != len(prompts) or adopted != len(prompts) or queue or migrations_in != 4:
        raise AssertionError(f"checkpoints: {len(files)} files, {adopted} adopted, prefill "
                             f"queue {queue}, migrations in {migrations_in}")
    if got != want:
        raise AssertionError("checkpoints: the restarted streams differ from the uninterrupted run")
    if left:
        raise AssertionError(f"checkpoints: files not reaped: {left}")
    return {"layers": 4, "requests": len(prompts), "every_tokens": 8, "files": len(files),
            "adopted": adopted, "kv_prefill_queue": queue, "restart_build_ms": build_ms,
            "equal": True, "files_left": 0}


def serving_state_phases(torch, np, dev):
    """The serving_state group (phase 18c): windowed_ring, windowed_spec,
    snapshot_restore_paged, migrate_spans at Mistral-7B's full width
    (STATE_LAYERS layers); the
    ring self-draft, the int8 spans and checkpoints at 4 layers. → the
    group's summary with K3's and K4's counted launches."""
    from nnstreamer_tpu_torch.models import serving as sv
    from nnstreamer_tpu_torch.models import transformer as tfm
    from nnstreamer_tpu_torch.ops.kernels import decode_attention as da
    from nnstreamer_tpu_torch.ops.kernels import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    t_group = time.perf_counter()
    out = {"phase": "serving_state", **MISTRAL, "n_layers": STATE_LAYERS, **SERVE,
           "compute_dtype": "float32"}
    lm = tfm.init_params(torch.Generator(device=dev).manual_seed(0),
                         **dict(MISTRAL, n_layers=STATE_LAYERS), device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        ring, k3_launches = ring_phase(torch, np, sv, tfm, da, lm, dev)
        out.update(ring)
        out["ring_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        paged, paged_steps = paged_state_phase(torch, np, sv, tfm, pa, lm, dev)
        paged["seconds"] = time.perf_counter() - t0
        emit({"phase": "snapshot_restore_paged", **paged})
        out["snapshot_restore_paged"] = paged
        t0 = time.perf_counter()
        spans = span_phase(torch, np, sv, tfm, pa, lm, dev)
        spans["seconds"] = time.perf_counter() - t0
        emit({"phase": "migrate_spans", **spans})
        out["migrate_spans"] = spans
    del lm
    torch.cuda.empty_cache()
    with torch.no_grad():
        t0 = time.perf_counter()
        draft = ring_self_draft(torch, np, sv, tfm, dev)
        draft["seconds"] = time.perf_counter() - t0
        emit({"phase": "windowed_spec_self_draft", **draft})
        out["windowed_spec"]["self_draft"] = draft
        t0 = time.perf_counter()
        lm4 = tfm.init_params(torch.Generator(device=dev).manual_seed(3),
                              **dict(MISTRAL, n_layers=4), device=dev)
        spans8 = span_phase(torch, np, sv, tfm, pa, lm4, dev, "int8")
        spans8["seconds"] = time.perf_counter() - t0
        emit({"phase": "migrate_spans_int8", "layers": 4, **spans8})
        out["migrate_spans_int8"] = spans8
        del lm4
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ck = checkpoint_phase(torch, np, dev)
    ck["seconds"] = time.perf_counter() - t0
    emit({"phase": "checkpoints", **ck})
    out["checkpoints"] = ck
    out["k3_launches"] = k3_launches
    out["k4_launches"] = (STATE_LAYERS * paged_steps
                          + sum(spans[f]["k4_launches"] for f in ("cold", "warm", "resume")))
    out["seconds"] = time.perf_counter() - t_group
    return out


# -- the long-context forward (flash prefill attention, K5) -----------------------------

PEAK_BF16_OPS_S = 989e12  # H100 SXM bf16 and fp16 dense, tensor cores
PEAK_TF32_OPS_S = 495e12  # H100 SXM TF32 dense, tensor cores
FLASH_T = 4096  # Mistral's sliding window: causal attention over T is its windowed attention
FLASH_PIPE_OPTS = ("vocab:32000,d_model:4096,n_heads:32,n_kv_heads:8,n_layers:4,seqlen:4096,"
                   "seed:3")
FLASH_PIPELINE = (
    "appsrc name=src dimensions=4096:1 types=int32 ! "
    'tensor_filter name=f framework=torch model=zoo:transformer_lm custom="{opts},attn:{attn}" ! '
    "tensor_sink name=out"
)
FLASH_PIPE_FRAMES = 2
INT8W_OPTS = "vocab:32000,d_model:4096,n_heads:32,n_kv_heads:8,n_layers:4,seed:4"
INT8W_PIPELINE = (
    "appsrc name=src dimensions=64:1 types=int32 ! "
    'tensor_filter name=f framework=torch model=zoo:transformer_lm custom="{opts}" ! '
    "tensor_sink name=out"
)
BEAM_NEW = 16
# a beam's score against the log-probs of a teacher-forced no-cache forward
# of its sequence, float32, 4 layers: two summation orders over 16 steps
BEAM_SCORE_TOL = 1e-3


def sdpa_backend(torch, fn, args) -> str:
    """The name of the longest device kernel of one call of ``fn``: which
    scaled_dot_product_attention backend ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    rows = sorted(((ev.self_device_time_total, ev.key) for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
                  reverse=True)
    return rows[0][1][:100] if rows else "not measured"


def flash_case(torch, np, fa, dev, name, b, t, h, d, causal=True, dtype="float32", block=128):
    """One K5 case on the GPU: the kernel against its plain version (tiles
    ``block``) on the same inputs, non-finite outputs, timings, the bound
    and scaled_dot_product_attention on the same data as the yardstick.
    The bound is the function's operations at the tensor-core rate of the
    dtype's route (float32: three TF32 products a pair, so a third of the
    TF32 rate; 16-bit: the bf16/fp16 rate), or its bytes, the larger;
    ``bound_simt_ms`` is float32 outside the tensor cores, the bound of the
    kernel K5 replaced."""
    import torch.nn.functional as F

    rng = np.random.default_rng(zlib.crc32(name.encode()))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}[dtype]
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32))
               .to(dev).to(tdt) for _ in range(3))

    def kernel(q, k, v):
        return fa.flash_attention(q, k, v, causal=causal)

    def plain(q, k, v):
        return fa.plain_flash_attention(q, k, v, causal, block_q=block, block_k=block)

    got = kernel(q, k, v)
    want = plain(q, k, v)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    nonfinite = int((~torch.isfinite(got)).sum())
    tol = 2e-5
    if got.shape != (b, t, h, d) or got.dtype != torch.float32 or nonfinite or not err <= tol:
        raise AssertionError(f"K5 {name}: kernel vs plain max_abs_err {err} > {tol} "
                             f"or {nonfinite} non-finite outputs")

    esize = q.element_size()
    in_bytes = 3 * b * t * h * d * esize
    n_bytes = in_bytes + b * t * h * d * 4
    pairs = t * (t + 1) // 2 if causal else t * t  # live (query, key) pairs a head
    n_ops = 4 * b * h * d * pairs  # q.k and p.v: a multiply-add each per element
    # float32: three TF32 products per product (3xTF32); 16-bit: one per product
    peak = PEAK_TF32_OPS_S / 3 if dtype == "float32" else PEAK_BF16_OPS_S
    copies = min(4, max(1, math.ceil(2 * L2_BYTES / in_bytes)))
    pool = [(q.clone(), k.clone(), v.clone()) for _ in range(copies)]
    reps = 10 if t >= 1024 else 50
    ms, records = device_ms(torch, kernel, pool, reps, per_launch=True)
    one_ms = alone_ms(torch, kernel, pool[0])
    plain_ms, _ = device_ms(torch, plain, pool, 2 if t >= 1024 else 5)

    # yardstick, one PyTorch call the port never makes: the same data in
    # the same dtype, [B, H, T, D] (transposed outside the timing)
    lib_pool = [tuple(x.transpose(1, 2).contiguous() for x in args) for args in pool]

    def library(qh, kh, vh):
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)

    lib_out = library(*lib_pool[0]).transpose(1, 2)
    torch.cuda.synchronize()
    library_err = (lib_out.float() - want).abs().max().item()
    library_ms, _ = device_ms(torch, library, lib_pool, reps)
    backend = sdpa_backend(torch, library, lib_pool[0])
    del pool, lib_pool
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = n_ops / peak * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return {
        "case": name, "b": b, "t": t, "h": h, "d": d, "causal": causal, "dtype": dtype,
        "plain_block": block, "max_abs_err": err, "tolerance": tol,
        "nonfinite_outputs": nonfinite,
        "kernel_ms": ms, "kernel_records": records,
        "kernel_timing": "torch.profiler" if records else "cuda events",
        "kernel_alone_ms": one_ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "library_max_abs_err": library_err,
        "library_kernel": backend,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bound_simt_ms": max(bytes_ms, n_ops / PEAK_F32_OPS_S * 1e3),
        "bytes": n_bytes, "operations": n_ops,
        "achieved_TFLOPs": n_ops / (ms * 1e-3) / 1e12,
    }


def flash_kernel_cases(torch, np, fa, dev):
    """The flash_kernels phase's cases: the JAX package's registry shapes
    (flash_attention.py:279-318, copied), the main path's shape in each
    dtype, other head dims (every multiple of 8 up to 256 runs on a kernel
    built for 64, 128 or 256 columns), a ragged tail and full attention;
    then a head dim the kernel refuses."""
    cases = [
        flash_case(torch, np, fa, dev, "t64-causal", 2, 64, 4, 16, block=16),
        flash_case(torch, np, fa, dev, "t64-full", 2, 64, 4, 16, causal=False, block=16),
        flash_case(torch, np, fa, dev, "t100-pad-causal", 2, 100, 2, 32, block=32),
        flash_case(torch, np, fa, dev, "t100-pad-full", 2, 100, 2, 32, causal=False, block=32),
        flash_case(torch, np, fa, dev, "bf16", 2, 64, 4, 16, dtype="bfloat16", block=16),
        flash_case(torch, np, fa, dev, "serve-512", 8, 512, 8, 128),
        # the main path's attention: B 1, T 4096, H 32, D 128
        flash_case(torch, np, fa, dev, "lm-t4096-f32", 1, FLASH_T, 32, 128),
        flash_case(torch, np, fa, dev, "lm-t4096-bf16", 1, FLASH_T, 32, 128, dtype="bfloat16"),
        flash_case(torch, np, fa, dev, "lm-t4096-f16", 1, FLASH_T, 32, 128, dtype="float16"),
        flash_case(torch, np, fa, dev, "t1500-ragged", 1, 1500, 32, 128),
        flash_case(torch, np, fa, dev, "t4096-full", 1, FLASH_T, 32, 128, causal=False),
        # head dims other than 128 (D 8 is the reference's own probe width)
        flash_case(torch, np, fa, dev, "d8-ragged", 2, 1000, 8, 8),
        flash_case(torch, np, fa, dev, "d48-bf16", 1, 2048, 16, 48, dtype="bfloat16"),
        flash_case(torch, np, fa, dev, "d64", 1, FLASH_T, 32, 64),
        flash_case(torch, np, fa, dev, "d96-f16-full", 1, 1024, 16, 96, causal=False,
                   dtype="float16"),
        flash_case(torch, np, fa, dev, "d256", 1, 2048, 8, 256),
        flash_case(torch, np, fa, dev, "d256-bf16", 1, 2048, 8, 256, dtype="bfloat16"),
    ]
    # a head dim the kernel does not take raises before any launch
    q = torch.zeros((1, 64, 2, 12), device=dev)
    fa.flash_attention_launches.reset()
    try:
        fa.flash_attention(q, q, q)
        raise AssertionError("K5: a CUDA call at D 12 did not raise")
    except ValueError:
        pass
    if fa.flash_attention_launches.count:
        raise AssertionError("K5: the refused D 12 call counted a launch")
    torch.cuda.empty_cache()
    return cases


def timed_forward(torch, fn, reps):
    """(logits of the first call, ms a call by CUDA events over ``reps``
    more, peak bytes allocated during the first call)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps, peak


def flash_phases(torch, np, dev, parse_pipeline):
    """flash_kernels, flash_forward, flash_pipeline and lm_int8w_beam.
    Returns (the K5 case at the main path's shape, K5 launches in the
    full-width float32 forward)."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.models import decode as dec
    from nnstreamer_tpu_torch.models import transformer as tfm
    from nnstreamer_tpu_torch.models import zoo
    from nnstreamer_tpu_torch.models.transformer import QuantizedWeight
    from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa
    from nnstreamer_tpu_torch.tensors.frame import Frame

    torch.backends.cuda.matmul.allow_tf32 = False

    # flash_kernels ----------------------------------------------------------------
    k5_cases = flash_kernel_cases(torch, np, fa, dev)
    emit({"phase": "flash_kernels", "cases": k5_cases})
    k5_main = next(c for c in k5_cases if c["case"] == "lm-t4096-f32")

    # flash_forward: the full-width long-context forward ----------------------------------
    t0 = time.perf_counter()
    lm = tfm.init_params(torch.Generator(device=dev).manual_seed(0), **MISTRAL, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_heads, n_layers = MISTRAL["n_heads"], MISTRAL["n_layers"]
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(1, MISTRAL["vocab"], (1, FLASH_T)).astype(np.int32)
    ).to(dev)
    flash = fa.make_flash_attention()
    fwd = {}
    failures = []
    k5_launches = ref32 = None
    for name, dtype, rel in (("float32", torch.float32, MARGIN_REL),
                             ("bfloat16", torch.bfloat16, MARGIN_REL_BF16)):
        with torch.no_grad():
            fa.flash_attention_launches.reset()
            dense, dense_ms, dense_peak = timed_forward(
                torch, lambda: tfm.apply(lm, tokens, n_heads, compute_dtype=dtype), 1)
            dense_launches = fa.flash_attention_launches.count
            fa.flash_attention_launches.reset()
            got = tfm.apply(lm, tokens, n_heads, attn_fn=flash, compute_dtype=dtype)
            torch.cuda.synchronize()
            launches = fa.flash_attention_launches.count
            if name == "float32":
                k5_launches = launches
            got, flash_ms, flash_peak = timed_forward(
                torch, lambda: tfm.apply(lm, tokens, n_heads, attn_fn=flash, compute_dtype=dtype),
                2)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                tp = time.perf_counter()
                tfm.apply(lm, tokens, n_heads, attn_fn=flash, compute_dtype=dtype)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - tp
        if launches != n_layers or dense_launches != 0:
            failures.append(f"{name}: K5 launched {launches} times a forward (want "
                            f"{n_layers}), dense {dense_launches}")
        nonfinite = int((~torch.isfinite(got)).sum())
        if got.shape != (1, FLASH_T, MISTRAL["vocab"]) or nonfinite:
            failures.append(f"{name}: logits {tuple(got.shape)}, {nonfinite} non-finite")
        bad, near = margin_check(torch, dense[0], got[0].argmax(dim=-1).tolist(), rel)
        row = {
            "k5_launches_per_forward": launches, "dense_k5_launches": dense_launches,
            "max_abs_logit_diff": (got - dense).abs().max().item(),
            "max_abs_logit": dense.abs().max().item(),
            "argmax_mismatches": bad, "near_tie_exempt": near, "margin_rel": rel,
            "argmax_differences_in_all": int((got[0].argmax(-1) != dense[0].argmax(-1)).sum()),
            "flash_ms_per_forward": flash_ms, "dense_ms_per_forward": dense_ms,
            "flash_prefill_tok_s": FLASH_T / (flash_ms * 1e-3),
            "dense_prefill_tok_s": FLASH_T / (dense_ms * 1e-3),
            "flash_peak_gb": flash_peak / 1e9, "dense_peak_gb": dense_peak / 1e9,
            "profile": profile_classes(torch, prof, prof_wall,
                                       [("flash_attention (K5)", "flash_attention")],
                                       main=MATMUL_KEYS),
        }
        dev_ms = row["profile"]["device_ms"]
        row["k5_share_of_device_ms"] = (
            row["profile"]["device_ms_by_class"]["flash_attention (K5)"] / dev_ms
            if isinstance(dev_ms, float) and dev_ms > 0 else "not measured")
        if name == "float32":
            if bad:
                failures.append(f"float32: {bad} argmax positions differ from the dense "
                                "forward's (near-ties exempt)")
            ref32 = dense
        else:
            # bfloat16 rounds the 32-layer stack at every cast, so one change in
            # float32 summation order (flash against dense attention) moves the
            # logits as far as bfloat16 itself does. The gate: the flash forward
            # drifts from the float32 forward at most twice as far as the dense
            # bfloat16 forward does; argmax agreement is reported
            flash_drift = (got - ref32).abs().max().item()
            dense_drift = (dense - ref32).abs().max().item()
            f_bad, _ = margin_check(torch, ref32[0], got[0].argmax(dim=-1).tolist(), rel)
            d_bad, f32_near = margin_check(torch, ref32[0], dense[0].argmax(dim=-1).tolist(), rel)
            row.update({
                "flash_vs_f32_max_abs_logit_diff": flash_drift,
                "dense_vs_f32_max_abs_logit_diff": dense_drift,
                "flash_vs_f32_argmax_mismatches": f_bad, "dense_vs_f32_argmax_mismatches": d_bad,
                "f32_near_tie_exempt": f32_near,
            })
            if not flash_drift <= 2 * dense_drift:
                failures.append(f"bfloat16: flash drifts {flash_drift} from the float32 "
                                f"forward, over twice dense's {dense_drift}")
        fwd[name] = row
        del dense, got
        torch.cuda.empty_cache()
    del ref32
    emit({"phase": "flash_forward", "config": "lm-forward-mistral7b-flash", **MISTRAL,
          "batch": 1, "t": FLASH_T, "init_s": init_s,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "weights_gb": sum(p.numel() * p.element_size() for p in lm.parameters()) / 1e9,
          **fwd})
    if failures:
        raise AssertionError(f"flash_forward: {failures}")
    del lm
    torch.cuda.empty_cache()

    # flash_pipeline: zoo:transformer_lm attn=flash through parse_pipeline ---------------
    rng = np.random.default_rng(6)
    frames = [rng.integers(1, MISTRAL["vocab"], (1, FLASH_T)).astype(np.int32)
              for _ in range(FLASH_PIPE_FRAMES)]
    outs = {}
    # float32 on every frame; then one frame in float16, the zoo's compute_dtype
    for attn, opts, n in (("flash", FLASH_PIPE_OPTS, FLASH_PIPE_FRAMES),
                          ("dense", FLASH_PIPE_OPTS, FLASH_PIPE_FRAMES),
                          ("flash16", FLASH_PIPE_OPTS + ",compute_dtype:float16", 1),
                          ("dense16", FLASH_PIPE_OPTS + ",compute_dtype:float16", 1)):
        pl = parse_pipeline(FLASH_PIPELINE.format(opts=opts, attn=attn.removesuffix("16")),
                            device=dev)
        pl.negotiate()  # the filter's spec probe runs the model once: not a frame
        fa.flash_attention_launches.reset()
        ex = pl.start()
        for f in frames[:n]:
            pl["src"].push(Frame((f,)))
        pl["src"].end_of_stream()
        done = ex.wait(600)
        ex.stop()
        if ex.errors or not done:
            raise AssertionError(f"flash_pipeline {attn}: {ex.errors or 'no EOS within 600 s'}")
        outs[attn] = ([torch.from_numpy(np.asarray(f.tensors[0])) for f in pl["out"].frames],
                      fa.flash_attention_launches.count)
        del pl, ex
        torch.cuda.empty_cache()
    (flash_out, pipe_k5), (dense_out, dense_k5) = outs["flash"], outs["dense"]
    (flash16_out, pipe16_k5), (dense16_out, dense16_k5) = outs["flash16"], outs["dense16"]
    if len(flash_out) != FLASH_PIPE_FRAMES or len(dense_out) != FLASH_PIPE_FRAMES:
        raise AssertionError(f"flash_pipeline: {len(flash_out)} / {len(dense_out)} frames")
    if pipe_k5 != 4 * FLASH_PIPE_FRAMES or dense_k5 != 0:
        raise AssertionError(f"flash_pipeline: K5 launched {pipe_k5} times for 4 layers x "
                             f"{FLASH_PIPE_FRAMES} frames (dense: {dense_k5})")
    pipe_bad = pipe_near = 0
    pipe_diff = 0.0
    for g, w in zip(flash_out, dense_out):
        g, w = g.reshape(FLASH_T, -1), w.reshape(FLASH_T, -1)
        if not torch.isfinite(g).all():
            raise AssertionError("flash_pipeline: non-finite logits")
        bad, near = margin_check(torch, w, g.argmax(-1).tolist())
        pipe_bad += bad
        pipe_near += near
        pipe_diff = max(pipe_diff, (g - w).abs().max().item())
    if pipe_bad:
        raise AssertionError(f"flash_pipeline: {pipe_bad} argmax positions differ from dense")
    # float16: as in flash_forward's bfloat16 gate, the flash forward may drift
    # from the float32 logits at most twice as far as the dense float16 one
    if len(flash16_out) != 1 or len(dense16_out) != 1 or pipe16_k5 != 4 or dense16_k5 != 0:
        raise AssertionError(f"flash_pipeline float16: {len(flash16_out)} / {len(dense16_out)} "
                             f"frames, K5 launched {pipe16_k5} times (dense: {dense16_k5})")
    g16, d16 = (x[0].reshape(FLASH_T, -1).float() for x in (flash16_out, dense16_out))
    if not (torch.isfinite(g16).all() and torch.isfinite(d16).all()):
        raise AssertionError("flash_pipeline float16: non-finite logits")
    ref = dense_out[0].reshape(FLASH_T, -1)
    flash16_drift = (g16 - ref).abs().max().item()
    dense16_drift = (d16 - ref).abs().max().item()
    if not flash16_drift <= 2 * dense16_drift:
        raise AssertionError(f"flash_pipeline float16: flash drifts {flash16_drift} from the "
                             f"float32 logits, over twice dense's {dense16_drift}")
    f16_bad, f16_near = margin_check(torch, ref, g16.argmax(-1).tolist())
    emit({"phase": "flash_pipeline", "frames": FLASH_PIPE_FRAMES, "layers": 4,
          "ffn": "4 * d_model = 16384 (the zoo has no d_ff option)",
          "k5_launches": pipe_k5, "dense_k5_launches": dense_k5,
          "max_abs_logit_diff": pipe_diff, "argmax_mismatches": pipe_bad,
          "near_tie_exempt": pipe_near, "logits_shape": list(flash_out[0].shape),
          "float16": {"frames": 1, "k5_launches": pipe16_k5, "dense_k5_launches": dense16_k5,
                      "flash_vs_f32_max_abs_logit_diff": flash16_drift,
                      "dense_vs_f32_max_abs_logit_diff": dense16_drift,
                      "flash_vs_f32_argmax_mismatches": f16_bad,
                      "f32_near_tie_exempt": f16_near}})
    del flash_out, dense_out, flash16_out, dense16_out, outs

    # lm_int8w_beam: weight-only int8 and beam search, 4 layers ------------------------------
    opts = dict(kv.split(":") for kv in INT8W_OPTS.split(","))
    m = zoo.get("transformer_lm", device=dev, **opts, quantize="int8w", attn="flash",
                seqlen=str(FLASH_T))
    lm8 = m.params
    qweights = [mod for mod in lm8.modules() if isinstance(mod, QuantizedWeight)]
    int8_bytes = (sum(b.numel() * b.element_size() for b in lm8.buffers())
                  + sum(p.numel() * p.element_size() for p in lm8.parameters()))
    f32_bytes = (sum(q.w8.numel() * 4 for q in qweights)
                 + sum(p.numel() * p.element_size() for p in lm8.parameters()))
    with torch.no_grad():
        fa.flash_attention_launches.reset()
        q_flash = m.module(tokens)
        torch.cuda.synchronize()
        int8_k5 = fa.flash_attention_launches.count
        q_dense = tfm.apply(lm8, tokens, n_heads)
    if int8_k5 != 4:
        raise AssertionError(f"lm_int8w_beam: K5 launched {int8_k5} times for 4 layers")
    bad8, near8 = margin_check(torch, q_dense[0], q_flash[0].argmax(-1).tolist())
    int8_diff = (q_flash - q_dense).abs().max().item()
    if bad8 or not torch.isfinite(q_flash).all():
        raise AssertionError(f"lm_int8w_beam: int8w flash vs dense: {bad8} argmax mismatches")
    del q_flash, q_dense, m
    prompt = np.random.default_rng(7).integers(1, MISTRAL["vocab"], (1, 64)).astype(np.int32)
    tprompt = torch.from_numpy(prompt).to(dev)
    # generate through the filter (a pipeline) against the batcher-free
    # decode.generate on the same quantized module
    gen_opts = f"{INT8W_OPTS},quantize:int8w,generate:{BEAM_NEW}"
    pl = parse_pipeline(INT8W_PIPELINE.format(opts=gen_opts), device=dev)
    ex = pl.start()
    pl["src"].push(Frame((prompt,)))
    pl["src"].end_of_stream()
    done = ex.wait(600)
    ex.stop()
    if ex.errors or not done or len(pl["out"].frames) != 1:
        raise AssertionError(f"lm_int8w_beam: generate pipeline {ex.errors or 'no frame'}")
    pipe_toks = np.asarray(pl["out"].frames[0].tensors[0]).reshape(-1).tolist()
    del pl, ex
    g = zoo.get("transformer_lm", device=dev, **opts, quantize="int8w",
                generate=str(BEAM_NEW))
    with torch.no_grad():
        filt = g.module(tprompt)[0].tolist()
        alone = dec.generate(g.params, tprompt, n_heads, BEAM_NEW)[0].tolist()
        beam1 = dec.beam_search(g.params, tprompt, n_heads, BEAM_NEW, beam_width=1)[0][0].tolist()
        bz = zoo.get("transformer_lm", device=dev, **opts, quantize="int8w",
                     generate=str(BEAM_NEW), decode="beam", beam_width="4")
        beam4_zoo = bz.module(tprompt)[0].tolist()
        del bz
        beam4, score4 = dec.beam_search(g.params, tprompt, n_heads, BEAM_NEW, beam_width=4)
        beam4 = beam4[0].tolist()
        seq = torch.as_tensor(np.concatenate([prompt[0], beam4])[None], device=dev)
        lp = torch.log_softmax(tfm.apply(g.params, seq, n_heads)[0, 63:63 + BEAM_NEW], -1)
        forced = float(lp[torch.arange(BEAM_NEW, device=dev), torch.tensor(beam4, device=dev)]
                       .sum())
    if not (pipe_toks == filt == alone):
        raise AssertionError(f"lm_int8w_beam: generate differs: pipeline {pipe_toks}, "
                             f"filter {filt}, decode.generate {alone}")
    if beam1 != alone:
        raise AssertionError(f"lm_int8w_beam: beam_width=1 {beam1} != greedy {alone}")
    if beam4_zoo != beam4 or not abs(score4 - forced) <= BEAM_SCORE_TOL:
        raise AssertionError(f"lm_int8w_beam: beam 4 zoo {beam4_zoo} vs {beam4}; score "
                             f"{score4} vs teacher-forced {forced}")
    del g
    torch.cuda.empty_cache()
    emit({"phase": "lm_int8w_beam", "layers": 4, "ffn": "4 * d_model = 16384 (the zoo's)",
          "int8w_weight_gb": int8_bytes / 1e9, "f32_weight_gb": f32_bytes / 1e9,
          "int8w_k5_launches": int8_k5, "int8w_flash_vs_dense_max_abs_logit_diff": int8_diff,
          "int8w_flash_vs_dense_argmax_mismatches": bad8, "near_tie_exempt": near8,
          "generate_pipeline_equals_decode_generate": True, "beam1_equals_greedy": True,
          "beam4_tokens_first8": beam4[:8], "beam4_score": score4,
          "beam4_teacher_forced_logprob": forced, "beam_score_tolerance": BEAM_SCORE_TOL,
          "greedy_tokens_first8": alone[:8], "beam4_differs_from_greedy": beam4 != alone})
    return k5_main, k5_launches


# -- the vision families and cascades (queue A.3) ------------------------------

LIVE = " is-live=true framerate=30/1"
# routing-crop-720p with its two models: the detector's regions feed the crop
FACE_CASCADE = (
    "videotestsrc device=true pattern=gradient width=1280 height=720 num-frames={n}{live} "
    "stamp-wall=true ! tensor_converter ! tee name=t "
    "t. ! queue ! tensor_transform mode=resize option=128:128 ! "
    "tensor_filter framework=torch model=zoo:face_detect "
    'custom="output:regions,frame_size:1280:720,threshold:0.0" ! crop.sink_1 '
    "t. ! queue ! crop.sink_0 "
    "tensor_crop name=crop out-size=112:112 max-crops=16 ! "
    'tensor_filter framework=torch model=zoo:face_landmark custom="batch:16" ! '
    "tensor_sink name=out"
)
FACE_REGIONS = (
    "videotestsrc device=true pattern=gradient width=1280 height=720 num-frames=1 ! "
    "tensor_converter ! tensor_transform mode=resize option=128:128 ! "
    "tensor_filter framework=torch model=zoo:face_detect "
    'custom="output:regions,frame_size:1280:720,threshold:0.0" ! tensor_sink name=out'
)
COMPOSITE = (
    "videotestsrc device=true pattern=gradient width=128 height=128 num-frames={n} ! "
    "tensor_converter ! tensor_filter framework=torch model=zoo:face_composite "
    'custom="threshold:0.0,compute_dtype:{dtype}" ! tensor_sink name=out'
)
_HD_RESIZE = (
    "videotestsrc pattern=gradient width=1280 height=720 num-frames={n}{live} stamp-wall=true ! "
    "tensor_converter ! tensor_transform mode=resize option={size}:{size} ! "
)
YOLO_PIPELINE = _HD_RESIZE.replace("{size}", "320") + (
    "tensor_filter name=f framework=torch model=zoo:yolov5 ! "
    "tensor_decoder mode=bounding_boxes option1=yolov5 option5=320:320 postproc=device ! "
    "tensor_sink name=out"
)
POSE_PIPELINE = _HD_RESIZE.replace("{size}", "257") + (
    "tensor_filter framework=torch model=zoo:posenet output-combination=o0,o1 ! "
    "tensor_decoder mode=pose_estimation option1=640:480 option2=257:257 "
    "option4=heatmap-offset postproc=device ! tensor_sink name=out"
)
SEG_PIPELINE = _HD_RESIZE.replace("{size}", "257") + (
    "tensor_filter framework=torch model=zoo:deeplab_v3 ! "
    "tensor_decoder mode=image_segment option1=tflite-deeplab postproc=device ! "
    "tensor_sink name=out"
)
INT8_PIPELINE = _HD_RESIZE.replace("{size}", "224") + (
    'tensor_filter framework=torch model=zoo:mobilenet_v2 custom="quantize:{q}" ! '
    "tensor_decoder mode=image_labeling ! tensor_sink name=out"
)
FACE_LMK_TOL = 1e-3  # a region a pixel over (int truncation) moves a landmark ~1e-4
COMPOSITE_F32_TOL = 1e-4  # float32, cuDNN against the CPU's convs and K1 against plain
POSE_TOL_PX = 1e-3  # keypoints in 640x480 pixels: float32 offsets
SEG_FLIP_SHARE = 1e-3  # label pixels allowed to differ: argmax near-ties at class borders
INT8_REL = 0.10  # of max |logit|: one-quantum flips grow through the int8 layers
INT8W_REL = 1e-3  # of max |logit|: float32 products in another order


def run_desc(parse_pipeline, desc, device, hook=None, counters=()):
    """Build, negotiate (the models built and warmed outside the timing:
    a filter runs its model once there), set ``counters`` to 0, run;
    (pipeline, wall seconds). ``hook`` is a forward hook for the filter
    named ``f``."""
    p = parse_pipeline(desc, device=device)
    p.negotiate()
    for c in counters:
        c.reset()
    if hook is not None:
        p["f"].backend.module.register_forward_hook(hook)
    t0 = time.perf_counter()
    p.run(timeout=600)
    return p, time.perf_counter() - t0


def out_tensors(p, i=0):
    return [f.tensors[i] for f in p["out"].frames]


def latencies(p):
    """Source-to-sink latency (ms) of every frame, in frame order."""
    return [(f.meta["render_t"] - f.meta["wall_t0"]) * 1e3 for f in p["out"].frames]


def profiled(torch, parse_pipeline, desc, dev, extra, main=CONV_KEYS):
    """A 16-frame run under torch.profiler: (device time by class, D2H
    copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p = parse_pipeline(desc, device=dev)
    p.negotiate()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p.run(timeout=600)
        wall = time.perf_counter() - t0
    d2h = sum(ev.count for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA and "dtoh" in ev.key.lower())
    return profile_classes(torch, prof, wall, extra, main), d2h


def sorted_cols(np, a):
    """Rows sorted column by column: a comparison that a swap of two
    near-tied top-k rows does not move."""
    return np.sort(np.asarray(a, np.float64), axis=0)


def max_err(np, a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def face_cascade_phase(torch, np, dev, parse_pipeline, ik):
    """routing-crop-720p with its models: 720p → tee → resize 128 →
    face_detect regions → tensor_crop's regions pad; the frame → its image
    pad; 16 crops of 112² → face_landmark batch 16 → sink."""
    def desc(n, live=False):
        return FACE_CASCADE.format(n=n, live=LIVE if live else "")

    run_desc(parse_pipeline, desc(4), dev)  # warm-up
    cpu, _ = run_desc(parse_pipeline, desc(4), "cpu")
    p, wall = run_desc(parse_pipeline, desc(FRAMES), dev,
                       counters=(ik.crop_entry_launches, ik.resize_entry_launches))
    crop_k1, resize_k1 = ik.crop_entry_launches.count, ik.resize_entry_launches.count
    if (crop_k1, resize_k1) != (FRAMES, FRAMES):
        raise AssertionError(f"face_cascade: K1 crop entry {crop_k1}, resize entry "
                             f"{resize_k1} launches for {FRAMES} frames")
    got = out_tensors(p)
    if len(got) != FRAMES or any(g.shape != (16, 136) or not np.isfinite(g).all() for g in got):
        raise AssertionError("face_cascade: want 32 finite [16, 136] landmark frames")
    err = max(max_err(np, g, c) for g, c in zip(got, out_tensors(cpu)))
    if not err <= FACE_LMK_TOL:
        raise AssertionError(f"face_cascade: GPU vs CPU landmarks {err} > {FACE_LMK_TOL}")
    lat_free = sorted(latencies(p))
    paced, _ = run_desc(parse_pipeline, desc(FRAMES, live=True), dev)
    lat_live = latencies(paced)
    frame0, lat_live = lat_live[0], sorted(lat_live)
    n_prof = 16
    classes, d2h = profiled(torch, parse_pipeline, desc(n_prof), dev,
                            [("crop_resize (K1)", "crop_resize")])
    if d2h > n_prof:  # the sink's own copy, one a frame
        raise AssertionError(f"face_cascade: {d2h} D2H copies over {n_prof} frames, "
                             f"more than the sink's {n_prof}")
    return {
        "phase": "face_cascade", "config": "face-cascade-720p", "frames": FRAMES,
        "k1_crop_launches": crop_k1, "k1_resize_launches": resize_k1,
        "gpu_vs_cpu_max_abs_err": err, "tolerance": FACE_LMK_TOL, "compared_frames": 4,
        "fps": FRAMES / wall, "wall_s": wall,
        "free_latency_ms_p50": pct(lat_free, 0.5), "free_latency_ms_p99": pct(lat_free, 0.99),
        "paced30_latency_ms_p50": pct(lat_live, 0.5),
        "paced30_latency_ms_p99": pct(lat_live, 0.99), "paced30_latency_ms_frame0": frame0,
        "d2h_records": d2h, "d2h_per_frame": d2h / n_prof, "d2h_at_sinks_per_frame": 1,
        "profile_frames": n_prof, **classes,
    }


def composite_phase(torch, np, dev, parse_pipeline, ik):
    """zoo:face_composite through a filter at 128², float32 then bfloat16:
    K1's crop entry once a frame on the normalized float image."""
    out, cpu32 = {}, None
    for dtype in ("float32", "bfloat16"):
        run_desc(parse_pipeline, COMPOSITE.format(n=2, dtype=dtype), dev)  # warm-up
        cpu, _ = run_desc(parse_pipeline, COMPOSITE.format(n=2, dtype=dtype), "cpu")
        p, wall = run_desc(parse_pipeline, COMPOSITE.format(n=FRAMES, dtype=dtype), dev,
                           counters=(ik.crop_entry_launches, ik.crop_resize_launches))
        launches = (ik.crop_entry_launches.count, ik.crop_resize_launches.count)
        if launches != (FRAMES, FRAMES):
            raise AssertionError(f"composite {dtype}: K1 launches {launches} for {FRAMES} frames")
        errs, gates = [], []
        for i in (0, 1):  # landmarks, detections
            got, want = out_tensors(p, i)[:2], out_tensors(cpu, i)
            if any(not np.isfinite(g).all() for g in got):
                raise AssertionError(f"composite {dtype}: non-finite output {i}")
            if dtype == "float32":
                errs.append(max(max_err(np, g, w) for g, w in zip(got, want)))
                gates.append(COMPOSITE_F32_TOL)
            else:  # the gate: the CPU's own bfloat16 drift from its float32
                # run, or one bfloat16 ulp at the output's scale if larger
                errs.append(max(max_err(np, sorted_cols(np, g), sorted_cols(np, w))
                                for g, w in zip(got, want)))
                drift = max(max_err(np, sorted_cols(np, w), sorted_cols(np, f))
                            for w, f in zip(want, out_tensors(cpu32, i)))
                ulp = 2.0 ** -7 * max(float(np.abs(w).max()) for w in want)
                gates.append(max(drift, ulp))
        if not all(e <= g for e, g in zip(errs, gates)):
            raise AssertionError(f"composite {dtype}: GPU vs CPU {errs} > {gates}")
        if dtype == "float32":
            cpu32 = cpu
            det = out_tensors(p, 1)[0]
        out[dtype] = {"k1_crop_launches": launches[0], "fps": FRAMES / wall, "wall_s": wall,
                      "gpu_vs_cpu_max_abs_err": errs, "tolerance": gates}
    boxes = (det[:, 3:7] * np.float32(128)).astype(np.float32)
    return {"phase": "composite_fused", "frames": FRAMES, "size": 128, **out}, boxes


def yolo_phase(torch, np, dev, parse_pipeline, ik, nk, det):
    """720p → resize 320 → zoo:yolov5 (80 classes, width 32) → bounding_boxes
    yolov5 postproc=device: K1 and K2 once a frame, K2 at n = 6300."""
    def desc(n, live=False):
        return YOLO_PIPELINE.format(n=n, live=LIVE if live else "")

    run_desc(parse_pipeline, desc(4), dev)
    cpu, _ = run_desc(parse_pipeline, desc(2), "cpu")
    seen_n, preds = [], []
    cuda_nms = nk._cuda_nms

    def counting_nms(boxes, scores, iou, words=None):
        seen_n.append(int(boxes.shape[0]))
        return cuda_nms(boxes, scores, iou, words)

    nk._cuda_nms = counting_nms
    try:
        p, wall = run_desc(parse_pipeline, desc(FRAMES), dev,
                           hook=lambda m, i, o: preds.append(o),
                           counters=(ik.crop_resize_launches, nk.nms_launches))
    finally:
        nk._cuda_nms = cuda_nms
    k1, k2 = ik.crop_resize_launches.count, nk.nms_launches.count
    if (k1, k2) != (FRAMES, FRAMES) or set(seen_n) != {6300}:
        raise AssertionError(f"yolo: K1 {k1}, K2 {k2} launches for {FRAMES} frames, "
                             f"K2 n {sorted(set(seen_n))}")
    got = out_tensors(p)
    err = 0.0
    for g, c in zip(got[:2], out_tensors(cpu)):
        if g.shape != (100, 6) or not np.isfinite(g).all():
            raise AssertionError(f"yolo: bad detections {g.shape}")
        if not np.array_equal(g[:, 4], c[:, 4]):
            raise AssertionError("yolo: classes or their order differ from the CPU run")
        err = max(err, max_err(np, g, c))
    if not err <= 1e-5:
        raise AssertionError(f"yolo: GPU vs CPU max abs err {err} > 1e-5")
    paced, _ = run_desc(parse_pipeline, desc(FRAMES, live=True), dev)
    lat = latencies(paced)
    frame0, lat = lat[0], sorted(lat)
    classes, _ = profiled(torch, parse_pipeline, desc(16), dev,
                          [("nms (K2)", "nms_kernel"), ("crop_resize (K1)", "crop_resize")])
    # the last frame's 6300 candidates, as the decoder ranks them
    pred = preds[-1][0].to(torch.float32)
    cls = pred[:, 5:] * pred[:, 4:5]
    best = torch.amax(cls, dim=-1)
    cx, cy, w, h = pred[:, 0], pred[:, 1], pred[:, 2], pred[:, 3]
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1).contiguous()
    scores = torch.where(best >= det.YOLOV5_CONF_THRESHOLD, best, torch.zeros_like(best))
    return {
        "phase": "yolo_detection", "config": "yolov5-720p", "frames": FRAMES,
        "k1_launches": k1, "k2_launches": k2, "k2_n": 6300,
        "detections_first_frame": int((got[0][:, 5] > 0).sum()),
        "gpu_vs_cpu_max_abs_err": err, "fps": FRAMES / wall, "wall_s": wall,
        "paced30_latency_ms_p50": pct(lat, 0.5), "paced30_latency_ms_p99": pct(lat, 0.99),
        "paced30_latency_ms_frame0": frame0, "profile_frames": 16, **classes,
    }, (boxes, scores.contiguous())


def pose_segment_phase(torch, np, dev, parse_pipeline, ik):
    """posenet → pose_estimation heatmap-offset and deeplab_v3 →
    image_segment tflite-deeplab, both at 257 with postproc=device."""
    out = {}
    for name, template in (("pose", POSE_PIPELINE), ("segment", SEG_PIPELINE)):
        def desc(n):
            return template.format(n=n, live="")

        run_desc(parse_pipeline, desc(2), dev)
        cpu, _ = run_desc(parse_pipeline, desc(2), "cpu")
        p, wall = run_desc(parse_pipeline, desc(FRAMES), dev,
                           counters=(ik.crop_resize_launches,))
        k1 = ik.crop_resize_launches.count
        if k1 != FRAMES:
            raise AssertionError(f"{name}: K1 launched {k1} times for {FRAMES} frames")
        got, want = out_tensors(p)[:2], out_tensors(cpu)
        if name == "pose":
            if any(g.shape != (17, 3) or not np.isfinite(g).all() for g in got):
                raise AssertionError("pose: want finite [17, 3] keypoints")
            err = max(max_err(np, g, w) for g, w in zip(got, want))
            if not err <= POSE_TOL_PX:
                raise AssertionError(f"pose: GPU vs CPU keypoints {err} > {POSE_TOL_PX} px")
            out[name] = {"gpu_vs_cpu_max_abs_err_px": err, "tolerance_px": POSE_TOL_PX}
        else:
            if any(g.shape != (257, 257) or g.dtype != np.uint8 for g in got):
                raise AssertionError("segment: want [257, 257] uint8 label maps")
            share = max(float((g != w).mean()) for g, w in zip(got, want))
            if not share <= SEG_FLIP_SHARE:
                raise AssertionError(f"segment: {share} of labels differ from the CPU run")
            out[name] = {"labels_differing_share": share, "tolerance": SEG_FLIP_SHARE,
                         "classes_first_frame": int(len(np.unique(got[0])))}
        out[name].update({"k1_launches": k1, "fps": FRAMES / wall, "wall_s": wall})
    return {"phase": "pose_segment", "frames": FRAMES, "size": 257, **out}


def int8_phase(torch, np, dev, parse_pipeline, ik):
    """zoo:mobilenet_v2 (224, 1001 classes) with quantize:int8 and int8w:
    logits against the CPU, top-1 against the float model, fps; and the
    int8 golden's size 96 (9-row int8 GEMMs, padded) against the CPU."""
    from nnstreamer_tpu_torch.single import SingleShot

    rng = np.random.default_rng(11)
    xs = [rng.integers(0, 256, (1, 224, 224, 3)).astype(np.uint8) for _ in range(16)]

    def logits(custom, device, images):
        with SingleShot(framework="torch", model="zoo:mobilenet_v2", custom=custom,
                        device=device) as s:
            return [s.invoke(x)[0].cpu().numpy() for x in images]

    float_top1 = [int(a.argmax()) for a in logits("", dev, xs)]
    out = {}
    for q, rel in (("int8", INT8_REL), ("int8w", INT8W_REL)):
        gpu = logits(f"quantize:{q}", dev, xs)
        cpu = logits(f"quantize:{q}", "cpu", xs[:2])
        scale = max(float(np.abs(c).max()) for c in cpu)
        err = max(max_err(np, g, c) for g, c in zip(gpu, cpu))
        if not err <= rel * scale or any(g.argmax() != c.argmax() for g, c in zip(gpu, cpu)):
            raise AssertionError(f"{q}: GPU vs CPU logits {err} > {rel * scale} or top-1 differs")
        run_desc(parse_pipeline, INT8_PIPELINE.format(n=4, live="", q=q), dev)
        _, wall = run_desc(parse_pipeline, INT8_PIPELINE.format(n=FRAMES, live="", q=q), dev,
                           counters=(ik.crop_resize_launches,))
        if ik.crop_resize_launches.count != FRAMES:
            raise AssertionError(f"{q}: K1 not once a frame")
        agree = sum(int(g.argmax()) == f for g, f in zip(gpu, float_top1)) / len(xs)
        out[q] = {"gpu_vs_cpu_max_abs_err": err, "tolerance": rel * scale,
                  "top1_agreement_with_float": agree, "fps": FRAMES / wall, "wall_s": wall}
    small = [x[:, :96, :96] .copy() for x in xs[:2]]
    custom = "quantize:int8,size:96,num_classes:16"
    gpu, cpu = logits(custom, dev, small), logits(custom, "cpu", small)
    err = max(max_err(np, g, c) for g, c in zip(gpu, cpu))
    scale = max(float(np.abs(c).max()) for c in cpu)
    if not err <= INT8_REL * scale:
        raise AssertionError(f"int8 size 96: GPU vs CPU {err} > {INT8_REL * scale}")
    out["int8_size96"] = {"gpu_vs_cpu_max_abs_err": err, "tolerance": INT8_REL * scale}
    return {"phase": "mobilenet_int8", "size": 224, "classes": 1001, "images": len(xs), **out}


def vision_k1_cases(torch, np, parse_pipeline, ik, dev, composite_boxes):
    """K1 at the vision paths' crops: the composite's float crops (its own
    detector's boxes on 128², float32 and bfloat16) and the 720p uint8
    crop at the face detector's regions."""
    frame = parse_pipeline(FACE_REGIONS, device=dev)
    frame.run(timeout=600)
    xywh = frame["out"].frames[0].tensors[0].astype(np.float32)
    xyxy = np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]], 1)
    return [
        kernel_case(torch, np, ik, "crop-f32-128-16box-112-composite", torch.float32,
                    (128, 128, 3), (112, 112), boxes=composite_boxes),
        kernel_case(torch, np, ik, "crop-bf16-128-16box-112-composite", torch.bfloat16,
                    (128, 128, 3), (112, 112), boxes=composite_boxes),
        kernel_case(torch, np, ik, "crop-u8-720p-16box-112-face", torch.uint8,
                    (720, 1280, 3), (112, 112), boxes=xyxy),
    ]


def vision_phases(torch, np, dev, parse_pipeline, ik, nk, det):
    """The vision phase group; returns what the kernel summary needs."""
    cascade = face_cascade_phase(torch, np, dev, parse_pipeline, ik)
    emit(cascade)
    composite, composite_boxes = composite_phase(torch, np, dev, parse_pipeline, ik)
    emit(composite)
    yolo, (yboxes, yscores) = yolo_phase(torch, np, dev, parse_pipeline, ik, nk, det)
    emit(yolo)
    pose_seg = pose_segment_phase(torch, np, dev, parse_pipeline, ik)
    emit(pose_seg)
    emit(int8_phase(torch, np, dev, parse_pipeline, ik))
    k1 = vision_k1_cases(torch, np, parse_pipeline, ik, dev, composite_boxes)
    k2 = nms_case(torch, det, nk, "yolo-frame-6300", yboxes, yscores)
    emit({"phase": "vision_kernels", "k1_cases": k1, "k2_cases": [k2]})
    return {
        "k1_launches": {
            "face_cascade": {"crop_entry": cascade["k1_crop_launches"],
                             "resize_entry": cascade["k1_resize_launches"]},
            "composite_fused": {d: composite[d]["k1_crop_launches"]
                                for d in ("float32", "bfloat16")},
            "yolo": yolo["k1_launches"],
            "pose": pose_seg["pose"]["k1_launches"],
            "segment": pose_seg["segment"]["k1_launches"],
        },
        "k1_cases": k1, "k2_launches": yolo["k2_launches"], "k2_case": k2,
    }


# -- the wire codecs, script subplugins and flexible input (queue A.1, A.2) ------

# -- the segments group (ROADMAP A.1 + A.6 batching): captured programs -------

LAUNCH_APIS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
# a replayed segment feeding a deep queue into a slow sink: outputs still in
# flight when later replays run
ALIAS_PIPELINE = (
    "videotestsrc pattern=gradient width=1280 height=720 num-frames={n} ! tensor_converter ! "
    "tensor_transform mode=resize option=224:224 ! queue max-size-buffers=8 ! "
    "tensor_sink name=out"
)
ALIAS_SINK_MS = 20  # the slow sink's delay a frame, before it reads the frame
BATCH_PROPS = " batching=true max-batch=8"
# frames of the segments group's fps runs: 2 s or more at the cells' rates (up to
# ~700 fps), so a run's wall is not within a build's or a tick's reach
FPS_FRAMES = 1536
# the kernels a segment's replay must run on the device, as torch.profiler
# names them: (counter name, key substring, device kernels a launch)
REPLAY_KERNELS = (("k1", "crop_resize_kernel", 1), ("k2", "nms_kernel", 2))


def host_launches(prof):
    """(kernel launches, graph launches, memcpy calls) the host made in a
    torch.profiler run."""
    from torch.autograd import DeviceType

    k = g = m = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CPU:
            continue
        if ev.key in LAUNCH_APIS:
            k += ev.count
        elif ev.key == "cudaGraphLaunch":
            g += ev.count
        elif ev.key.startswith("cudaMemcpy"):
            m += ev.count
    return k, g, m


class SegmentLog:
    """Records every fused segment's (input frame, output frame) while
    installed: the replays a check holds against ``process_eager``."""

    def __init__(self, FusedSegment):
        self.cls, self.real, self.pairs = FusedSegment, FusedSegment.process, {}

    def __enter__(self):
        real, pairs = self.real, self.pairs

        def process(seg, frame):
            out = real(seg, frame)
            if seg.fused:
                pairs.setdefault(seg, []).append((frame, out))
            return out

        self.cls.process = process
        return self

    def __exit__(self, *exc):
        self.cls.process = self.real


def replay_vs_eager(torch, pairs):
    """Every recorded replay output against ``process_eager`` on the same
    input, bit for bit; (frames compared, tensors compared)."""
    frames = tensors = 0
    for seg, rows in pairs.items():
        for fin, fout in rows:
            want = seg.process_eager(fin)
            if len(want.tensors) != len(fout.tensors):
                raise AssertionError(f"segments: {seg.name} gave {len(fout.tensors)} tensors, "
                                     f"eager {len(want.tensors)}")
            for a, b in zip(fout.tensors, want.tensors):
                if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                    raise AssertionError(f"segments: {seg.name} replay differs from "
                                         f"process_eager at frame {frames}")
                tensors += 1
            frames += 1
    return frames, tensors


def segment_rows(plan):
    """Which fused segments replay, which stay eager, and why."""
    rows = []
    for seg in plan.segments:
        if not seg.fused:
            continue
        rows.append({"segment": seg.name, "captured": seg.captured, "n_traces": seg.n_traces,
                     "warmup_launches": seg.warmup_launches, "build_s": seg.build_s,
                     "eager_because": [f"{name}: CAPTURABLE = False"
                                       for name in seg.uncapturable]})
    return rows


def launches_eager_vs_replay(torch, pairs, n, counters):
    """Host launch calls a frame of the cells' segments over ``n`` frames:
    process_eager against process (replays), same inputs. In both modes
    each kernel's device records (``REPLAY_KERNELS``) must equal the
    launches its counter took: a replay adds the counts its capture
    recorded, so this shows those counts are the kernels the replays ran.
    A profile can drop a kernel at either edge of its window (a kernel
    whose device time, on the host's clock, falls just outside it), so one
    frame a segment runs in a warm-up step whose records are dropped, and
    the counted frames start and end 10 ms inside the recorded window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def run(mode, rows_of):
        for seg, rows in pairs.items():
            for fin, _ in rows_of(rows):
                (seg.process_eager if mode == "eager" else seg.process)(fin)
        torch.cuda.synchronize()

    out = {}
    for mode in ("eager", "replay"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            run(mode, lambda rows: rows[-1:])
            prof.step()
            for c in counters.values():
                c.reset()
            time.sleep(0.01)
            run(mode, lambda rows: rows[:n])
            time.sleep(0.01)
        k, g, m = host_launches(prof)
        counted = {name: c.count for name, c in counters.items()}
        records = {}
        for name, sub, per in REPLAY_KERNELS:
            if name not in counters:
                continue
            records[name] = sum(ev.count for ev in prof.key_averages()
                                if ev.device_type == DeviceType.CUDA and sub in ev.key)
            if records[name] != counted[name] * per or counted[name] < n:
                raise AssertionError(f"segments {mode}: {name} counted {counted[name]} "
                                     f"launches, {records[name]} device records "
                                     f"({per} a launch), {n} frames")
        out[mode] = {"kernel_launches_per_frame": k / n, "graph_launches_per_frame": g / n,
                     "memcpy_calls_per_frame": m / n, "counted": counted,
                     "device_records": records}
    return out


def segment_cell(torch, np, dev, parse_pipeline, FusedSegment, name, desc, counters, extra,
                 kernels):
    """One cell with its segments captured: 32 frames recorded (every
    replay against process_eager), the kernels' counts; launches a frame
    eager against replay, with the kernels' device records against their
    counts; fps over FPS_FRAMES; paced p50/p99 with frame 0 apart; a
    16-frame profile (busy share, device ms by class)."""
    run_desc(parse_pipeline, desc(4), dev)  # warm-up: cuDNN, allocator, models
    with SegmentLog(FusedSegment) as log:
        p, _ = run_desc(parse_pipeline, desc(FRAMES), dev, counters=counters.values())
    counts = {k: c.count for k, c in counters.items()}
    if any(v != FRAMES for v in counts.values()):
        raise AssertionError(f"segments {name}: launches {counts} for {FRAMES} frames")
    plan = p._executor.plan
    rows = segment_rows(plan)
    if not any(r["captured"] for r in rows):
        raise AssertionError(f"segments {name}: no segment replays a graph: {rows}")
    sink = len(p["out"].frames)
    if sink != FRAMES:
        raise AssertionError(f"segments {name}: {sink} frames at the sink")
    n_frames, n_tensors = replay_vs_eager(torch, log.pairs)
    launches = launches_eager_vs_replay(torch, log.pairs, 16, kernels)
    fp, wall = run_desc(parse_pipeline, desc(FPS_FRAMES), dev)
    build_s = sum(r["build_s"] for r in segment_rows(fp._executor.plan))
    if len(fp["out"].frames) != FPS_FRAMES:
        raise AssertionError(f"segments {name}: {len(fp['out'].frames)} of {FPS_FRAMES} frames")
    paced, _ = run_desc(parse_pipeline, desc(FRAMES, live=True), dev)
    lat = latencies(paced)
    rest = sorted(lat[1:])
    classes, _ = profiled(torch, parse_pipeline, desc(16), dev, extra)
    return {
        "cell": name, "frames": FRAMES, "launches": counts, "segments": rows,
        "replays_vs_eager_bit_equal": {"frames": n_frames, "tensors": n_tensors},
        "launches_per_frame_16": launches,
        "fps_frames": FPS_FRAMES, "fps": FPS_FRAMES / wall, "wall_s": wall,
        "build_s": build_s, "fps_after_build": FPS_FRAMES / (wall - build_s),
        "paced30_latency_ms_frame0": lat[0],
        "paced30_latency_ms_p50_after0": pct(rest, 0.5),
        "paced30_latency_ms_p99_after0": pct(rest, 0.99),
        "paced30_latency_ms_p99": pct(sorted(lat), 0.99),
        "profile_frames": 16, **classes,
    }


def aliasing_check(torch, np, dev, parse_pipeline, FusedSegment):
    """A replayed segment → queue (depth 8) → a sink that waits 20 ms before
    it reads each frame: every frame at the sink equals its eager output,
    so no replay overwrote a frame still in flight."""
    p = parse_pipeline(ALIAS_PIPELINE.format(n=16), device=dev)
    p.negotiate()
    render = p["out"].render
    p["out"].render = lambda f: (time.sleep(ALIAS_SINK_MS / 1e3), render(f))
    with SegmentLog(FusedSegment) as log:
        p.run(timeout=600)
    ((seg, pairs),) = log.pairs.items()
    got = [f.tensors[0] for f in p["out"].frames]
    if not seg.captured or len(got) != 16 or len(pairs) != 16:
        raise AssertionError(f"aliasing: captured {seg.captured}, {len(got)} frames")
    distinct = len({zlib.crc32(np.ascontiguousarray(g).tobytes()) for g in got})
    for g, (fin, _) in zip(got, pairs):
        want = seg.process_eager(fin).tensors[0].cpu().numpy()
        if not np.array_equal(g, want):
            raise AssertionError("aliasing: a frame at the sink differs from its eager output")
    return {"frames": 16, "queue_depth": 8, "sink_delay_ms": ALIAS_SINK_MS,
            "distinct_frames": distinct, "equal_to_eager": True}


def batched_labeling(torch, np, dev, parse_pipeline, ik):
    """labeling-720p with batching=true max-batch=8 against batching=false:
    the logits (the description without its decoder) bit for bit, every
    frame; avg-batch-size, pad-waste-pct, replays a window, K1 a row, fps."""
    logits_desc = PIPELINE.replace("tensor_decoder mode=image_labeling ! ", "")

    def desc(n, props="", base=PIPELINE):
        return base.format(n=n, live="").replace(
            "model=zoo:mobilenet_v2", "model=zoo:mobilenet_v2" + props)

    plain, _ = run_desc(parse_pipeline, desc(FRAMES, base=logits_desc), dev)
    batched, _ = run_desc(parse_pipeline, desc(FRAMES, BATCH_PROPS, logits_desc), dev)
    a, b = out_tensors(plain), out_tensors(batched)
    if len(a) != FRAMES or len(b) != FRAMES or not all(np.array_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("batched labeling: logits differ from batching=false")
    run_desc(parse_pipeline, desc(4, BATCH_PROPS), dev)  # warm-up
    # FPS_FRAMES a run, unbatched / batched / batched / unbatched in turn:
    # the two runs of a mode bracket the other's, so their spread is the
    # call's own noise
    import nnstreamer_tpu_torch.pipeline.programs as programs_mod

    replays, runs, labels0 = [], [], None
    real = programs_mod.replay
    programs_mod.replay = lambda graph, launches: (replays.append(graph),
                                                   real(graph, launches))[1]
    try:
        for mode in ("unbatched", "batched", "batched", "unbatched"):
            replays.clear()
            p, wall = run_desc(parse_pipeline,
                               desc(FPS_FRAMES, BATCH_PROPS if mode == "batched" else ""),
                               dev, counters=(ik.crop_resize_launches,))
            k1 = ik.crop_resize_launches.count
            (seg,) = [s for s in p._executor.plan.segments if s.fused]
            stats = p["f"].batch_stats
            labels = [int(t[0]) for t in out_tensors(p)]
            labels0 = labels if labels0 is None else labels0
            if len(labels) != FPS_FRAMES or labels != labels0:
                raise AssertionError(f"batched labeling: {mode} labels differ or frames lost")
            windows = stats.batches if mode == "batched" else FPS_FRAMES
            rows = stats.bucket_rows if mode == "batched" else FPS_FRAMES
            if len(replays) != windows or k1 != rows:
                raise AssertionError(f"batched labeling {mode}: {len(replays)} replays for "
                                     f"{windows} windows, K1 {k1} for {rows} rows")
            row = {"mode": mode, "fps": FPS_FRAMES / wall, "wall_s": wall,
                   "programs": seg.n_traces, "build_s": seg.build_s,
                   "fps_after_builds": FPS_FRAMES / (wall - seg.build_s),
                   "replays": len(replays), "k1_launches": k1}
            if mode == "batched":
                row.update({k: p["f"].get_property(k)
                            for k in ("avg-batch-size", "pad-waste-pct", "batch-wait-ms")},
                           windows=stats.batches, rows_run=stats.bucket_rows)
            runs.append(row)
    finally:
        programs_mod.replay = real
    return {"frames_bit_equal": FRAMES, "logits_bit_equal": True, "labels_equal": True,
            "fps_frames": FPS_FRAMES, "replays_per_window": 1.0, "runs": runs}


def segments_phases(torch, np, dev, parse_pipeline, ik, nk):
    """The segments group: labeling-720p, detection-720p and
    face-cascade-720p with every fused segment replaying a CUDA graph; the
    in-flight aliasing check; batched labeling."""
    from nnstreamer_tpu_torch.models import ssd_mobilenet
    from nnstreamer_tpu_torch.pipeline.graph import FusedSegment

    t0 = time.perf_counter()
    out = {"phase": "segments"}
    with tempfile.TemporaryDirectory() as tmp:
        priors = os.path.join(tmp, "box-priors.txt")
        ssd_mobilenet.write_box_priors(priors)
        cells = [
            ("labeling-720p",
             lambda n, live=False: PIPELINE.format(n=n, live=LIVE if live else ""),
             {"k1": ik.crop_resize_launches}, [("crop_resize (K1)", "crop_resize")],
             {"k1": ik.crop_resize_launches}),
            ("detection-720p",
             lambda n, live=False: DET_PIPELINE.format(n=n, live=LIVE if live else "",
                                                       priors=priors, pp="device"),
             {"k1": ik.crop_resize_launches, "k2": nk.nms_launches},
             [("nms (K2)", "nms_kernel"), ("crop_resize (K1)", "crop_resize")],
             {"k1": ik.crop_resize_launches, "k2": nk.nms_launches}),
            ("face-cascade-720p",
             lambda n, live=False: FACE_CASCADE.format(n=n, live=LIVE if live else ""),
             {"k1_crop": ik.crop_entry_launches, "k1_resize": ik.resize_entry_launches},
             [("crop_resize (K1)", "crop_resize")], {"k1": ik.crop_resize_launches}),
        ]
        out["cells"] = [segment_cell(torch, np, dev, parse_pipeline, FusedSegment, *c)
                        for c in cells]
    out["aliasing"] = aliasing_check(torch, np, dev, parse_pipeline, FusedSegment)
    out["batched_labeling"] = batched_labeling(torch, np, dev, parse_pipeline, ik)
    out["seconds"] = time.perf_counter() - t0
    return out


CODECS = ("flexbuf", "protobuf", "flatbuf")
HD_SOURCE = "videotestsrc pattern=gradient width=1280 height=720 num-frames={n}"
CODEC_ROUNDTRIP = (
    HD_SOURCE + " ! tensor_converter ! tensor_decoder name=enc mode={m} ! "
    "tensor_converter name=dec mode={m} ! tensor_sink name=out"
)
# the labeling cell with the edge layer's wire format between resize and model
CODEC_LABELING = _HD_RESIZE.replace("{size}", "224") + (
    "tensor_decoder name=enc mode={m} ! tensor_converter name=dec mode={m} ! "
    "tensor_filter name=f framework=torch model=zoo:mobilenet_v2 ! "
    "tensor_decoder mode=image_labeling ! tensor_sink name=out"
)
SCRIPT_720P = (
    HD_SOURCE + " ! tensor_converter ! tensor_filter framework=custom "
    "model={fix}/negate_filter.py ! tensor_sink name=out"
)
# the goldens of queue A.1 ({out}: the dump, {fix}: tests/fixtures)
CODEC_GOLDENS = {
    "filter_scaler": (
        "videotestsrc pattern=counter num-frames=2 width=4 height=4 ! tensor_converter ! "
        "tensor_transform mode=typecast option=float32 ! "
        'tensor_filter framework=scaler custom="factor:0.5" ! filesink location={out}'
    ),
    "decoder_direct_video": (
        "videotestsrc pattern=counter num-frames=2 width=8 height=8 ! tensor_converter ! "
        "tensor_decoder mode=direct_video ! filesink location={out}"
    ),
    **{f"decoder_{m}": (
        "videotestsrc pattern=counter num-frames=2 width=4 height=4 ! tensor_converter ! "
        f"tensor_decoder mode={m} ! filesink location={{out}}"
    ) for m in CODECS},
    "decoder_octet": (
        "videotestsrc pattern=counter num-frames=2 width=4 height=4 ! tensor_converter ! "
        "tensor_decoder mode=octet_stream ! filesink location={out}"
    ),
    "converter_flexbuf_roundtrip": (
        "videotestsrc pattern=counter num-frames=2 width=4 height=4 ! tensor_converter ! "
        "tensor_decoder mode=flexbuf ! tensor_converter mode=flexbuf ! filesink location={out}"
    ),
    "decoder_python3": (
        "videotestsrc pattern=counter num-frames=2 width=4 height=4 ! tensor_converter ! "
        "tensor_decoder mode=python3 option1={fix}/double_decoder.py ! filesink location={out}"
    ),
    "filter_python3": (
        "videotestsrc pattern=counter num-frames=2 width=4 height=4 ! tensor_converter ! "
        "tensor_filter framework=custom model={fix}/negate_filter.py ! filesink location={out}"
    ),
}
# the composite_face golden: host-mode crop into invoke-dynamic, both filters
# pinned ({lmk}: the landmark filter's card)
COMPOSITE_FACE = (
    "videotestsrc pattern=gradient num-frames=2 width=128 height=128 ! "
    "tensor_converter ! tee name=t "
    "t. ! queue ! tensor_filter framework=jax model=zoo:face_detect "
    'custom="output:regions,threshold:0.0,frame_size:128:128,device:0" '
    "! crop.sink_1 "
    "t. ! queue ! crop.sink_0 "
    "tensor_crop name=crop ! "
    'tensor_filter framework=jax model=zoo:face_landmark custom="device:{lmk}" '
    "invoke-dynamic=true input-combination=0 ! {sink}"
)
BAD_MESH = (
    "videotestsrc num-frames=1 width=64 height=64 ! tensor_converter ! "
    "tensor_filter framework=jax model=zoo:mobilenet_v2 "
    'custom="size:64,mesh:dp999" ! fakesink'
)


def repo_paths():
    here = os.path.dirname(os.path.abspath(__file__))
    return here, os.path.join(here, "tests", "fixtures"), os.path.join(here, "tests", "golden")


def golden_bytes(name):
    with open(os.path.join(repo_paths()[2], f"{name}.raw"), "rb") as f:
        return f.read()


def copies(prof):
    """(device-to-host, host-to-device) memcpy records of a profile."""
    from torch.autograd import DeviceType

    keys = [(ev.key.lower(), ev.count) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA]
    return (sum(n for k, n in keys if "dtoh" in k), sum(n for k, n in keys if "htod" in k))


def timed_calls(obj, name, sink):
    """Wrap ``obj.name`` so each call's host ms lands in ``sink``."""
    real = getattr(obj, name)

    def wrapped(*args):
        t0 = time.perf_counter()
        out = real(*args)
        sink.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(obj, name, wrapped)


def codec_goldens(parse_pipeline, dev):
    """The nine A.1 goldens through parse_pipeline on the card, byte for byte."""
    _, fix, _ = repo_paths()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, desc in CODEC_GOLDENS.items():
            path = os.path.join(tmp, f"{name}.raw")
            parse_pipeline(desc.format(out=path, fix=fix), device=dev).run(timeout=120)
            with open(path, "rb") as f:
                out[name] = f.read() == golden_bytes(name)
    if not all(out.values()):
        bad = [n for n, ok in out.items() if not ok]
        raise AssertionError(f"codec goldens differ on CUDA: {bad}")
    return out


def composite_face_phase(np, dev, parse_pipeline):
    """composite_face with both filters on device:0, against the port's CPU
    run; then the golden's own device:1 must raise before the landmark
    model loads or anything runs."""
    from nnstreamer_tpu_torch.models import zoo

    desc = COMPOSITE_FACE.format(lmk=0, sink="tensor_sink name=out")
    gpu, wall = run_desc(parse_pipeline, desc, dev)
    cpu, _ = run_desc(parse_pipeline, desc, "cpu")
    got, want = out_tensors(gpu), out_tensors(cpu)
    if len(got) != 2 or any(g.shape != (1, 136) or not np.isfinite(g).all() for g in got):
        raise AssertionError(f"composite_face: want 2 finite [1, 136] frames, got {len(got)}")
    err = max(max_err(np, g, w) for g, w in zip(got, want))
    if not err <= FACE_LMK_TOL:
        raise AssertionError(f"composite_face: GPU vs CPU landmarks {err} > {FACE_LMK_TOL}")
    golden = np.frombuffer(golden_bytes("composite_face"), np.float32)
    loads, real_get = [], zoo.get
    zoo.get = lambda name, *a, **k: (loads.append(name), real_get(name, *a, **k))[1]
    try:
        raised = None
        parse_pipeline(COMPOSITE_FACE.format(lmk=1, sink="fakesink"), device=dev).negotiate()
    except Exception as exc:  # noqa: BLE001 — the refusal is the check
        raised = f"{type(exc).__name__}: {exc}"
    finally:
        zoo.get = real_get
    if raised is None or "device:1 out of range (have 1)" not in raised:
        raise AssertionError(f"composite_face device:1: want an out-of-range refusal, got {raised}")
    if "face_landmark" in loads:
        raise AssertionError("composite_face device:1: the landmark model loaded "
                             "before the refusal")
    return {
        "landmarks_gpu_vs_cpu_max_abs_err": err, "tolerance": FACE_LMK_TOL,
        "frames": len(got), "wall_s": wall,
        # the golden was made with the reference's jax.random seed-0 trees, which
        # only JAX draws: the card runs the port's seeded weights, so this error
        # measures the weights' difference (tests/test_torch_custom.py holds the
        # port to the golden within 1e-5 on the reference's trees, on the CPU)
        "landmarks_vs_golden_max_abs_err": max_err(
            np, np.concatenate([g.reshape(-1) for g in got]), golden),
        "device1_refusal": raised, "models_loaded_before_refusal": loads,
    }


def codec_roundtrip_phase(torch, np, dev, parse_pipeline, source):
    """codec-roundtrip-720p: 720p frames → decoder mode=M → converter mode=M
    → sink, for M in flexbuf, protobuf, flatbuf: every frame back on the
    card, byte for byte; frame 0's wire bytes as the CPU encodes them;
    encode and decode host ms; copies a frame over a 16-frame profile."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for m in CODECS:
        desc = CODEC_ROUNDTRIP.format(n=FRAMES, m=m)
        wires = {}
        for device, n in (("cpu", 1), (dev, FRAMES)):
            p = parse_pipeline(CODEC_ROUNDTRIP.format(n=n, m=m), device=device)
            p.negotiate()
            enc_ms, dec_ms, seen, wire = [], [], set(), []
            timed_calls(p["enc"]._sub, "decode", enc_ms)
            real = p["dec"]._subplugin.convert
            p["dec"]._subplugin.convert = lambda f, props, r=real: (
                wire.append(bytes(f.tensors[0])) if not wire else None, r(f, props))[1]
            timed_calls(p["dec"]._subplugin, "convert", dec_ms)
            t0 = time.perf_counter()
            with SinkDevices() as sinks:  # the tensors as they reach the sink
                p.run(timeout=600)
            wall = time.perf_counter() - t0
            seen |= sinks.seen
            wires[str(device)] = wire[0]
        got = [f.tensors[0] for f in p["out"].frames]
        if len(got) != FRAMES or seen != {dev.type}:
            raise AssertionError(f"codec {m}: {len(got)} frames on {seen}, want {FRAMES} on cuda")
        bad = [i for i, (g, s) in enumerate(zip(got, source)) if not (
            g.shape == s.shape and g.dtype == s.dtype and np.array_equal(g, s))]
        if bad:
            raise AssertionError(f"codec {m}: frames {bad[:4]} differ from the source")
        if wires[str(dev)] != wires["cpu"]:
            raise AssertionError(f"codec {m}: frame 0's wire bytes differ from the CPU encoding")
        n_prof = 16
        pp = parse_pipeline(CODEC_ROUNDTRIP.format(n=n_prof, m=m), device=dev)
        pp.negotiate()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pp.run(timeout=600)
        d2h, h2d = copies(prof)
        # one D2H (the decoder's) and one H2D (the converter's) a frame,
        # beside the sink's D2H and the ingress segment's H2D
        if d2h > 2 * n_prof or h2d > 2 * n_prof:
            raise AssertionError(f"codec {m}: {d2h} D2H / {h2d} H2D over {n_prof} frames, "
                                 f"limit {2 * n_prof} each")
        out[m] = {
            "fps": FRAMES / wall, "wall_s": wall, "wire_bytes_frame": len(wires["cpu"]),
            "encode_host_ms_mean": sum(enc_ms) / len(enc_ms),
            "decode_host_ms_mean": sum(dec_ms) / len(dec_ms),
            "d2h_per_frame": d2h / n_prof, "h2d_per_frame": h2d / n_prof,
            "copy_limit_per_frame": {"d2h": 2, "h2d": 2}, "sink_devices": sorted(seen),
        }
    return {"phase": "codec_roundtrip", "config": "codec-roundtrip-720p", "frames": FRAMES,
            "profile_frames": 16, "byte_exact": True, "codecs": out}


def codec_labeling_phase(torch, np, dev, parse_pipeline, ik, pipeline_phase):
    """codec-labeling-720p: the labeling cell with a protobuf decoder →
    converter pair between resize and model; the filter takes the flexible
    stream. K1 once a frame; labels and logits against the same frames
    without the pair."""
    def desc(n, live=False):
        return CODEC_LABELING.format(n=n, m="protobuf", live=LIVE if live else "")

    run_desc(parse_pipeline, desc(4), dev)  # warm-up
    p = parse_pipeline(desc(FRAMES), device=dev)
    p.negotiate()
    if not p["f"]._flexible_input:
        raise AssertionError("codec_labeling: the filter did not take a flexible stream")
    ik.crop_resize_launches.reset()
    t0 = time.perf_counter()
    p.run(timeout=600)
    wall = time.perf_counter() - t0
    k1 = ik.crop_resize_launches.count
    if k1 != FRAMES:
        raise AssertionError(f"codec_labeling: K1 launched {k1} times for {FRAMES} frames")
    labels = [int(t[0]) for t in out_tensors(p)]
    if labels != pipeline_phase["labels"]:
        raise AssertionError(f"codec_labeling: labels {labels[:4]} != the pipeline phase's "
                             f"{pipeline_phase['labels'][:4]}")
    # the logits of 8 frames each way (not timed): the codec run's filter is
    # a host node, read by a forward hook; the codec-free run drops the
    # decoder and its sink takes the logits (its segment replays a CUDA
    # graph, where a forward hook fires only at the capture)
    logits = {"codec": [], "plain": []}
    plain, _ = run_desc(parse_pipeline, PIPELINE.format(n=8, live="").replace(
        "tensor_decoder mode=image_labeling ! ", ""), dev)
    logits["plain"] = [torch.from_numpy(t).float() for t in out_tensors(plain)]
    run_desc(parse_pipeline, desc(8), dev,
             hook=lambda m, i, o: logits["codec"].append(o.detach().float().cpu()))
    if len(logits["codec"]) != 8 or len(logits["plain"]) != 8:
        raise AssertionError("codec_labeling: want 8 logit frames each way")
    err = max(float((a - b).abs().max()) for a, b in zip(logits["codec"], logits["plain"]))
    paced, _ = run_desc(parse_pipeline, desc(FRAMES, live=True), dev)
    lat = sorted(latencies(paced))
    return {
        "phase": "codec_labeling", "config": "codec-labeling-720p", "codec": "protobuf",
        "frames": FRAMES, "k1_launches": k1, "filter_flexible_input": True,
        "labels_equal_codec_free": True, "logits_max_abs_err_vs_codec_free": err,
        "fps": FRAMES / wall, "wall_s": wall,
        "paced30_latency_ms_p50": pct(lat, 0.5), "paced30_latency_ms_p99": pct(lat, 0.99),
        "paced30_limit_ms": 33.0,
        "pipeline_phase_same_call": {k: pipeline_phase[k] for k in (
            "fps", "paced30_latency_ms_p50", "paced30_latency_ms_p99")},
    }


def cli_card_phase(np, dev, parse_pipeline):
    """The port's CLI in subprocesses on the card, without --device, all at
    once: filter_python3 and filter_scaler byte for byte; composite_face
    (device:0) against the port's CPU run (the CLI sets no TF32 switch of
    its own); bad_mesh refused with its device count and no traceback."""
    here, fix, _ = repo_paths()
    with tempfile.TemporaryDirectory() as tmp:
        outs = {n: os.path.join(tmp, f"{n}.raw") for n in ("filter_python3", "filter_scaler",
                                                           "composite_face")}
        descs = {n: CODEC_GOLDENS[n].format(out=outs[n], fix=fix)
                 for n in ("filter_python3", "filter_scaler")}
        descs["composite_face"] = COMPOSITE_FACE.format(
            lmk=0, sink=f"filesink location={outs['composite_face']}")
        descs["bad_mesh"] = BAD_MESH
        t0 = time.perf_counter()
        procs = {n: subprocess.Popen(
            [sys.executable, "-m", "nnstreamer_tpu_torch.cli", "-q", d], cwd=here,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for n, d in descs.items()}
        res = {}
        for n, proc in procs.items():
            try:
                _, err = proc.communicate(timeout=300)
            finally:
                proc.kill()
            res[n] = (proc.returncode, err)
        wall = time.perf_counter() - t0
        for n in ("filter_python3", "filter_scaler"):
            rc, err = res[n]
            with open(outs[n], "rb") as f:
                if rc != 0 or f.read() != golden_bytes(n):
                    raise AssertionError(f"cli {n}: rc {rc} or bytes differ from the golden: {err}")
        rc, err = res["composite_face"]
        if rc != 0:
            raise AssertionError(f"cli composite_face: rc {rc}: {err}")
        with open(outs["composite_face"], "rb") as f:
            got = np.frombuffer(f.read(), np.float32)
    cpu, _ = run_desc(parse_pipeline, COMPOSITE_FACE.format(lmk=0, sink="tensor_sink name=out"),
                      "cpu")
    want = np.concatenate([t.reshape(-1) for t in out_tensors(cpu)])
    if got.shape != want.shape:
        raise AssertionError(f"cli composite_face: {got.shape} values, CPU run {want.shape}")
    cf_err = max_err(np, got, want)
    if not cf_err <= FACE_LMK_TOL:
        raise AssertionError(f"cli composite_face: GPU vs CPU landmarks {cf_err} > {FACE_LMK_TOL}")
    rc, err = res["bad_mesh"]
    if rc == 0 or "needs 999 devices" not in err or "Traceback" in err:
        raise AssertionError(f"cli bad_mesh: rc {rc}, stderr {err[-400:]!r}")
    return {"subprocesses": len(procs), "wall_s": wall,
            "byte_exact": ["filter_python3", "filter_scaler"],
            "composite_face_gpu_vs_cpu_max_abs_err": cf_err, "tolerance": FACE_LMK_TOL,
            "bad_mesh": err.strip().splitlines()[-1]}


def script_720p_phase(torch, np, dev, parse_pipeline, source):
    """filter_python3's script (numpy, on the host) on 720p frames: the
    output is 255 - frame, one D2H and one H2D a frame for the filter."""
    from torch.profiler import ProfilerActivity, profile

    _, fix, _ = repo_paths()
    n = 16
    desc = SCRIPT_720P.format(n=n, fix=fix)
    run_desc(parse_pipeline, SCRIPT_720P.format(n=2, fix=fix), dev)  # warm-up
    p, wall = run_desc(parse_pipeline, desc, dev)
    got = out_tensors(p)
    if len(got) != n or len(source) < n or any(
            not np.array_equal(g, 255 - s) for g, s in zip(got, source)):
        raise AssertionError("script_720p: the output is not 255 - frame")
    pp = parse_pipeline(desc, device=dev)
    pp.negotiate()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pp.run(timeout=600)
    d2h, h2d = copies(prof)
    # the filter's D2H and H2D, beside the sink's D2H and the ingress H2D
    if d2h > 2 * n or h2d > 2 * n:
        raise AssertionError(f"script_720p: {d2h} D2H / {h2d} H2D over {n} frames")
    return {"frames": n, "fps": n / wall, "wall_s": wall,
            "d2h_per_frame": d2h / n, "h2d_per_frame": h2d / n,
            "copy_limit_per_frame": {"d2h": 2, "h2d": 2}}


def codecs_phases(torch, np, dev, parse_pipeline, ik, pipeline_phase):
    """The codecs group: the A.1 goldens on CUDA, composite_face on one
    card, codec-roundtrip-720p, codec-labeling-720p, the CLI on the card,
    the python3 filter at 720p. Returns K1's launches on codec-labeling."""
    t0 = time.perf_counter()
    goldens = codec_goldens(parse_pipeline, dev)
    face = composite_face_phase(np, dev, parse_pipeline)
    emit({"phase": "codec_goldens", "goldens_cuda_byte_exact": goldens, "composite_face": face})
    src, _ = run_desc(parse_pipeline, HD_SOURCE.format(n=FRAMES) + " ! tensor_converter ! "
                      "tensor_sink name=out", dev)
    source = out_tensors(src)
    emit(codec_roundtrip_phase(torch, np, dev, parse_pipeline, source))
    labeling = codec_labeling_phase(torch, np, dev, parse_pipeline, ik, pipeline_phase)
    emit(labeling)
    emit({"phase": "codec_cli", **cli_card_phase(np, dev, parse_pipeline),
          "script_720p": script_720p_phase(torch, np, dev, parse_pipeline, source),
          "group_seconds": time.perf_counter() - t0})
    return labeling["k1_launches"]


def ssd_frame_candidates(torch, parse_pipeline, dev):
    """The 1917 (box, score) NMS candidates of one SSD output frame (the
    detection pipeline's source frame, through its resize and model)."""
    from nnstreamer_tpu_torch.models import ssd_mobilenet
    from nnstreamer_tpu_torch.ops import detection as det

    frame = parse_pipeline(SSD_FRAME, device=dev)
    frame.run(timeout=600)
    loc, cls = (torch.from_numpy(t).to(dev) for t in frame["out"].frames[0].tensors)
    priors = torch.from_numpy(ssd_mobilenet.generate_anchors()).to(dev)
    boxes, _, scores = det.ssd_candidates(loc[0], cls[0], priors)
    return boxes, scores


def k1_cases(torch, np, ik):
    """The K1 cases: both entry points at the pipelines' shapes and others."""
    crop_boxes = np.array([
        [0, 0, 1280, 720], [100.5, 50.25, 400.75, 300.5], [-20, -10, 200, 150],
        [640, 360, 640, 360],  # degenerate
        [900, 500, 1279, 719], [10, 600, 300, 719.5], [500, 0, 780, 720],
        [1200.5, 700.5, 1300, 760],
    ], np.float32)
    return [
        kernel_case(torch, np, ik, "resize-u8-720p-224", torch.uint8,
                    (1, 720, 1280, 3), (224, 224)),
        kernel_case(torch, np, ik, "resize-u8-720p-300", torch.uint8,
                    (1, 720, 1280, 3), (300, 300)),
        kernel_case(torch, np, ik, "resize-f32-480p-300", torch.float32,
                    (2, 480, 640, 3), (300, 300)),
        kernel_case(torch, np, ik, "resize-bf16-480p-300", torch.bfloat16,
                    (2, 480, 640, 3), (300, 300)),
        kernel_case(torch, np, ik, "crop-u8-720p-8box-112", torch.uint8,
                    (720, 1280, 3), (112, 112), boxes=crop_boxes),
        kernel_case(torch, np, ik, "resize-u8-720p-224-normalize", torch.uint8,
                    (1, 720, 1280, 3), (224, 224), scale=1 / 255, offset=-0.5),
        # the routing phase's crop: a region frame as tensor_crop hands it on
        kernel_case(torch, np, ik, "crop-u8-720p-16box-112-routing", torch.uint8,
                    (720, 1280, 3), (112, 112), boxes=routing_xyxy(np)),
    ]


def routing_xyxy(np):
    """The routing phase's first region frame as tensor_crop passes it to
    K1: float32 pixel corners (x, y, x + w, y + h), zero-size ones kept."""
    xywh = routing_regions(np, 1)[0].astype(np.float32)
    return np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]], 1)



# -- the serving plane's core (ROADMAP A.4c) ---------------------------------------------

PLANE_FRAMES = 256  # a stream
# the timed runs, in this order (a plane's ring-depth, or None for two
# private filters): each kind three times, interleaved so that a drift of
# the card's clock does not favour one; the first is the checked run
PLANE_RUNS = (1, None, 2, 2, None, 1, 1, None, 2)
PLANE_PATTERNS = ("gradient", "counter")  # the two streams: a row swap shows
# two streams in ONE description, one plane; {plane}: " plane=..." or "" (private filters)
PLANE_PIPELINE = " ".join(
    f"videotestsrc pattern={pat} width=1280 height=720 num-frames={{n}} ! tensor_converter ! "
    "tensor_transform mode=resize option=224:224 ! "
    f"tensor_filter name=f{k} framework=torch model=zoo:mobilenet_v2{{plane}} ! "
    f"{{decode}}tensor_sink name=out{k}" for k, pat in enumerate(PLANE_PATTERNS)
)
PLANE_LABELS = "tensor_decoder mode=image_labeling ! "
PLANE_LOGITS_FRAMES = 16
# the LLM plane's depth; its checks (generations against a private batcher,
# one replay a pump, K4 = layers x steps, zero gathers) do not depend on it;
# cut from 32 so that the whole script keeps its time limit
LLM_PLANE_LAYERS = 8
# a stream; 192 new tokens give some 20 pumps of 8 decode steps with no
# prefill chunk in them, the samples of the plane's TPOT
LLM_PLANE_REQUESTS, LLM_PLANE_NEW = 4, 192
LLM_PLANE_PIPELINE = " ".join(
    f"appsrc name=src{k} dimensions=512:1 types=int32 ! "
    f'tensor_llm_serversink id=chipplane{k} custom="{{opts}}" attn-impl=pallas kv-layout=paged '
    "block-size=16 kv-blocks=1024 n-slots=8 max-len=4096 prompt-len=512 "
    f"max-new-tokens={LLM_PLANE_NEW} pump=8 plane=chip-llm "
    f"tensor_llm_serversrc name=ssrc{k} id=chipplane{k} ! tensor_sink name=out{k}"
    for k in range(2)
)


def plane_desc(n, plane, decode=True, depth=1):
    props = (f" plane={plane}" + (f" ring-depth={depth}" if depth > 1 else "")) if plane else ""
    return PLANE_PIPELINE.format(n=n, plane=props, decode=PLANE_LABELS if decode else "")


def plane_program_warm(plane, sig):
    """Fill the plane program's per-frame and bucket programs before the
    timed run (on the card: each captured with its rows idle)."""
    prog = plane._ensure_program()
    prog.programs.program_for(sig)
    for b in prog.buckets:
        prog.programs.program_for(sig, b)
    return prog


def plane_run(torch, parse_pipeline, dev, ik, plane, n, record=False, depth=1):
    """One run of the two-stream description (through ``plane`` at ticket
    depth ``depth``, or two private filters when None): every program
    filled before the clock starts, K1 and the graph-replay counter from
    0. → a dict."""
    from nnstreamer_tpu_torch import capture as cap_mod
    from nnstreamer_tpu_torch.serving_plane import plane as plane_mod

    p = parse_pipeline(plane_desc(n, plane, depth=depth), device=dev)
    p.negotiate()
    out = {"pipeline": p}
    sig = (((1, 224, 224, 3), torch.uint8),)
    if plane:
        pl = plane_mod.get(plane)
        prog = plane_program_warm(pl, sig)
        if record:
            inner, rows = prog.invoke, []

            def recording(windows):
                outs = inner(windows)
                rows.append((list(windows), outs))
                return outs

            prog.invoke = recording
            out["rows"] = rows
        out.update(plane=pl, program=prog, replays0=prog.programs.replays)
    ik.crop_resize_launches.reset()
    cap_mod.graph_replays.reset()  # builds capture, they do not replay
    ex = p.start()  # builds every segment's programs before the first frame
    t0 = time.perf_counter()
    done = ex.wait(600)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    out["graph_replays"] = cap_mod.graph_replays.count
    out["segment_replays"] = sum(s.programs.replays for s in ex.plan.segments)
    out["stats"] = ex.stats()
    if plane:
        prog = out["program"]
        out["plane_stats"] = out["plane"].stats()
        out["plane_replays"] = prog.programs.replays - out["replays0"]
        out["captured"] = prog.programs.captured
        if record:
            # before the filters stop (the last one closes the plane): each
            # recorded row against the plane's own per-frame program
            out["rows_checked"] = 0
            for windows, outs in out["rows"]:
                for w, o in zip(windows, outs):
                    if not torch.equal(o[0], prog.invoke_one(w)[0]):
                        raise AssertionError("plane_pipelines: a batched row differs from "
                                             "invoke_one of its frame")
                    out["rows_checked"] += 1
    ex.stop()
    if ex.errors or not done:
        raise AssertionError(f"plane_pipelines: {ex.errors or 'no EOS within 600 s'}")
    out["k1_launches"] = ik.crop_resize_launches.count
    out["wall_s"] = wall
    out["fps_both"] = 2 * n / wall
    out["fps"] = {}
    for k, pat in enumerate(PLANE_PATTERNS):
        frames = p[f"out{k}"].frames
        if len(frames) != n:
            raise AssertionError(f"plane_pipelines: stream {pat} gave {len(frames)} of {n} frames")
        out["fps"][pat] = n / (frames[-1].meta["render_t"] - t0)
    return out


def plane_pipelines_phase(torch, np, dev, parse_pipeline, ik):
    """Two streams of one description (720p gradient and counter → resize
    224 → MobileNet-v2 → image_labeling) through one plane, against the
    same description with two private filters."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.serving_plane import plane as plane_mod

    n = PLANE_FRAMES
    assert PLANE_RUNS[:2] == (1, None)
    run = plane_run(torch, parse_pipeline, dev, ik, "chip-plane", n, record=True)
    st = run["plane_stats"]
    if run["k1_launches"] != 2 * n:
        raise AssertionError(f"plane_pipelines: K1 launched {run['k1_launches']} times for "
                             f"2 x {n} frames")
    if st["frames"] != 2 * n or st["split_dispatches"]:
        raise AssertionError(f"plane_pipelines: plane stats {st}")
    frames_per_dispatch = st["frames"] / st["dispatches"]
    if not frames_per_dispatch > 1:
        raise AssertionError(f"plane_pipelines: {frames_per_dispatch} frames a dispatch: no "
                             "cross-stream batch formed")
    if run["plane_replays"] != st["dispatches"]:
        raise AssertionError(f"plane_pipelines: {run['plane_replays']} plane graph replays for "
                             f"{st['dispatches']} dispatches")
    if run["graph_replays"] != run["plane_replays"] + run["segment_replays"]:
        raise AssertionError(f"plane_pipelines: capture.replay counted {run['graph_replays']}, "
                             f"the plane {run['plane_replays']} + the segments "
                             f"{run['segment_replays']}")
    if not run["captured"]:
        raise AssertionError("plane_pipelines: the plane's programs are not CUDA graphs")
    rows_checked = run["rows_checked"]
    if rows_checked != 2 * n:
        raise AssertionError(f"plane_pipelines: {rows_checked} rows recorded for 2 x {n}")
    if plane_mod.get("chip-plane") is not None:
        raise AssertionError("plane_pipelines: the plane outlived its filters")
    private = plane_run(torch, parse_pipeline, dev, ik, None, n)

    def labels_of(r):
        return [[int(f.tensors[0][0]) for f in r["pipeline"][f"out{k}"].frames]
                for k in range(len(PLANE_PATTERNS))]

    want_labels = labels_of(private)
    labels = {pat: want_labels[k][:4] for k, pat in enumerate(PLANE_PATTERNS)}
    # fps samples: every run of PLANE_RUNS, each checked for K1 a frame and
    # for the private filters' labels in order (ring-depth 2 included)
    samples = {"depth1": [run], "private": [private], "depth2": []}
    for i, depth in enumerate(PLANE_RUNS):
        if i >= 2:
            r = plane_run(torch, parse_pipeline, dev, ik,
                          f"chip-plane-{i}" if depth else None, n, depth=depth or 1)
            samples[f"depth{depth}" if depth else "private"].append(r)
        else:
            r = (run, private)[i]
        if r["k1_launches"] != 2 * n:
            raise AssertionError(f"plane_pipelines: run {i} launched K1 {r['k1_launches']} "
                                 f"times for 2 x {n} frames")
        if depth and r["plane_stats"]["frames"] != 2 * n:
            raise AssertionError(f"plane_pipelines: run {i} plane stats {r['plane_stats']}")
        for k, pat in enumerate(PLANE_PATTERNS):
            if labels_of(r)[k] != want_labels[k]:
                raise AssertionError(f"plane_pipelines: run {i} (ring-depth {depth}) stream "
                                     f"{pat} labels differ from the private filter's")
        for key in ("pipeline", "plane", "program", "rows"):
            r.pop(key, None)  # a run is checked: let its frames, plane and graphs go
    fps = {kind: {"fps_both": [r["fps_both"] for r in rs],
                  "fps_per_stream": {pat: [r["fps"][pat] for r in rs] for pat in PLANE_PATTERNS},
                  "fps_both_median": float(np.median([r["fps_both"] for r in rs])),
                  "runs": len(rs)}
           for kind, rs in samples.items()}
    for kind in ("depth1", "depth2"):
        fps[kind]["frames_per_dispatch"] = [
            r["plane_stats"]["frames"] / r["plane_stats"]["dispatches"] for r in samples[kind]]
    # logits: the plane against private filters, PLANE_LOGITS_FRAMES a stream
    logits = {}
    for plane in ("chip-plane-logits", None):
        p = parse_pipeline(plane_desc(PLANE_LOGITS_FRAMES, plane, decode=False), device=dev)
        p.run(timeout=600)
        logits[plane] = [np.stack([f.tensors[0] for f in p[f"out{k}"].frames])
                         for k in range(2)]
    logit_err, logit_tol = 0.0, 0.0
    for got, want in zip(logits["chip-plane-logits"], logits[None]):
        logit_err = max(logit_err, float(np.abs(got - want).max()))
        logit_tol = max(logit_tol, 1e-4 * float(np.abs(want).max()))
        if not np.array_equal(got.argmax(-1), want.argmax(-1)):
            raise AssertionError("plane_pipelines: plane top-1 differs from a private filter's")
    if not logit_err <= logit_tol:
        raise AssertionError(f"plane_pipelines: logits {logit_err} from the private filter's "
                             f"> {logit_tol}")
    # the busy share of a 16-frame plane run
    p = parse_pipeline(plane_desc(16, "chip-plane-prof"), device=dev)
    p.negotiate()
    plane_program_warm(plane_mod.get("chip-plane-prof"), (((1, 224, 224, 3), torch.uint8),))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p.run(timeout=600)
        prof_wall = time.perf_counter() - t0
    busy = profile_classes(torch, prof, prof_wall, [("crop_resize (K1)", "crop_resize")])
    torch.cuda.empty_cache()
    return {
        "phase": "plane_pipelines", "frames_per_stream": n, "streams": list(PLANE_PATTERNS),
        "k1_launches": run["k1_launches"], "dispatches": st["dispatches"],
        "frames_per_dispatch": frames_per_dispatch, "n_traces": st["n_traces"],
        "plane_graph_replays": run["plane_replays"], "graph_replays": run["graph_replays"],
        "segment_replays": run["segment_replays"], "rows_bitwise_invoke_one": rows_checked,
        "labels_first4": labels, "labels_equal_private": True,
        "logits_max_abs_err": logit_err, "logits_tolerance": logit_tol,
        "run_order": ["private" if d is None else f"depth{d}" for d in PLANE_RUNS],
        "fps": fps, "wall_s": run["wall_s"], "private_k1_launches": private["k1_launches"],
        "profile_16": {k: busy[k] for k in ("device_busy_share", "device_ms", "wall_ms",
                                            "device_ms_by_class")},
    }


def llm_plane_phase(torch, np, dev, parse_pipeline):
    """Two serversink/serversrc pairs on one LLM plane at Mistral-7B's
    widths (LLM_PLANE_LAYERS layers), 4 requests a stream; then, after the
    plane is released, a private paged batcher on the same weights and
    prompts as the oracle."""
    import gc

    from nnstreamer_tpu_torch import capture as cap_mod
    from nnstreamer_tpu_torch.models import serving as sv
    from nnstreamer_tpu_torch.models import transformer as tfm
    from nnstreamer_tpu_torch.models import zoo
    from nnstreamer_tpu_torch.ops.kernels import decode_attention as da
    from nnstreamer_tpu_torch.ops.kernels import paged_attention as pa
    from nnstreamer_tpu_torch.serving_plane import llm as llm_plane
    from nnstreamer_tpu_torch.tensors.frame import Frame

    layers = LLM_PLANE_LAYERS
    opts = (f"vocab:{MISTRAL['vocab']},d_model:{MISTRAL['d_model']},n_heads:{MISTRAL['n_heads']},"
            f"n_kv_heads:{MISTRAL['n_kv_heads']},d_ff:{MISTRAL['d_ff']},n_layers:{layers},seed:0")
    rng = np.random.default_rng(16)
    prompts = {f"s{k}r{i}": rng.integers(1, MISTRAL["vocab"], n).astype(np.int32)
               for k in range(2) for i, n in enumerate(rng.integers(64, 513, LLM_PLANE_REQUESTS))}

    def through_plane():
        pl = parse_pipeline(LLM_PLANE_PIPELINE.format(opts=opts), device=dev)
        ex = pl.start()
        plane = llm_plane.get("chip-llm")
        if plane is None or len(plane._sched) != 2:
            raise AssertionError("llm_plane: the two serversinks do not share one plane")
        cb = plane.cb
        real, pumps = cb.step_pump, []

        def timed_pump(n):
            # a pump with prefill chunks queued runs one of them first
            # (admission): TPOT reads the pumps without one
            prefill = cb.stats()["kv_prefill_queue"]
            r0 = cap_mod.graph_replays.count
            t0 = time.perf_counter()
            got = real(n)
            pumps.append((time.perf_counter() - t0, cap_mod.graph_replays.count - r0, n, prefill))
            return got

        cb.step_pump = timed_pump
        st0 = cb.stats()
        pa.paged_decode_attention_launches.reset()
        da.decode_attention_launches.reset()
        t0 = time.perf_counter()
        for k in range(2):
            for name, p in prompts.items():
                if name.startswith(f"s{k}"):
                    pl[f"src{k}"].push(Frame((p,), meta={"req": name}))
            pl[f"src{k}"].end_of_stream()
        done = ex.wait(900)
        wall = time.perf_counter() - t0
        k4, k3 = pa.paged_decode_attention_launches.count, da.decode_attention_launches.count
        ex.stop()
        if ex.errors or not done:
            raise AssertionError(f"llm_plane: {ex.errors or 'no EOS within 900 s'}")
        stats = [pl[f"ssrc{k}"].serving_stats() for k in range(2)]
        emitted = {k: [f.meta["req"] for f in pl[f"out{k}"].frames] for k in range(2)}
        got = {f.meta["req"]: f.tensors[0][0].tolist()
               for k in range(2) for f in pl[f"out{k}"].frames}
        return dict(stats=stats, st0=st0, emitted=emitted, got=got, pumps=pumps, k4=k4, k3=k3,
                    wall=wall)

    r = through_plane()
    gc.collect()
    torch.cuda.empty_cache()
    if llm_plane.get("chip-llm") is not None:
        raise AssertionError("llm_plane: the plane outlived its serversinks")
    for k in range(2):
        if sorted(r["emitted"][k]) != sorted(n for n in prompts if n.startswith(f"s{k}")):
            raise AssertionError(f"llm_plane: serversrc {k} emitted {r['emitted'][k]}")
    # each serversrc's stats were read when its own stream drained: the
    # later one saw every pump
    final = max(r["stats"], key=lambda s: s["steps"])
    steps = final["steps"] - r["st0"]["steps"]
    if r["k4"] != layers * steps or r["k3"]:
        raise AssertionError(f"llm_plane: K4 launched {r['k4']} times for {layers} x {steps} "
                             f"steps (K3 {r['k3']})")
    for s in r["stats"]:
        if s.get("kv_gather_dispatches", 0) != 0 or s["kv_attn"] != "block":
            raise AssertionError(f"llm_plane: the decode gathered: {s}")
        if (s["stream_submitted"], s["stream_served"], s["stream_errors"]) != (
                LLM_PLANE_REQUESTS, LLM_PLANE_REQUESTS, 0):
            raise AssertionError(f"llm_plane: stream counters {s}")
    per_pump = [d for _, d, _, _ in r["pumps"]]
    replayed = [t * 1e3 / n for t, d, n, prefill in r["pumps"] if d == 1 and not prefill]
    if any(d > 1 for d in per_pump) or not replayed:
        raise AssertionError(f"llm_plane: cudaGraphLaunch a pump {sorted(set(per_pump))}")
    replays = sum(p["replays"] for p in final["programs"].values()) - sum(
        p["replays"] for p in r["st0"]["programs"].values())
    if replays != sum(per_pump):
        raise AssertionError(f"llm_plane: {sum(per_pump)} replays counted, the programs "
                             f"{replays}")
    # the oracle: a private paged batcher on the same weights and prompts
    m = zoo.get("transformer_lm", device=dev, **dict(kv.split(":") for kv in opts.split(",")))
    cb = sv.ContinuousBatcher(m.params, MISTRAL["n_heads"], **SERVE, **PAGED,
                              kv_blocks=KV_BLOCKS, attn_impl="pallas", device=dev)
    names = list(prompts)
    drive_paged(cb, [prompts[names[0]][:64]], 4)  # warm-up: the programs' fills
    private = drive_paged(cb, [prompts[n] for n in names], LLM_PLANE_NEW)
    parted = 0
    with torch.no_grad():
        for n, want in zip(names, private["tokens"]):
            parted += stream_check(torch, np, tfm, m.params, prompts[n], r["got"][n], want,
                                   MARGIN_REL, torch.float32)
    del cb, m
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "phase": "llm_plane", **MISTRAL, "n_layers": layers, "streams": 2,
        "requests_per_stream": LLM_PLANE_REQUESTS, "new_tokens": LLM_PLANE_NEW,
        "prompt_lens": {n: len(p) for n, p in prompts.items()}, "pump": 8,
        "k4_launches": r["k4"], "steps": steps, "layers_x_steps": layers * steps,
        "pumps": len(per_pump), "pumps_replayed": sum(per_pump),
        "decode_pumps_timed": len(replayed),
        "private_pumps_timed": len(private["pump_ms_per_step"]),
        "graph_launches_per_replayed_pump": 1, "program_replays": replays,
        "kv_gather_dispatches": 0, "equal_to_private": len(names) - parted,
        "parted_at_near_tie": parted, "wall_s": r["wall"],
        "tpot_ms_p50_plane": pct(sorted(replayed), 0.5),
        "tpot_ms_p50_private": pct(private["pump_ms_per_step"], 0.5),
        "tokens_first_request": r["got"][names[0]][:8],
    }


def plane_phases(torch, np, dev, parse_pipeline, ik):
    """The plane group: plane_pipelines, then llm_plane."""
    t0 = time.perf_counter()
    pipes = plane_pipelines_phase(torch, np, dev, parse_pipeline, ik)
    emit(pipes)
    llm = llm_plane_phase(torch, np, dev, parse_pipeline)
    emit(llm)
    return {"plane_pipelines": pipes, "llm_plane": llm, "seconds": time.perf_counter() - t0}


# -- the model_sources group (ROADMAP A.3 + A.5) ---------------------------------
#
# The card's machine has no tensorflow, and no .tflite binary is kept in the
# repository: the tflite_program phase writes its own file with the flatbuffer
# writer below, which lays out the schema fields tools/tflite_parse.py reads
# (and the TFLite interpreter needs) front to back.

MS_FRAMES = 32
MS_FPS_FRAMES = 512  # frames of a cell's fps run: its start-up a small share
VIT_LABELING = (
    "videotestsrc pattern=gradient width=1280 height=720 num-frames={n} ! tensor_converter ! "
    "tensor_transform mode=resize option=224:224 ! "
    "tensor_filter name=f framework=torch model=zoo:vit ! "
    "tensor_decoder mode=image_labeling ! tensor_sink name=out"
)
# a one-second clip at 16 kHz (the Speech Commands clip) into the zoo's 12 classes
KWS_AUDIO = (
    "audiotestsrc samples-per-buffer=16000 channels=1 num-buffers={n} ! tensor_converter ! "
    'tensor_filter name=f framework=torch model=zoo:kws custom="samples:16000" ! '
    "tensor_decoder mode=image_labeling ! tensor_sink name=out"
)
TFLITE_LABELING = (
    "videotestsrc pattern=gradient width=1280 height=720 num-frames={n} ! tensor_converter ! "
    "tensor_transform mode=resize option=224:224 ! "
    "tensor_transform mode=typecast option=float32 ! "
    "tensor_filter name=f framework=torch model={model} ! "
    "tensor_decoder mode=image_labeling ! tensor_sink name=out"
)
LABELS = "tensor_decoder mode=image_labeling ! "
# float32 against the same module (program) on the CPU, TF32 off: another
# summation order through the stack
MS_LOGIT_REL_TOL = 1e-4

# TFLite schema (schema.fbs) enums: TensorType, BuiltinOperator, the
# BuiltinOptions union's member ids, Padding and ActivationFunctionType
TFL_TYPES = {"float32": 0, "int32": 2, "uint8": 3, "int64": 4, "int8": 9}
TFL_OPS = {"ADD": 0, "AVERAGE_POOL_2D": 1, "CONV_2D": 3, "DEPTHWISE_CONV_2D": 4,
           "MAX_POOL_2D": 17, "MUL": 18, "RESHAPE": 22, "SOFTMAX": 25}
TFL_PADDING = {"SAME": 0, "VALID": 1}
TFL_ACT = {None: 0, "RELU": 1, "RELU_N1_TO_1": 2, "RELU6": 3, "TANH": 4}
_POOL = (5, (("padding", "B"), ("stride_w", "i"), ("stride_h", "i"), ("filter_w", "i"),
             ("filter_h", "i"), ("activation", "B")))
# op → (BuiltinOptions member id, its table's fields in slot order)
TFL_OPTIONS = {
    "CONV_2D": (1, (("padding", "B"), ("stride_w", "i"), ("stride_h", "i"), ("activation", "B"),
                    ("dilation_w", "i"), ("dilation_h", "i"))),
    "DEPTHWISE_CONV_2D": (2, (("padding", "B"), ("stride_w", "i"), ("stride_h", "i"),
                              ("depth_multiplier", "i"), ("activation", "B"),
                              ("dilation_w", "i"), ("dilation_h", "i"))),
    "AVERAGE_POOL_2D": _POOL,
    "MAX_POOL_2D": _POOL,
    "ADD": (11, (("activation", "B"),)),
    "MUL": (21, (("activation", "B"),)),
    "RESHAPE": (17, (("new_shape", "[i"),)),
    "SOFTMAX": (9, (("beta", "f"),)),
}


class FlatWriter:
    """A flatbuffer laid out front to back: each table's vtable just before
    it (its soffset points back), a table's children written after it and
    reached by forward offsets, every scalar at its size's alignment, the
    data of a vector at ``align`` (16 for a tensor's bytes)."""

    def __init__(self, ident: bytes) -> None:
        self.buf = bytearray(4) + ident  # the root offset, then the file identifier

    def _pad(self, align: int, extra: int = 0) -> None:
        self.buf += bytes(-(len(self.buf) + extra) % align)

    def vector(self, arr, align: int = 4) -> int:
        self._pad(max(4, align), 4)
        pos = len(self.buf)
        self.buf += arr.size.to_bytes(4, "little") + arr.tobytes()
        return pos

    def string(self, s: str) -> int:
        data = s.encode()
        self._pad(4)
        pos = len(self.buf)
        self.buf += len(data).to_bytes(4, "little") + data + b"\0"
        return pos

    def table(self, fields) -> int:
        """``fields``: (slot, fmt, value): a struct format for a scalar, or
        "o" for an offset to what ``value()`` writes after this table."""
        import struct

        layout, off = [], 4
        for slot, fmt, value in fields:
            size = 4 if fmt == "o" else struct.calcsize(fmt)
            off += -off % size
            layout.append((slot, fmt, value, off))
            off += size
        size = off + (-off % 4)
        n = max((s for s, _, _ in fields), default=-1) + 1
        slots = [0] * n
        for slot, _, _, o in layout:
            slots[slot] = o
        self._pad(4, 4 + 2 * n)
        vpos = len(self.buf)
        self.buf += struct.pack(f"<HH{n}H", 4 + 2 * n, size, *slots)
        tpos = len(self.buf)
        body = bytearray(size)
        struct.pack_into("<i", body, 0, tpos - vpos)
        for _, fmt, value, o in layout:
            if fmt != "o":
                struct.pack_into("<" + fmt, body, o, value)
        self.buf += body
        for _, fmt, value, o in layout:
            if fmt == "o":
                struct.pack_into("<I", self.buf, tpos + o, value() - (tpos + o))
        return tpos

    def tables(self, makers) -> int:
        """A vector of tables, each written by one of ``makers``."""
        self._pad(4)
        pos = len(self.buf)
        self.buf += len(makers).to_bytes(4, "little") + bytes(4 * len(makers))
        for i, make in enumerate(makers):
            slot = pos + 4 + 4 * i
            self.buf[slot:slot + 4] = (make() - slot).to_bytes(4, "little")
        return pos

    def finish(self, root: int) -> bytes:
        self.buf[0:4] = root.to_bytes(4, "little")
        return bytes(self.buf)


def tflite_bytes(np, graph) -> bytes:
    """A .tflite flatbuffer (schema version 3) of ``graph``: ``tensors``
    (name, shape, dtype, data or None), ``ops`` (op, inputs, outputs,
    options as tools/tflite_parse.py reads them back), ``inputs``,
    ``outputs``, ``description``. Buffer 0 is the empty one every
    activation points at; each constant has a buffer of its own."""
    w = FlatWriter(b"TFL3")
    codes = sorted({op["op"] for op in graph["ops"]}, key=lambda name: TFL_OPS[name])
    consts = [t for t in graph["tensors"] if t["data"] is not None]
    buffer_of = {id(t): i + 1 for i, t in enumerate(consts)}

    def i32(values):
        return lambda: w.vector(np.asarray(values, "<i4"))

    def tensor(t):
        return lambda: w.table([
            (0, "o", i32(t["shape"])), (1, "B", TFL_TYPES[t["dtype"]]),
            (2, "I", buffer_of.get(id(t), 0)), (3, "o", lambda: w.string(t["name"]))])

    def option_value(key, fmt, value):
        if key == "padding":
            return "B", TFL_PADDING[value]
        if key == "activation":
            return "B", TFL_ACT[value]
        if fmt == "[i":
            return "o", i32(value)
        return fmt, value

    def op_table(op):
        union, keys = TFL_OPTIONS[op["op"]]
        opts = [(slot, *option_value(key, fmt, op["options"][key]))
                for slot, (key, fmt) in enumerate(keys)]
        return lambda: w.table([
            (0, "I", codes.index(op["op"])), (1, "o", i32(op["inputs"])),
            (2, "o", i32(op["outputs"])), (3, "B", union), (4, "o", lambda: w.table(opts))])

    def code(name):
        c = TFL_OPS[name]
        return lambda: w.table([(0, "b", min(c, 127)), (2, "i", 1), (3, "i", c)])

    def buffer(t):
        data = np.frombuffer(np.ascontiguousarray(t["data"]).tobytes(), np.uint8)
        return lambda: w.table([(0, "o", lambda: w.vector(data, align=16))])

    subgraph = lambda: w.table([  # noqa: E731
        (0, "o", lambda: w.tables([tensor(t) for t in graph["tensors"]])),
        (1, "o", i32(graph["inputs"])), (2, "o", i32(graph["outputs"])),
        (3, "o", lambda: w.tables([op_table(op) for op in graph["ops"]])),
        (4, "o", lambda: w.string("main"))])
    root = w.table([
        (0, "I", 3), (1, "o", lambda: w.tables([code(c) for c in codes])),
        (2, "o", lambda: w.tables([subgraph])),
        (3, "o", lambda: w.string(graph["description"])),
        (4, "o", lambda: w.tables([lambda: w.table([])] + [buffer(t) for t in consts]))])
    return w.finish(root)


def mobilenet_v2_graph(np, seed: int = 0, size: int = 224, num_classes: int = 1001,
                       width: float = 1.0):
    """MobileNet-v2 as TF-slim's mobilenet_v2_<width>_<size> lays it out:
    the input's own MUL / ADD normalization ((x/127.5) - 1 of a float
    [0, 255] image), the stem, 17 inverted residuals (ADD where the shape
    keeps), the 1280 head, a VALID average pool, the 1x1 logits conv and a
    RESHAPE to [1, classes]. Every conv carries a batch norm of seeded
    moments folded into its weights and bias (OHWI, depthwise [1, 3, 3,
    C]), ReLU6 fused but on the projections; TFLite's SAME padding."""
    rng = np.random.default_rng(seed)
    tensors, ops = [], []

    def tensor(name, shape, data=None, dtype="float32"):
        tensors.append({"name": name, "shape": tuple(int(d) for d in shape), "dtype": dtype,
                        "data": data})
        return len(tensors) - 1

    def op(kind, inputs, out, **options):
        ops.append({"op": kind, "inputs": list(inputs), "outputs": [out], "options": options})
        return out

    def divisible(v, d=8):
        new = max(d, int(v + d / 2) // d * d)
        return new + d if new < 0.9 * v else new

    def conv(x, hw, cin, cout, k, stride, act, name, dw=False):
        fan_in = k * k * (1 if dw else cin)
        shape = (1, k, k, cout) if dw else (cout, k, k, cin)
        wt = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        gamma, beta = rng.uniform(0.5, 1.5, cout), rng.normal(0.0, 0.1, cout)
        mean, var = rng.normal(0.0, 0.1, cout), rng.uniform(0.5, 1.5, cout)
        inv = gamma / np.sqrt(var + 1e-3)
        wt = wt * (inv if dw else inv[:, None, None, None])
        out_hw = -(-hw // stride)
        w_i = tensor(f"{name}/weights", shape, wt.astype(np.float32))
        b_i = tensor(f"{name}/bias", (cout,), (beta - mean * inv).astype(np.float32))
        y = tensor(name, (1, out_hw, out_hw, cout))
        opts = dict(padding="SAME", stride_w=stride, stride_h=stride, activation=act,
                    dilation_w=1, dilation_h=1)
        if dw:
            op("DEPTHWISE_CONV_2D", (x, w_i, b_i), y, depth_multiplier=1, **opts)
        else:
            op("CONV_2D", (x, w_i, b_i), y, **opts)
        return y, out_hw

    image = tensor("image", (1, size, size, 3))
    scale = tensor("norm/scale", (1,), np.full((1,), 1.0 / 127.5, np.float32))
    shift = tensor("norm/shift", (1,), np.full((1,), -1.0, np.float32))
    x = op("MUL", (image, scale), tensor("norm/mul", (1, size, size, 3)), activation=None)
    x = op("ADD", (x, shift), tensor("norm/add", (1, size, size, 3)), activation=None)
    cin = divisible(32 * width)
    x, hw = conv(x, size, 3, cin, 3, 2, "RELU6", "stem")
    k = 0
    for t, c, n, s in ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                       (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)):
        cout = divisible(c * width)
        for i in range(n):
            stride = s if i == 0 else 1
            y, y_hw = x, hw
            if t != 1:
                y, _ = conv(y, hw, cin, cin * t, 1, 1, "RELU6", f"block{k}/expand")
            y, y_hw = conv(y, hw, cin * t, cin * t, 3, stride, "RELU6", f"block{k}/dw", dw=True)
            y, _ = conv(y, y_hw, cin * t, cout, 1, 1, None, f"block{k}/project")
            if stride == 1 and cin == cout:
                y = op("ADD", (x, y), tensor(f"block{k}/add", (1, y_hw, y_hw, cout)),
                       activation=None)
            x, hw, cin, k = y, y_hw, cout, k + 1
    c_head = divisible(1280 * width) if width > 1.0 else 1280
    x, hw = conv(x, hw, cin, c_head, 1, 1, "RELU6", "head")
    x = op("AVERAGE_POOL_2D", (x,), tensor("pool", (1, 1, 1, c_head)), padding="VALID",
           stride_w=1, stride_h=1, filter_w=hw, filter_h=hw, activation=None)
    x, _ = conv(x, 1, c_head, num_classes, 1, 1, None, "logits/conv")
    shape = tensor("logits/shape", (2,), np.asarray([1, num_classes], np.int32), "int32")
    logits = op("RESHAPE", (x, shape), tensor("logits", (1, num_classes)),
                new_shape=[1, num_classes])
    return {"tensors": tensors, "ops": ops, "inputs": [image], "outputs": [logits],
            "description": f"mobilenet_v2 {width} {size} {num_classes} classes, seed {seed}"}


def write_mobilenet_v2_tflite(np, path: str, **kw):
    """Write :func:`mobilenet_v2_graph` (``kw``: seed, size, num_classes,
    width) to ``path``; returns the graph written."""
    graph = mobilenet_v2_graph(np, **kw)
    with open(path, "wb") as f:
        f.write(tflite_bytes(np, graph))
    return graph


def parse_matches_graph(np, parsed, graph) -> int:
    """``tools/tflite_parse.parse`` of a written file against the graph
    written: every tensor's name, shape, dtype and bytes, every op's name,
    inputs, outputs and options, the graph's inputs, outputs and
    description. Raises at the first difference; returns the constant
    bytes compared."""
    if len(parsed.tensors) != len(graph["tensors"]) or len(parsed.operators) != len(graph["ops"]):
        raise AssertionError("tflite parse: tensor or op count differs from the file written")
    compared = 0
    for got, want in zip(parsed.tensors, graph["tensors"]):
        if (got.name, got.shape, np.dtype(got.dtype).name) != (want["name"], want["shape"],
                                                                want["dtype"]):
            raise AssertionError(f"tflite parse: tensor {want['name']} differs")
        if (got.data is None) != (want["data"] is None) or (
                got.data is not None and not np.array_equal(got.data, want["data"])):
            raise AssertionError(f"tflite parse: data of {want['name']} differs")
        compared += 0 if got.data is None else got.data.nbytes
    for got, want in zip(parsed.operators, graph["ops"]):
        if (got.name, got.inputs, got.outputs, got.options) != (
                want["op"], want["inputs"], want["outputs"], want["options"]):
            raise AssertionError(f"tflite parse: op {want['op']} differs: {got}")
    if (parsed.inputs, parsed.outputs, parsed.description) != (
            graph["inputs"], graph["outputs"], graph["description"]):
        raise AssertionError("tflite parse: graph inputs, outputs or description differ")
    return compared


class ReplayCount:
    """Counts the CUDA-graph replays of every program (segment or plane)
    while installed."""

    def __enter__(self):
        import nnstreamer_tpu_torch.pipeline.programs as programs_mod

        self.mod, self.real, self.count = programs_mod, programs_mod.replay, 0

        def replay(graph, launches):
            self.count += 1
            return self.real(graph, launches)

        programs_mod.replay = replay
        return self

    def __exit__(self, *exc):
        self.mod.replay = self.real


def labeled_cell(torch, np, dev, parse_pipeline, ik, name, desc, k1_expected):
    """A labeling cell through its fused segment: a warm-up run, then
    MS_FRAMES frames recorded (one replay a frame, K1 ``k1_expected`` times,
    every replay bit for bit against process_eager), fps."""
    from nnstreamer_tpu_torch.pipeline.graph import FusedSegment

    run_desc(parse_pipeline, desc(4), dev)  # warm-up: cuDNN, allocator
    with SegmentLog(FusedSegment) as log, ReplayCount() as replays:
        p, wall = run_desc(parse_pipeline, desc(MS_FRAMES), dev,
                           counters=(ik.crop_resize_launches,))
    k1 = ik.crop_resize_launches.count
    labels = [int(t[0]) for t in out_tensors(p)]
    rows = segment_rows(p._executor.plan)
    if len(labels) != MS_FRAMES:
        raise AssertionError(f"{name}: {len(labels)} of {MS_FRAMES} frames at the sink")
    if replays.count != MS_FRAMES or not any(r["captured"] for r in rows):
        raise AssertionError(f"{name}: {replays.count} replays for {MS_FRAMES} frames: {rows}")
    if k1 != k1_expected:
        raise AssertionError(f"{name}: K1 launched {k1} times, want {k1_expected}")
    n_frames, _ = replay_vs_eager(torch, log.pairs)
    fps, fps_wall = fps_run(parse_pipeline, dev, name, desc)
    return p, {"frames": MS_FRAMES, "replays": replays.count, "k1_launches": k1,
               "segments": rows, "replays_vs_eager_bit_equal": n_frames,
               "labels_first4": labels[:4], "fps_frames": MS_FPS_FRAMES, "fps": fps,
               "fps_wall_s": fps_wall}


def fps_run(parse_pipeline, dev, name, desc):
    """Frames a second over MS_FPS_FRAMES free-running frames."""
    p, wall = run_desc(parse_pipeline, desc(MS_FPS_FRAMES), dev)
    if len(p["out"].frames) != MS_FPS_FRAMES:
        raise AssertionError(f"{name}: {len(p['out'].frames)} of {MS_FPS_FRAMES} frames")
    return MS_FPS_FRAMES / wall, wall


def logits_vs_cpu(torch, np, dev, parse_pipeline, name, logits_desc, n=2):
    """The cell's logits (its description without the decoder) on the card
    against the same filter on the CPU, ``n`` frames: within
    MS_LOGIT_REL_TOL of max |logit|, top-1 equal."""
    got = out_tensors(run_desc(parse_pipeline, logits_desc(n), dev)[0])
    want = out_tensors(run_desc(parse_pipeline, logits_desc(n), "cpu")[0])
    err = max(max_err(np, a, b) for a, b in zip(got, want))
    scale = max(float(np.abs(w).max()) for w in want)
    tol = MS_LOGIT_REL_TOL * scale
    if len(got) != n or not all(np.isfinite(g).all() for g in got):
        raise AssertionError(f"{name}: {len(got)} logits frames, or not finite")
    if not err <= tol or [int(g.argmax()) for g in got] != [int(w.argmax()) for w in want]:
        raise AssertionError(f"{name}: logits err {err} > {tol} against the CPU, or top-1 differs")
    return {"frames": n, "max_abs_err": err, "tolerance": tol, "max_abs_logit": scale,
            "shape": list(got[0].shape)}


def vit_labeling_phase(torch, np, dev, parse_pipeline, ik):
    """ViT-S/16 (zoo:vit at its defaults, float32) behind K1's resize."""
    desc = lambda n: VIT_LABELING.format(n=n)  # noqa: E731
    _, out = labeled_cell(torch, np, dev, parse_pipeline, ik, "vit_labeling", desc, MS_FRAMES)
    out["logits_vs_cpu"] = logits_vs_cpu(torch, np, dev, parse_pipeline, "vit_labeling",
                                         lambda n: desc(n).replace(LABELS, ""))
    classes, _ = profiled(torch, parse_pipeline, desc(16), dev,
                          [("crop_resize (K1)", "crop_resize")], main=MATMUL_KEYS)
    return {"phase": "vit_labeling", "model": "zoo:vit (ViT-S/16: d 384, 6 heads, 12 layers, "
            "224, 1001 classes)", **out, "profile_frames": 16, **classes}


def kws_audio_phase(torch, np, dev, parse_pipeline):
    """zoo:kws on one-second 16 kHz clips from audiotestsrc: labels and
    logits against the CPU module, one replay a frame, fps."""
    from nnstreamer_tpu_torch.pipeline.graph import FusedSegment

    desc = lambda n: KWS_AUDIO.format(n=n)  # noqa: E731
    run_desc(parse_pipeline, desc(4), dev)
    with SegmentLog(FusedSegment) as log, ReplayCount() as replays:
        p, _ = run_desc(parse_pipeline, desc(MS_FRAMES), dev)
    labels = [int(t[0]) for t in out_tensors(p)]
    cpu = [int(t[0]) for t in out_tensors(run_desc(parse_pipeline, desc(MS_FRAMES), "cpu")[0])]
    if len(labels) != MS_FRAMES or labels != cpu:
        raise AssertionError(f"kws_audio: labels {labels[:4]} differ from the CPU run {cpu[:4]}")
    if replays.count != MS_FRAMES:
        raise AssertionError(f"kws_audio: {replays.count} replays for {MS_FRAMES} frames")
    n_frames, _ = replay_vs_eager(torch, log.pairs)
    logits = logits_vs_cpu(torch, np, dev, parse_pipeline, "kws_audio",
                           lambda n: desc(n).replace(LABELS, ""), n=4)
    fps, fps_wall = fps_run(parse_pipeline, dev, "kws_audio", desc)
    classes, _ = profiled(torch, parse_pipeline, desc(16), dev, [])
    return {"phase": "kws_audio", "model": "zoo:kws (samples 16000, 12 classes, width 32)",
            "frames": MS_FRAMES, "replays": replays.count, "replays_vs_eager_bit_equal": n_frames,
            "labels_equal_cpu": True, "labels_first4": labels[:4], "logits_vs_cpu": logits,
            "fps_frames": MS_FPS_FRAMES, "fps": fps, "fps_wall_s": fps_wall,
            "profile_frames": 16, **classes}


def tflite_program_phase(torch, np, dev, parse_pipeline, ik):
    """A MobileNet-v2 1.0/224/1001 .tflite written here (seeded weights, BN
    folded) as the port's own program behind K1's resize: the parse gives
    back what was written, one replay a frame, K1 a frame, the program's
    constants on the card and no interpreter imported, logits against the
    same program on the CPU; load_tflite_params of the same file."""
    from nnstreamer_tpu_torch.models.mobilenet_v2 import load_tflite_params
    from nnstreamer_tpu_torch.tools.tflite_parse import parse

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mobilenet_v2_1.0_224.tflite")
        t0 = time.perf_counter()
        graph = write_mobilenet_v2_tflite(np, path, seed=0)
        write_s = time.perf_counter() - t0
        checked = parse_matches_graph(np, parse(path), graph)
        desc = lambda n: TFLITE_LABELING.format(n=n, model=path)  # noqa: E731
        # the filter's program, read while its backend is open: every
        # constant on the card, no interpreter imported
        probe = parse_pipeline(desc(1), device=dev)
        probe.negotiate()
        prog = probe["f"].backend.program
        places = {str(c.device.type) for c in prog._consts.values()}
        probe.run(timeout=600)
        if places != {dev.type} or "tensorflow" in sys.modules:
            raise AssertionError(f"tflite_program: constants on {places}, tensorflow imported "
                                 f"{'tensorflow' in sys.modules}")
        _, out = labeled_cell(torch, np, dev, parse_pipeline, ik, "tflite_program", desc,
                              MS_FRAMES)
        out["logits_vs_cpu"] = logits_vs_cpu(torch, np, dev, parse_pipeline, "tflite_program",
                                             lambda n: desc(n).replace(LABELS, ""))
        in_shape = graph["tensors"][graph["inputs"][0]]["shape"]
        x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, in_shape)
                             .astype(np.uint8)).to(dev)
        with torch.inference_mode():
            # the module normalizes uint8 as (x - 127.5)/127.5, the graph as
            # x·(1/127.5) - 1 on its float input
            want = prog(x.float())[0]
            got = load_tflite_params(path).to(dev)(x)
        imported_err = max_err(np, got.cpu(), want.cpu())
        imported_tol = MS_LOGIT_REL_TOL * float(want.abs().max())
        if not imported_err <= imported_tol:
            raise AssertionError(f"tflite_program: load_tflite_params logits err {imported_err}"
                                 f" > {imported_tol} against the program")
        ops = sorted({o["op"] for o in graph["ops"]})
        size = os.path.getsize(path)
        classes, _ = profiled(torch, parse_pipeline, desc(16), dev,
                              [("crop_resize (K1)", "crop_resize")])
    return {"phase": "tflite_program", "file_bytes": size, "write_s": write_s,
            "ops": ops, "n_ops": len(graph["ops"]), "parse_equal_bytes": checked,
            "constants_on": sorted(places), "interpreter_imported": False, **out,
            "load_tflite_params": {"max_abs_err": imported_err, "tolerance": imported_tol},
            "profile_frames": 16, **classes}


SCRIPT_MODEL = '''
import torch


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.conv = torch.nn.Conv2d(3, 16, 3, padding=1)
        self.fc = torch.nn.Linear(16, 10)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)

    def forward(self, x):
        y = torch.relu(self.conv(x.permute(0, 3, 1, 2)))
        return self.fc(y.mean(dim=(2, 3)))


def get_model(options):
    from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec, TensorsSpec

    spec = TensorsSpec.of(TensorSpec((1, 64, 64, 3), DType.FLOAT32))
    return Net(), spec


class CustomFilter:
    TRACEABLE = True

    def __init__(self):
        self.net = None

    def getInputDim(self):
        return get_model({})[1]

    def getOutputDim(self):
        from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec, TensorsSpec

        return TensorsSpec.of(TensorSpec((1, 10), DType.FLOAT32))

    def invoke(self, tensors):
        if self.net is None:
            self.net = Net().to(tensors[0].device)
        with torch.no_grad():
            return (self.net(tensors[0]),)
'''


def script_models_phase(torch, np, dev):
    """A TorchScript module saved to a .pt and a get_model .py script, each
    through SingleShot on the card: the .pt by framework=auto, the script by
    framework=torch (get_model) and by framework=auto (the custom backend's
    CustomFilter, as the priority table sends a .py). Outputs on the card;
    the script's equal to its module's eager output bit for bit, the
    TorchScript's within 1e-6 of max |y| (its fuser may reorder)."""
    import importlib.util

    from nnstreamer_tpu_torch.single import SingleShot
    from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec, TensorsSpec

    x = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (1, 64, 64, 3))
                         .astype(np.float32)).to(dev)
    out = {"phase": "script_models"}
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "net.py")
        with open(script, "w") as f:
            f.write(SCRIPT_MODEL)
        spec = importlib.util.spec_from_file_location("chip_script_net", script)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        net = mod.Net().eval().to(dev)
        with torch.inference_mode():
            want = net(x)
        pt = os.path.join(tmp, "net.pt")
        torch.jit.script(mod.Net().eval()).save(pt)
        in_spec = TensorsSpec.of(TensorSpec((1, 64, 64, 3), DType.FLOAT32))
        runs = (("torchscript_auto", dict(model=pt, input_spec=in_spec), 1e-6),
                ("get_model_torch", dict(framework="torch", model=script), 0.0),
                ("custom_auto", dict(model=script), 0.0))
        for name, kw, rel in runs:
            with SingleShot(device=dev, **kw) as s:
                (got,) = s.invoke(x)
                fw = s.props.framework
            err = (got - want).abs().max().item()
            if got.device.type != dev.type or not err <= rel * want.abs().max().item():
                raise AssertionError(f"script_models {name}: on {got.device}, err {err}")
            out[name] = {"framework": fw, "device": str(got.device), "max_abs_err": err,
                         "tolerance_rel": rel}
    return out


def model_sources_phases(torch, np, dev, parse_pipeline, ik):
    """The model_sources group: vit_labeling, kws_audio, tflite_program,
    script_models."""
    t0 = time.perf_counter()
    vit = vit_labeling_phase(torch, np, dev, parse_pipeline, ik)
    emit(vit)
    emit(kws_audio_phase(torch, np, dev, parse_pipeline))
    tfl = tflite_program_phase(torch, np, dev, parse_pipeline, ik)
    emit(tfl)
    emit(script_models_phase(torch, np, dev))
    return {"k1_launches": {"vit_labeling": vit["k1_launches"],
                            "tflite_program": tfl["k1_launches"]},
            "seconds": time.perf_counter() - t0}


# -- the faults group (ROADMAP A.6a) ---------------------------------------------
#
# labeling-720p at full width, 64 frames a run, under the fault machinery:
# the device circuit around its CUDA graphs, the OOM ladder, replicas in the
# filter and in the plane, and the warm restart. The fakes are deterministic,
# so every counter has one right value; tests/test_torch_device_faults.py
# holds the same descriptions' counters equal to the JAX package's on the CPU.
FAULTS_FRAMES = 64
FAULTS_PROBE_EVERY = 16
FAULTS_FIRST_N = 2
# every element named: a snapshot's nodes are keyed by name, so a restored
# pipeline finds its segment under the name the saved one had
FAULTS_PIPELINE = (
    "videotestsrc name=src pattern=gradient width=1280 height=720 num-frames={n} ! "
    "tensor_converter name=conv ! tensor_transform name=resize mode=resize option=224:224 ! "
    "{faulty}tensor_filter name=f framework=torch model=zoo:mobilenet_v2 {props}! "
    "{decode}tensor_sink name=out"
)
COMPILE_FAULTY = ("tensor_filter name=x framework=faulty custom=traceable:true,compile_fail:true,"
                  f"compile_fail_first_n:{FAULTS_FIRST_N} ! ")
OOM_FAULTY = "tensor_filter name=x framework=faulty custom=traceable:true,oom_above_rows:2 ! "
OOM_PROPS = "batching=true max-batch=8 batch-timeout-ms=200 "
LOST_FAULTY = ("tensor_filter name=x framework=faulty replicas=2 "
               "custom=device_lost_at:9,only_replica:0 ! ")
FAULTS_PLANE = " ".join(
    f"videotestsrc pattern=gradient width=1280 height=720 num-frames={{n}} ! tensor_converter ! "
    "tensor_transform mode=resize option=224:224 ! "
    f"tensor_filter name=f{k} framework=torch model=zoo:mobilenet_v2 plane={{plane}} "
    "plane-mode=replicas plane-devices=2 ! tensor_decoder mode=image_labeling ! "
    f"tensor_sink name=out{k}" for k in range(2)
)


def faults_desc(n=FAULTS_FRAMES, faulty="", props="", decode=True):
    return FAULTS_PIPELINE.format(
        n=n, faulty=faulty, props=props,
        decode="tensor_decoder name=dec mode=image_labeling ! " if decode else "")


def faults_executor(parse_pipeline, dev, desc, env=None):
    """The description's pipeline, plan and (not started) executor; ``env``
    holds the ``[executor]`` knobs the plan resolves."""
    from nnstreamer_tpu_torch.pipeline.executor import Executor

    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        p = parse_pipeline(desc, device=dev)
        plan = p.compile_plan()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return p, plan, Executor(plan)


def faults_finish(ex, what, timeout=600):
    """Wait for EOS and stop; a node's error fails the phase."""
    done = ex.wait(timeout)
    ex.stop()
    if ex.errors or not done:
        raise AssertionError(f"faults: {what}: {ex.errors or 'no EOS'}")


def faults_labels(p):
    return [int(f.tensors[0][0]) for f in p["out"].frames]


def steady_fps(p, sink="out", skip=16):
    """Frames a second at the sink past the first ``skip`` (the build, the
    captures and the OOM ladder's first windows stay out)."""
    t = [f.meta["render_t"] for f in p[sink].frames]
    return (len(t) - 1 - skip) / (t[-1] - t[skip])


def faults_segment(plan, op):
    return next(s for s in plan.segments if op in [o.name for o in s.ops])


def faults_run(parse_pipeline, dev, desc, what, env=None):
    """``desc`` to EOS on the card → (pipeline, executor, wall seconds)."""
    p, _, ex = faults_executor(parse_pipeline, dev, desc, env)
    t0 = time.perf_counter()
    ex.start()
    faults_finish(ex, what)
    return p, ex, time.perf_counter() - t0


def compile_fallback_phase(torch, np, dev, parse_pipeline, ik, plain_labels, plain_logits):
    """A build that fails twice, then recovers: the circuit opens at the
    first frame (where the JAX package compiles), every open frame runs the
    segment eagerly on the card (K1 launched once a frame, no replay), the
    probes every FAULTS_PROBE_EVERY frames rebuild, the second closes it."""
    from nnstreamer_tpu_torch import capture as cap_mod

    env = {"NNS_TPU_EXECUTOR_DEVICE_PROBE_EVERY": str(FAULTS_PROBE_EVERY)}
    p, plan, ex = faults_executor(parse_pipeline, dev, faults_desc(faulty=COMPILE_FAULTY),
                                  env)
    seg = faults_segment(plan, "x")
    fake = p["x"].backend  # its build count outlives the filter's stop
    rec = []

    def recorded(kind, fn):
        def call(frame):
            k0, r0 = ik.crop_resize_launches.count, cap_mod.graph_replays.count
            ok = False
            try:
                out = fn(frame)
                ok = True
                return out
            finally:
                rec.append((kind, ok, ik.crop_resize_launches.count - k0,
                            cap_mod.graph_replays.count - r0))
        return call

    seg.process = recorded("replay", seg.process)
    seg.process_eager = recorded("eager", seg.process_eager)
    ik.crop_resize_launches.reset()
    cap_mod.graph_replays.reset()
    t0 = time.perf_counter()
    ex.start()
    faults_finish(ex, "compile_fallback")
    wall = time.perf_counter() - t0
    k1 = ik.crop_resize_launches.count
    replays = cap_mod.graph_replays.count
    node = next(n for n in ex.nodes if n.name == seg.name)
    circ = node.device_circuit.snapshot()
    eager = [r for r in rec if r[0] == "eager"]
    served = [r for r in rec if r[0] == "replay" and r[1]]
    failed = [r for r in rec if r[0] == "replay" and not r[1]]
    n_open = FAULTS_FIRST_N * FAULTS_PROBE_EVERY
    want = {"open": False, "faults": FAULTS_FIRST_N, "kinds": {"compile": FAULTS_FIRST_N},
            "opens": 1, "closes": 1, "eager_invokes": n_open}
    if circ != want:
        raise AssertionError(f"compile_fallback: circuit {circ}, want {want}")
    if (len(eager), len(served), len(failed)) != (n_open, FAULTS_FRAMES - n_open,
                                                  FAULTS_FIRST_N - 1):
        raise AssertionError(f"compile_fallback: {len(eager)} eager, {len(served)} replayed, "
                             f"{len(failed)} failed probes")
    if any(r[2:] != (1, 0) for r in eager) or any(r[2:] != (1, 1) for r in served):
        raise AssertionError("compile_fallback: an eager frame did not launch K1 once without "
                             "a replay, or a replayed frame was not one replay with K1 in it")
    if [r[0] for r in rec if r[1]] != ["eager"] * n_open + ["replay"] * (FAULTS_FRAMES - n_open):
        raise AssertionError("compile_fallback: the circuit closed at the wrong frame")
    if (k1, replays) != (FAULTS_FRAMES, FAULTS_FRAMES - n_open):
        raise AssertionError(f"compile_fallback: K1 {k1}, replays {replays}")
    if fake.traces != FAULTS_FIRST_N + 1:
        raise AssertionError(f"compile_fallback: {fake.traces} builds")
    labels = faults_labels(p)
    if labels != plain_labels:
        raise AssertionError("compile_fallback: labels differ from the unfaulted run's")
    render = [f.meta["render_t"] for f in p["out"].frames]
    fps_open = (n_open - 1) / (render[n_open - 1] - render[0])
    fps_closed = (FAULTS_FRAMES - n_open - 2) / (render[-1] - render[n_open + 1])
    lp, lex, _ = faults_run(parse_pipeline, dev, faults_desc(faulty=COMPILE_FAULTY, decode=False),
                            "compile_fallback logits", env)
    logits = np.stack([np.asarray(t) for t in out_tensors(lp)])
    if not np.array_equal(logits, plain_logits):
        raise AssertionError("compile_fallback: logits differ from the unfaulted run's")
    return {"phase": "compile_fallback", "card": gpu_info(), "frames": FAULTS_FRAMES,
            "probe_every": FAULTS_PROBE_EVERY, "compile_fail_first_n": FAULTS_FIRST_N,
            "circuit": circ, "eager_frames": len(eager), "replayed_frames": len(served),
            "failed_probes": len(failed), "k1_launches": k1, "graph_replays": replays,
            "builds": fake.traces, "labels_equal": True, "logits_bit_equal": True,
            "fps_open": fps_open, "fps_closed": fps_closed, "wall_s": wall}


def bucket_replays(seg):
    """Wrap the segment's graph replays to record each replayed program's
    bucket (0 = the per-frame program)."""
    buckets = []
    inner = seg.programs._replay

    def replay(prog):
        buckets.append(next(k[1] for k, v in seg.programs._cache.items() if v is prog))
        inner(prog)

    seg.programs._replay = replay
    return buckets


def oom_ladder_phase(torch, np, dev, parse_pipeline, plain_labels):
    """max-batch=8 over a device that fits 2 rows: the governor's cap
    settles at 2 and every frame is delivered; oom-policy=stop stops with
    DeviceOOMError; a real allocation past the free memory raises
    torch.OutOfMemoryError, classified oom, and the next run completes."""
    from nnstreamer_tpu_torch.pipeline.device_faults import DeviceOOMError, classify_device_fault

    desc = faults_desc(faulty=OOM_FAULTY, props=OOM_PROPS)
    p, plan, ex = faults_executor(parse_pipeline, dev, desc)
    seg = faults_segment(plan, "x")
    buckets = bucket_replays(seg)
    t0 = time.perf_counter()
    ex.start()
    faults_finish(ex, "oom_ladder")
    wall = time.perf_counter() - t0
    row = ex.stats()[seg.name]
    if row["batch_ceiling"] != 2 or row["frames"] != FAULTS_FRAMES or row["oom_events"] < 1:
        raise AssertionError(f"oom_ladder: {row}")
    # the same segment and windows with a device that fits every bucket
    up, uex, _ = faults_run(parse_pipeline, dev, faults_desc(
        faulty="tensor_filter name=x framework=faulty custom=traceable:true ! ", props=OOM_PROPS),
        "oom_ladder uncapped")
    if faults_labels(up) != plain_labels or "oom_events" in uex.stats()[seg.name]:
        raise AssertionError("oom_ladder: the uncapped run differs")
    if faults_labels(p) != plain_labels:
        raise AssertionError("oom_ladder: labels differ from the unbatched run's")
    if max(buckets, default=0) > 2:
        raise AssertionError(f"oom_ladder: a bucket above the cap replayed: {sorted(set(buckets))}")
    _, _, stop_ex = faults_executor(parse_pipeline, dev, faults_desc(
        faulty=OOM_FAULTY, props=OOM_PROPS + "oom-policy=stop device-fallback=false "))
    stop_ex.start()
    stop_ex.wait(600)
    stop_ex.stop()
    if not (len(stop_ex.errors) == 1 and isinstance(stop_ex.errors[0], DeviceOOMError)):
        raise AssertionError(f"oom_ladder: oom-policy=stop ended with {stop_ex.errors}")
    # the allocator's cached blocks go back first, so the free bytes are all
    # there is: one request past them cannot be met
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    try:
        torch.empty(free + 2**30, dtype=torch.uint8, device=dev)
    except torch.OutOfMemoryError as exc:
        real_kind = classify_device_fault(exc)
    else:
        raise AssertionError("oom_ladder: an allocation past the free memory succeeded")
    if real_kind != "oom":
        raise AssertionError(f"oom_ladder: a real OOM classified {real_kind}")
    after, _, _ = faults_run(parse_pipeline, dev, faults_desc(), "labeling after a real OOM")
    if faults_labels(after) != plain_labels:
        raise AssertionError("oom_ladder: the run after a real OOM gave other labels")
    return {"phase": "oom_ladder", "card": gpu_info(), "frames": FAULTS_FRAMES,
            "batch_ceiling": row["batch_ceiling"], "oom_events": row["oom_events"],
            "avg_batch_size": row["avg_batch_size"], "buckets_replayed": sorted(set(buckets)),
            "replays": len(buckets), "oom_policy_stop": "DeviceOOMError",
            "real_oom_requested_bytes": free + 2**30, "real_oom_kind": real_kind,
            "total_bytes": total, "capped_fps": FAULTS_FRAMES / wall,
            "capped_steady_fps": steady_fps(p), "uncapped_steady_fps": steady_fps(up),
            "uncapped_avg_batch_size": uex.stats()[seg.name]["avg_batch_size"], "wall_s": wall}


def filter_replicas_phase(torch, np, dev, parse_pipeline, plain_labels, plain_logits):
    """replicas=2 replica-devices=0,0: logits bit for bit the one instance's,
    the invokes split; a replica that loses its device (typed, on replica
    0 from its 9th invoke) is benched with the accounting the same run has
    on the CPU, and every frame is delivered."""
    rp, rex, wall = faults_run(parse_pipeline, dev,
                               faults_desc(props="replicas=2 replica-devices=0,0 ", decode=False),
                               "filter_replicas")
    logits = np.stack([np.asarray(t) for t in out_tensors(rp)])
    if not np.array_equal(logits, plain_logits):
        raise AssertionError("filter_replicas: logits differ from one instance's")
    served = rex.stats()["f"]["rep_served"]
    if served != [FAULTS_FRAMES // 2] * 2:
        raise AssertionError(f"filter_replicas: invokes {served}")
    if [int(np.argmax(v)) for v in logits] != plain_labels:
        raise AssertionError("filter_replicas: labels differ")
    lp, lex, lwall = faults_run(parse_pipeline, dev, faults_desc(faulty=LOST_FAULTY),
                                "filter_replicas failover")
    row = {k: v for k, v in lex.stats()["x"].items() if k.startswith("rep_")}
    cpu = parse_pipeline(f"tensorsrc dimensions=4 num-frames={FAULTS_FRAMES} ! "
                         f"{LOST_FAULTY}tensor_sink", device="cpu")
    want = {k: v for k, v in cpu.run(timeout=60).stats()["x"].items() if k.startswith("rep_")}
    if row != want or row["rep_healthy"] != 1 or faults_labels(lp) != plain_labels:
        raise AssertionError(f"filter_replicas: failover {row}, on the CPU {want}")
    return {"phase": "filter_replicas", "card": gpu_info(), "frames": FAULTS_FRAMES,
            "replica_served": served, "logits_bit_equal": True, "fps": FAULTS_FRAMES / wall,
            "steady_fps": steady_fps(rp),
            "failover": row, "failover_fps": FAULTS_FRAMES / lwall}


def plane_replicas_run(torch, dev, parse_pipeline, plane, lose=None):
    """Two streams on one replicated plane: each replica's windows recorded,
    replica ``lose`` raising a typed DeviceLostError from its second
    dispatch on."""
    from nnstreamer_tpu_torch.pipeline.device_faults import DeviceLostError
    from nnstreamer_tpu_torch.pipeline.executor import Executor
    from nnstreamer_tpu_torch.serving_plane import plane as plane_mod

    p = parse_pipeline(FAULTS_PLANE.format(n=FAULTS_FRAMES, plane=plane), device=dev)
    p.negotiate()
    pl = plane_mod.get(plane)
    prog = pl._ensure_program()
    rows = [[] for _ in prog.programs]
    for i, rp in enumerate(prog.programs):
        inner = rp.invoke

        def invoke(windows, i=i, inner=inner):
            if i == lose and len(rows[i]) >= 1:
                raise DeviceLostError(f"replica {i} lost")
            outs = inner(windows)
            rows[i].append((list(windows), outs))
            return outs

        rp.invoke = invoke
    replays0 = [rp.programs.replays for rp in prog.programs]
    ex = Executor(p.compile_plan())
    t0 = time.perf_counter()
    ex.start()
    done = ex.wait(600)
    wall = time.perf_counter() - t0
    stats = pl.stats()
    replays = [rp.programs.replays - r0 for rp, r0 in zip(prog.programs, replays0)]
    checked = 0
    for windows, outs in (r for rep in rows for r in rep):
        for w, o in zip(windows, outs):
            if not torch.equal(o[0], prog.programs[0].invoke_one(w)[0]):
                raise AssertionError("plane_replicas: a batched row differs from the frame alone")
            checked += 1
    ex.stop()
    if ex.errors or not done:
        raise AssertionError(f"plane_replicas: {ex.errors or 'no EOS'}")
    return p, stats, replays, [len(r) for r in rows], checked, wall


def plane_replicas_phase(torch, np, dev, parse_pipeline, plain_labels):
    """plane-mode=replicas plane-devices=2 on the one card: rows bit for bit
    the frame alone, one replay a dispatch, windows on both replicas; with
    replica 0 lost, every window fails over whole and each stream keeps
    its order."""
    p, stats, replays, windows, checked, wall = plane_replicas_run(
        torch, dev, parse_pipeline, "faults-rep")
    for k in range(2):
        if [int(f.tensors[0][0]) for f in p[f"out{k}"].frames] != plain_labels:
            raise AssertionError(f"plane_replicas: stream {k} labels differ")
    if sum(replays) != stats["dispatches"] or min(windows) < 1:
        raise AssertionError(f"plane_replicas: replays {replays}, windows {windows}, "
                             f"dispatches {stats['dispatches']}")
    fp, fstats, freplays, fwindows, _, fwall = plane_replicas_run(
        torch, dev, parse_pipeline, "faults-rep-lost", lose=0)
    for k in range(2):
        if [int(f.tensors[0][0]) for f in fp[f"out{k}"].frames] != plain_labels:
            raise AssertionError(f"plane_replicas failover: stream {k} out of order or lost")
    reps = fstats["replicas"]
    if reps["healthy"] != 1 or reps["failovers"] < 1 or fwindows[0] != 1:
        raise AssertionError(f"plane_replicas failover: {reps}, windows {fwindows}")
    return {"phase": "plane_replicas", "card": gpu_info(), "frames_a_stream": FAULTS_FRAMES,
            "dispatches": stats["dispatches"], "replica_replays": replays,
            "replica_windows": windows, "rows_checked": checked,
            "avg_batch": stats["avg_batch"], "fps_both": 2 * FAULTS_FRAMES / wall,
            "steady_fps": [steady_fps(p, f"out{k}") for k in range(2)],
            "failover": reps, "failover_windows": fwindows,
            "failover_fps_both": 2 * FAULTS_FRAMES / fwall}


def warm_restart_phase(torch, np, dev, parse_pipeline, plain_labels):
    """The OOM-ladder run drained after 32 frames, its snapshot saved, a new
    executor restored from the file: the remembered cap of 2 keeps every
    replay at bucket 2 or below, and the frames add up to 64; then an
    in-place drain / resume delivers every frame."""
    from nnstreamer_tpu_torch.pipeline.executor import Executor

    def desc(n):
        # shallow inboxes (the segment's and the sink's) hold the source back,
        # so most frames are still to come when the drain parks it: the sink
        # waits on the card, and its inbox passes that wait back upstream
        return faults_desc(n=n, faulty=OOM_FAULTY, props=OOM_PROPS).replace(
            "name=conv", "name=conv queue-size=8").replace("name=out", "name=out queue-size=8")

    p, plan, ex = faults_executor(parse_pipeline, dev, desc(FAULTS_FRAMES))
    name = faults_segment(plan, "x").name
    ex.start()
    deadline = time.monotonic() + 120
    while len(p["out"].frames) < FAULTS_FRAMES // 2 and time.monotonic() < deadline:
        time.sleep(0.002)
    if not ex.drain(timeout=60):
        raise AssertionError(f"warm_restart: drain did not settle ({ex.errors})")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "faults.json")
        snap = ex.save_snapshot(path)
        first = len(p["out"].frames)
        ex.stop()
        gov = snap["nodes"][name]["governor"]
        if gov["ceiling"] != 2:
            raise AssertionError(f"warm_restart: snapshot governor {gov}")
        p2, plan2, ex2 = faults_executor(parse_pipeline, dev, desc(FAULTS_FRAMES - first))
        buckets = bucket_replays(faults_segment(plan2, "x"))
        ex2.resume(Executor.read_snapshot(path))
    ex2.start()
    faults_finish(ex2, "warm_restart")
    row = ex2.stats()[name]
    second = len(p2["out"].frames)
    if (first + second != FAULTS_FRAMES or not second or max(buckets, default=0) > 2
            or row["oom_events"] != gov["ooms"] or ex2.totals()["balance"] != 0):
        raise AssertionError(f"warm_restart: {first} + {second} frames, buckets "
                             f"{sorted(set(buckets))}, {row}, {ex2.totals()}")
    if faults_labels(p)[:first] != plain_labels[:first] or \
            faults_labels(p2) != plain_labels[:second]:
        raise AssertionError("warm_restart: labels differ")
    p3, _, ex3 = faults_executor(parse_pipeline, dev,
                                 faults_desc().replace("name=conv", "name=conv queue-size=8"))
    ex3.start()
    deadline = time.monotonic() + 120
    while len(p3["out"].frames) < FAULTS_FRAMES // 4 and time.monotonic() < deadline:
        time.sleep(0.002)
    drained = ex3.drain(timeout=60)
    mid = len(p3["out"].frames)
    ex3.resume()
    faults_finish(ex3, "in-place drain")
    if not drained or faults_labels(p3) != plain_labels:
        raise AssertionError("warm_restart: the in-place drain / resume lost frames")
    return {"phase": "warm_restart", "card": gpu_info(), "frames_before": first,
            "frames_after": second, "restored_governor": gov,
            "buckets_replayed_after": sorted(set(buckets)), "oom_events_after": row["oom_events"],
            "in_place_drained_at": mid, "totals": ex2.totals()}


def faults_phases(torch, np, dev, parse_pipeline, ik):
    """The faults group: compile_fallback, oom_ladder, filter_replicas,
    plane_replicas, warm_restart, after an unfaulted labeling run (labels)
    and logits run, the oracle of every check."""
    t0 = time.perf_counter()
    plain, _, plain_wall = faults_run(parse_pipeline, dev, faults_desc(), "unfaulted labels")
    plain_labels = faults_labels(plain)
    lp, _, _ = faults_run(parse_pipeline, dev, faults_desc(decode=False), "unfaulted logits")
    plain_logits = np.stack([np.asarray(t) for t in out_tensors(lp)])
    comp = compile_fallback_phase(torch, np, dev, parse_pipeline, ik, plain_labels, plain_logits)
    comp["unfaulted_fps"] = FAULTS_FRAMES / plain_wall
    comp["unfaulted_steady_fps"] = steady_fps(plain)
    emit(comp)
    emit(oom_ladder_phase(torch, np, dev, parse_pipeline, plain_labels))
    emit(filter_replicas_phase(torch, np, dev, parse_pipeline, plain_labels, plain_logits))
    emit(plane_replicas_phase(torch, np, dev, parse_pipeline, plain_labels))
    emit(warm_restart_phase(torch, np, dev, parse_pipeline, plain_labels))
    return {"k1_launches": comp["k1_launches"], "seconds": time.perf_counter() - t0}



# -- the observe group (ROADMAP A.6b): chains, the frame ring, observability --

OBS_FRAMES = 64
OBS_UNROLL = 4
OBS_W, OBS_H = 1280, 720
OBS_PIPELINE = (
    "videotestsrc name=src pattern=gradient width={w} height={h} num-frames={n} ! "
    "tensor_converter name=conv queue-size=128 ! "
    "tensor_transform name=resize mode=resize option=224:224 ! queue name=q ! "
    "tensor_filter name=f framework=torch model=zoo:mobilenet_v2 ! "
    "{decode}tensor_sink name=out"
)


def observe_desc(n=OBS_FRAMES, decode=True):
    return OBS_PIPELINE.format(
        n=n, w=OBS_W, h=OBS_H,
        decode="tensor_decoder name=dec mode=image_labeling ! " if decode else "")


def observe_run(parse_pipeline, dev, env, n=OBS_FRAMES, decode=True, saturate=True):
    """The observe pipeline to EOS on the card with ``env``'s
    ``[executor]`` knobs set while it is planned, built and run →
    (pipeline, executor, wall s). ``saturate``: the node after the source
    starts once the source has queued all ``n`` frames (and its EOS) in
    its inbox, so a chain's windows are all full."""
    from nnstreamer_tpu_torch.pipeline.executor import Executor

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        p = parse_pipeline(observe_desc(n, decode), device=dev)
        ex = Executor(p.compile_plan())
        head = ex._node_of[p["conv"]]
        src = ex._node_of[p["src"]]
        start_head = head.thread.start
        if saturate:
            head.thread.start = lambda: None
        t0 = time.perf_counter()
        ex.start()
        if saturate:
            deadline = time.monotonic() + 600
            while src.thread.is_alive() and time.monotonic() < deadline:
                time.sleep(0.002)
            if head.inboxes[0].qsize() != n + 1:
                raise AssertionError(f"observe: {head.inboxes[0].qsize()} queued, want {n + 1}")
            start_head()
        faults_finish(ex, "observe run")
        wall = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return p, ex, wall


def node_p50s(ex):
    """Per node: the p50 of its invokes' host time (ms; a window's for a
    batched or chain node), from the latency histograms."""
    return {k: v.get("latency_p50_ms") for k, v in ex.stats().items()}


def chain_program_phase(torch, np, dev, parse_pipeline, ik):
    """34: chain-mode auto against off, then a fault that latches the
    per-node path (module docstring)."""
    from nnstreamer_tpu_torch import capture as cap_mod
    from nnstreamer_tpu_torch.obs import metrics as obs_metrics
    from nnstreamer_tpu_torch.pipeline.chain_program import ChainProgram
    from nnstreamer_tpu_torch.pipeline.device_faults import DeviceFaultError
    from nnstreamer_tpu_torch.pipeline.executor import _ChainNode

    n = OBS_FRAMES
    runs = {}
    obs_metrics.enable()
    try:
        for mode in ("off", "auto"):
            env = {"NNS_TPU_EXECUTOR_CHAIN_MODE": mode,
                   "NNS_TPU_EXECUTOR_CHAIN_UNROLL": str(OBS_UNROLL)}
            observe_run(parse_pipeline, dev, env, n=8)  # warm: cuDNN, allocator
            ik.crop_resize_launches.reset()
            cap_mod.graph_replays.reset()
            p, ex, wall = observe_run(parse_pipeline, dev, env)
            replays, k1 = cap_mod.graph_replays.count, ik.crop_resize_launches.count
            transfer = ex.totals()["transfer"]  # the tally is process-wide: read it now
            lp, _, _ = observe_run(parse_pipeline, dev, env, decode=False)
            chains = [x for x in ex.nodes if isinstance(x, _ChainNode)]
            runs[mode] = {
                "labels": faults_labels(p), "replays": replays, "k1": k1, "wall": wall,
                "logits": np.stack([np.asarray(t) for t in out_tensors(lp)]),
                "chain": chains[0] if chains else None, "ex": ex,
                "p50": node_p50s(ex), "steady_fps": steady_fps(p), "transfer": transfer}
    finally:
        obs_metrics.disable()
    on, off = runs["auto"], runs["off"]
    if off["chain"] is not None or on["chain"] is None:
        raise AssertionError("chain_program: chain-mode=off grew a chain node or auto did not")
    ch = on["chain"]
    if len(ch.chain.segments) != 2 or ch.program.unroll != OBS_UNROLL:
        raise AssertionError(f"chain_program: chain {ch.name} unroll {ch.program.unroll}")
    if on["labels"] != off["labels"] or len(on["labels"]) != n:
        raise AssertionError("chain_program: labels differ between chain-mode auto and off")
    if not np.array_equal(on["logits"], off["logits"]):
        raise AssertionError("chain_program: logits not bit-equal between auto and off")
    want_chain, want_off = n // OBS_UNROLL, 2 * n
    if on["replays"] != want_chain or off["replays"] != want_off:
        raise AssertionError(f"chain_program: replays {on['replays']} (chain) / {off['replays']} "
                             f"(off), want {want_chain} / {want_off}")
    if on["k1"] != n or off["k1"] != n:
        raise AssertionError(f"chain_program: K1 {on['k1']} / {off['k1']} for {n} frames")
    row = on["ex"].stats()[ch.name]
    if row["chain_fallback"] != 0 or row["chain_launches"] != want_chain or not row["captured"]:
        raise AssertionError(f"chain_program: chain row {row}")
    if any(seg.n_traces for seg in ch.chain.segments):
        raise AssertionError("chain_program: a member segment's graph was built in the chain run")
    # no interior bytes: the chain moves what the per-node path moves at its ends
    if on["transfer"] != off["transfer"] or on["transfer"]["d2h"] != 8 * n:
        raise AssertionError(f"chain_program: transfer {on['transfer']} (chain) against "
                             f"{off['transfer']} (off)")

    # a device fault at the third window latches the per-node path
    real = ChainProgram.process_window
    state = {"calls": 0}

    def faulty(self, frames):
        state["calls"] += 1
        if state["calls"] == 3:
            raise DeviceFaultError("injected chain fault")
        return real(self, frames)

    ChainProgram.process_window = faulty
    try:
        env = {"NNS_TPU_EXECUTOR_CHAIN_MODE": "auto",
               "NNS_TPU_EXECUTOR_CHAIN_UNROLL": str(OBS_UNROLL)}
        ik.crop_resize_launches.reset()
        fp, fex, _ = observe_run(parse_pipeline, dev, env)
        fk1 = ik.crop_resize_launches.count
    finally:
        ChainProgram.process_window = real
    fnode = next(x for x in fex.nodes if isinstance(x, _ChainNode))
    frow = fex.stats()[fnode.name]
    served = n - 2 * OBS_UNROLL
    if not fnode.fallback_latched or frow["chain_fallback"] != served:
        raise AssertionError(f"chain_program: fault did not latch: {frow}")
    if faults_labels(fp) != off["labels"] or fk1 != n:
        raise AssertionError(f"chain_program: after the latch labels differ or K1 {fk1} != {n}")
    if not all(seg.captured for seg in fnode.chain.segments):
        raise AssertionError("chain_program: the per-node path did not replay the members' graphs")

    # per-node host time of routing-crop-720p, metrics on
    obs_metrics.enable()
    try:
        rp, rwall = run_routing(parse_pipeline, dev, routing_regions(np, OBS_FRAMES))
        routing_p50 = node_p50s(rp._executor)
    finally:
        obs_metrics.disable()
    return {
        "phase": "chain_program", "frames": n, "unroll": OBS_UNROLL, "chain": ch.name,
        "chain_replays": on["replays"], "segment_replays": off["replays"],
        "replays_per_frame": {"chain": on["replays"] / n, "off": off["replays"] / n},
        "k1_launches": {"chain": on["k1"], "off": off["k1"], "fault": fk1},
        "chain_fallback": row["chain_fallback"], "fault_chain_fallback": frow["chain_fallback"],
        "fault_fallback_windows": frow.get("chain_fallback_windows"),
        "labels_first4": on["labels"][:4],
        "fps": {"chain": n / on["wall"], "off": n / off["wall"]},
        "steady_fps": {"chain": on["steady_fps"], "off": off["steady_fps"]},
        "node_p50_ms": {"chain": on["p50"], "off": off["p50"], "routing": routing_p50},
        "routing_fps": OBS_FRAMES / rwall,
        "transfer": {"chain": on["transfer"], "off": off["transfer"]},
        "k1_total": on["k1"] + off["k1"] + fk1,
    }


def frame_ring_phase(torch, np, dev, parse_pipeline):
    """35: ring-depth 1 against 2 (module docstring)."""
    n = OBS_FRAMES
    out = {}
    for depth in (1, 2):
        env = {"NNS_TPU_EXECUTOR_CHAIN_MODE": "off", "NNS_TPU_EXECUTOR_RING_DEPTH": str(depth)}
        p, ex, wall = observe_run(parse_pipeline, dev, env, saturate=False)
        rings = {x.name: x._ring.depth for x in ex.nodes if x._ring is not None}
        out[depth] = {"labels": faults_labels(p), "rings": rings,
                      "transfer": ex.totals()["transfer"],
                      "pts": [f.pts for f in p["out"].frames], "fps": n / wall}
    a, b = out[1], out[2]
    if a["labels"] != b["labels"] or len(a["labels"]) != n:
        raise AssertionError("frame_ring: labels differ between ring-depth 1 and 2")
    for d in (1, 2):
        pts = out[d]["pts"]
        if pts != sorted(pts) or len(set(pts)) != n:
            raise AssertionError(f"frame_ring: depth {d} delivered out of order")
    if set(b["rings"].values()) - {1, 2} or 2 not in b["rings"].values() or set(
            a["rings"].values()) != {1}:
        raise AssertionError(f"frame_ring: rings {a['rings']} / {b['rings']}")
    dec_bytes = torch.empty((), dtype=torch.int64).element_size()  # the argmax, int64 on the card
    # the source's host frames are staged up on the card (on the CPU the
    # staging is a pass-through, so H2D is 0 there)
    frame_bytes = OBS_W * OBS_H * 3 if dev.type == "cuda" else 0
    for d in (1, 2):
        t = out[d]["transfer"]
        if t["d2h"] != n * dec_bytes or t["h2d"] != n * frame_bytes:
            raise AssertionError(f"frame_ring: depth {d} transfer {t}, want d2h {n * dec_bytes} "
                                 f"h2d {n * frame_bytes}")
    return {"phase": "frame_ring", "frames": n, "rings": {1: a["rings"], 2: b["rings"]},
            "transfer": {1: a["transfer"], 2: b["transfer"]},
            "d2h_per_frame": dec_bytes, "h2d_per_frame": frame_bytes,
            "fps": {1: a["fps"], 2: b["fps"]}}


def observe_cli_phase(np, dev, parse_pipeline):
    """36: the CLI's observability flags on the card (module docstring)."""
    n = 32
    with tempfile.TemporaryDirectory() as tmp:
        m, t, prof = (os.path.join(tmp, x) for x in ("m.json", "t.json", "prof"))
        cmd = [sys.executable, "-m", "nnstreamer_tpu_torch.cli", "-q", "--stats", "--metrics", m,
               "--trace", t, "--profile", prof, observe_desc(n)]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        if res.returncode != 0:
            raise AssertionError(f"observe_cli: rc {res.returncode}: {res.stderr[-2000:]}")
        stats = json.loads(res.stdout)
        with open(m) as f:
            doc = json.load(f)
        with open(t) as f:
            events = json.load(f)["traceEvents"]
        with open(os.path.join(prof, "device_profile.json")) as f:
            ptrace = f.read()
    nodes = [k for k in stats if k != "__pipeline__"]
    missing = [k for k in nodes if "latency_p50_ms" not in stats[k]]
    series = {x["labels"].get("element") for x in doc["metrics"]
              if x["name"] == "nns_element_latency_us"}
    if missing or set(nodes) - series:
        raise AssertionError(f"observe_cli: no latency row for {missing}, no series for "
                             f"{set(nodes) - series}")
    spans = {}
    for e in events:
        if e.get("ph") == "X":
            spans.setdefault(e["name"], []).append(e)
    for k in nodes:
        got = spans.get(k, [])
        batched = [e for e in got if e.get("cat") == "batch"]
        count = sum(e["args"]["batch"] for e in batched) if batched else len(got)
        if count != n:
            raise AssertionError(f"observe_cli: node {k} spans cover {count} frames, want {n}")
    if "crop_resize" not in ptrace:
        raise AssertionError("observe_cli: K1's kernel is not in the torch.profiler trace")
    chain = [k for k in nodes if " => " in k]
    return {"phase": "observe_cli", "frames": n, "nodes": nodes, "chain_nodes": chain,
            "node_p50_ms": {k: stats[k].get("latency_p50_ms") for k in nodes},
            "node_fps": {k: stats[k].get("fps") for k in nodes},
            "transfer": stats["__pipeline__"]["transfer"]}


def observe_phases(torch, np, dev, parse_pipeline, ik):
    """The observe group: chain_program, frame_ring, observe_cli."""
    t0 = time.perf_counter()
    chain = chain_program_phase(torch, np, dev, parse_pipeline, ik)
    emit(chain)
    print(f"observe: fps chain {chain['fps']['chain']:.1f} off {chain['fps']['off']:.1f}; "
          f"per-node p50 ms chain {chain['node_p50_ms']['chain']} "
          f"off {chain['node_p50_ms']['off']}", flush=True)
    emit(frame_ring_phase(torch, np, dev, parse_pipeline))
    cli = observe_cli_phase(np, dev, parse_pipeline)
    emit(cli)
    print(f"observe_cli: per-node p50 ms {cli['node_p50_ms']}", flush=True)
    return {"k1_launches": chain["k1_total"], "seconds": time.perf_counter() - t0}


# -- the edge group (ROADMAP A.7): query offload, a fleet, disagg, migration --

EDGE_FRAMES = 64
EDGE_W, EDGE_H = 1280, 720
EDGE_SERVER = (
    "tensor_query_serversrc name=qs {conn} id={sid} max-inflight=8 ! "
    "tensor_transform mode=resize option=224:224 ! "
    "tensor_filter framework=torch model=zoo:mobilenet_v2 ! "
    "tensor_decoder mode=image_labeling ! tensor_query_serversink id={sid}"
)
EDGE_CLIENT = (
    "videotestsrc pattern=gradient width={w} height={h} num-frames={n} ! tensor_converter ! "
    "tensor_query_client name={qc} {conn} timeout=120 ! tensor_sink name=out"
)
EDGE_LOCAL = (
    "videotestsrc pattern=gradient width={w} height={h} num-frames={n} ! tensor_converter ! "
    "tensor_transform mode=resize option=224:224 ! "
    "tensor_filter framework=torch model=zoo:mobilenet_v2 ! "
    "tensor_decoder mode=image_labeling ! tensor_sink name=out"
)
# Mistral-7B's published widths at 4 of its 32 layers: the handoff and the
# migration move one request's span whatever the depth
EDGE_LAYERS = 4
EDGE_LLM = dict(MISTRAL, n_layers=EDGE_LAYERS, seed=0)
EDGE_PROMPTS = (128, 256, 384, 512)  # tokens
EDGE_NEW = 32
EDGE_SERVE = dict(n_slots=4, max_len=1024, prompt_len=512)
# a decode peer too small for one span: a max-len below the longest prompt
EDGE_SMALL_PEER = dict(n_slots=1, max_len=128, prompt_len=64)
EDGE_PREFILL = (
    "appsrc name=src dimensions=512:1 types=int32 ! "
    'tensor_llm_serversink id={sid} custom="{opts}" attn-impl=pallas kv-layout=paged '
    "block-size=16 {serve} max-new-tokens={new} role=prefill decode-peers=127.0.0.1:{peer}/{pid} "
    "tensor_llm_serversrc name=ssrc id={sid} ! tensor_sink name=out"
)
EDGE_LLM_PEER = (
    "tensor_query_serversrc name=qs port=0 id=q{sid} ! "
    'tensor_llm_serversink id={sid} custom="{opts}" attn-impl=pallas kv-layout=paged '
    "block-size=16 {serve} max-new-tokens={new}{role} "
    "tensor_llm_serversrc name=ssrc id={sid} ! {tail}"
)
EDGE_MIGRATE_AT = 8  # generated tokens a request has when its server drains


def edge_server(parse_pipeline, dev, conn, sid):
    """A query server pipeline of the labeling slice, started: (pipeline,
    executor, its serversrc) once the serversrc listens."""
    p = parse_pipeline(EDGE_SERVER.format(conn=conn, sid=sid), device=dev)
    ex = p.start()
    deadline = time.monotonic() + 60
    while p["qs"].bound_port is None:
        if ex.errors or time.monotonic() > deadline:
            raise AssertionError(f"edge server {sid}: {ex.errors or 'never listened'}")
        time.sleep(0.01)
    return p, ex, p["qs"]


def edge_labels(p, sink="out"):
    return [int(f.tensors[0][0]) for f in p[sink].frames]


def query_labeling_phase(torch, np, dev, parse_pipeline, ik, local_labels):
    """The labeling slice split across the wire over TCP, SHM and HYBRID."""
    from nnstreamer_tpu_torch.edge.mqtt import MqttBroker
    from nnstreamer_tpu_torch.obs import metrics as obs_metrics
    from nnstreamer_tpu_torch.pipeline import transfer

    reg = obs_metrics.get()
    broker = MqttBroker()
    shm_port = 20000 + os.getpid() % 20000
    out = {"phase": "query_labeling", "frames": EDGE_FRAMES, "frame_bytes": EDGE_W * EDGE_H * 3}
    try:
        for ct, srv_conn, cli_conn, want_kind in (
            ("TCP", "port=0", "dest-port={port}", "native"),
            ("SHM", f"connect-type=SHM port={shm_port}",
             f"connect-type=SHM dest-port={shm_port}", "shm"),
            ("HYBRID", f"connect-type=HYBRID host=127.0.0.1 port={broker.port} topic=edge/hy",
             f"connect-type=HYBRID dest-host=127.0.0.1 dest-port={broker.port} topic=edge/hy",
             "native"),
        ):
            sid = f"edge{ct.lower()}"
            srv, sex, qs = edge_server(parse_pipeline, dev, srv_conn, sid)
            qc = f"qc_{ct.lower()}"
            try:
                ik.crop_resize_launches.reset()
                tally0 = transfer.tally.snapshot()
                cli = parse_pipeline(EDGE_CLIENT.format(
                    w=EDGE_W, h=EDGE_H, n=EDGE_FRAMES, qc=qc,
                    conn=cli_conn.format(port=qs.bound_port)), device=dev)
                t0 = time.perf_counter()
                cex = cli.run(timeout=600)
                wall = time.perf_counter() - t0
                k1 = ik.crop_resize_launches.count
                tally = transfer.tally.snapshot()
                sstats = sex.stats()["qs"]
            finally:
                srv.stop()
            if cex.errors or sex.errors:
                raise AssertionError(f"query_labeling {ct}: {cex.errors or sex.errors}")
            labels = edge_labels(cli)
            h2d = tally["h2d_bytes"] - tally0["h2d_bytes"]
            d2h = tally["d2h_bytes"] - tally0["d2h_bytes"]
            rtt = reg.find("nns_edge_rtt_us", element=qc)
            reqs = reg.find("nns_edge_requests_total", element=qc)
            nacks = sum(c.value for c in cli[qc]._nack_ctrs.values())
            row = {
                "labels_equal_local": labels == local_labels, "k1_launches": k1,
                "h2d_bytes": h2d, "d2h_bytes": d2h,
                "requests_total": reqs.value if reqs else None, "nacks": nacks,
                "client_transport": cli[qc].transport, "server_transport": qs.transport,
                "server_admitted": sstats.get("adm_admitted"),
                "fps": EDGE_FRAMES / wall, "wall_s": wall,
                # past the first reply: the server's graph is captured at its
                # first frame (a serversrc's stream is flexible until then)
                "steady_fps": steady_fps(cli, skip=1),
                # the histogram's count, min, mean and max are exact; its
                # quantiles are log-bucket estimates (64 samples)
                "rtt_samples": rtt.count, "rtt_us_min": rtt.min, "rtt_us_mean": rtt.mean,
                "rtt_us_max": rtt.max, "rtt_us_p50_est": rtt.quantile(0.5),
                "rtt_us_p99_est": rtt.quantile(0.99),
            }
            out[ct] = row
            bad = []
            if not row["labels_equal_local"]:
                bad.append(f"labels {labels[:4]} != local {local_labels[:4]}")
            if k1 != EDGE_FRAMES:
                bad.append(f"K1 launched {k1} times")
            if h2d != EDGE_FRAMES * EDGE_W * EDGE_H * 3:
                bad.append(f"H2D {h2d} B, want {EDGE_FRAMES} x {EDGE_W * EDGE_H * 3}")
            if d2h > EDGE_FRAMES * 64:
                bad.append(f"D2H {d2h} B: frame bytes came back through the card")
            if row["requests_total"] != EDGE_FRAMES or row["rtt_samples"] != EDGE_FRAMES or nacks:
                bad.append(f"requests {row['requests_total']}, RTT samples "
                           f"{row['rtt_samples']}, NACKs {nacks}")
            if row["client_transport"] != want_kind or (
                    ct != "SHM" and row["server_transport"] != "native"):
                bad.append(f"transports {row['client_transport']} / {row['server_transport']}")
            if bad:
                raise AssertionError(f"query_labeling {ct}: " + "; ".join(bad))
    finally:
        broker.close()
    return out


def query_fleet_phase(np, dev, parse_pipeline, ik, local_labels):
    """Two labeling servers behind one fleet client; the first drained over
    the wire (request_drain) once a quarter of the frames came back."""
    import threading

    from nnstreamer_tpu_torch.edge import query as equery

    a, aex, aqs = edge_server(parse_pipeline, dev, "port=0", "fleeta")
    b, bex, bqs = edge_server(parse_pipeline, dev, "port=0", "fleetb")
    try:
        ik.crop_resize_launches.reset()
        hosts = f"127.0.0.1:{aqs.bound_port},127.0.0.1:{bqs.bound_port}"
        cli = parse_pipeline(EDGE_CLIENT.format(
            w=EDGE_W, h=EDGE_H, n=EDGE_FRAMES, qc="qc_fleet",
            conn=f"hosts={hosts} retry-max=8 retry-backoff-ms=5"), device=dev)
        drained = threading.Event()

        def drain_at_quarter(frame):
            if len(cli["out"].frames) >= EDGE_FRAMES // 4 and not drained.is_set():
                drained.set()
                equery.request_drain("127.0.0.1", aqs.bound_port)

        cli["out"].connect("new-data", drain_at_quarter)
        t0 = time.perf_counter()
        cex = cli.run(timeout=600)
        wall = time.perf_counter() - t0
        k1 = ik.crop_resize_launches.count
        fleet = cli["qc_fleet"].fleet_stats()
        nacks = {r: c.value for r, c in cli["qc_fleet"]._nack_ctrs.items()}
        a_state, a_nacked = aqs.state, aqs.drain_nacked
        served = {k: v["served"] for k, v in fleet["endpoints"].items()}
    finally:
        a.stop()
        b.stop()
    if cex.errors or aex.errors or bex.errors:
        raise AssertionError(f"query_fleet: {cex.errors or aex.errors or bex.errors}")
    labels = edge_labels(cli)
    ids = [f.meta["frame_id"] for f in cli["out"].frames]
    row = {"phase": "query_fleet", "frames": len(labels), "labels_equal_local":
           labels == local_labels, "unique_frame_ids": len(set(ids)),
           "duplicate_replies": fleet["duplicate_replies"], "failovers": fleet["failovers"],
           "nacks": nacks, "drained_state": a_state, "drained_nacked": a_nacked,
           "served": served, "k1_launches": k1, "fps": EDGE_FRAMES / wall}
    if not (drained.is_set() and labels == local_labels and len(set(ids)) == EDGE_FRAMES
            and fleet["duplicate_replies"] == 0 and k1 == EDGE_FRAMES
            and a_state == "draining" and a_nacked >= 1 and nacks.get("draining", 0) >= 1
            and fleet["failovers"] >= 1):
        raise AssertionError(f"query_fleet: {row}")
    return row


def edge_opts():
    return ",".join(f"{k}:{v}" for k, v in EDGE_LLM.items())


def edge_serve(serve):
    return " ".join(f"{k.replace('_', '-')}={v}" for k, v in serve.items())


def edge_prompts(np):
    rng = np.random.default_rng(20)
    return [rng.integers(1, EDGE_LLM["vocab"], n).astype(np.int32) for n in EDGE_PROMPTS]


def solo_tokens(dev, prompts):
    """Each prompt alone through a private paged batcher on the same weights:
    the oracle of the handoff and of the migration."""
    from nnstreamer_tpu_torch.models import serving as sv
    from nnstreamer_tpu_torch.models import zoo

    m = zoo.get("transformer_lm", device=dev, **{k: str(v) for k, v in EDGE_LLM.items()})
    cb = sv.ContinuousBatcher(m.params, EDGE_LLM["n_heads"], **EDGE_SERVE, attn_impl="pallas",
                              device=dev, **PAGED)
    out = []
    for p in prompts:
        rid = cb.submit(p, EDGE_NEW)
        while cb.result(rid) is None:
            cb.step()
        out.append([int(t) for t in cb.result(rid)])
    return out


def llm_peer(parse_pipeline, dev, sid, role="", serve=None):
    """An LLM server pipeline that takes spans over its query serversrc's
    CTRL channel: a decode role parks its generations for the prefill peer
    (the serversink never sees one); a migration target emits them at a
    tensor_sink, their meta kept."""
    tail = f"tensor_query_serversink id=q{sid}" if role else "tensor_sink name=out"
    p = parse_pipeline(EDGE_LLM_PEER.format(
        sid=sid, opts=edge_opts(), serve=edge_serve(serve or EDGE_SERVE), new=EDGE_NEW,
        role=f" role={role}" if role else "", tail=tail), device=dev)
    ex = p.start()
    deadline = time.monotonic() + 120
    while p["qs"].bound_port is None:
        if ex.errors or time.monotonic() > deadline:
            raise AssertionError(f"llm peer {sid}: {ex.errors or 'never listened'}")
        time.sleep(0.01)
    return p, ex


def run_prefill(parse_pipeline, dev, sid, peer_port, peer_id, prompts):
    from nnstreamer_tpu_torch.tensors.frame import Frame

    pl = parse_pipeline(EDGE_PREFILL.format(
        sid=sid, opts=edge_opts(), serve=edge_serve(EDGE_SERVE), new=EDGE_NEW, peer=peer_port,
        pid=peer_id), device=dev)
    ex = pl.start()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        pl["src"].push(Frame((p,), meta={"req": i, "frame_id": f"edge-{sid}-{i}"}))
    pl["src"].end_of_stream()
    done = ex.wait(600)
    wall = time.perf_counter() - t0
    stats = pl["ssrc"].serving_stats()
    ex.stop()
    if ex.errors or not done:
        raise AssertionError(f"prefill {sid}: {ex.errors or 'no EOS within 600 s'}")
    got = {f.meta["req"]: [int(t) for t in f.tensors[0][0]] for f in pl["out"].frames}
    ids = {f.meta["req"]: f.meta["frame_id"] for f in pl["out"].frames}
    return got, ids, stats, wall, [n.thread for n in ex.nodes]


def disagg_phase(torch, np, dev, parse_pipeline, pa, prompts, solo):
    """Prefill and decode roles on one card over TCP loopback at Mistral-7B
    widths (4 layers, float32, paged): the handoff, then a too-small peer."""
    dp, dex = llm_peer(parse_pipeline, dev, "2", role="decode")
    try:
        pa.paged_decode_attention_launches.reset()
        got, ids, pstats, wall, pthreads = run_prefill(parse_pipeline, dev, "1",
                                                       dp["qs"].bound_port, 2, prompts)
        k4 = pa.paged_decode_attention_launches.count
        # the two servers share the process: each one's launches are those
        # its pipeline's threads added
        k4_peer = pa.paged_decode_attention_launches.count_on(n.thread for n in dex.nodes)
        k4_prefill = pa.paged_decode_attention_launches.count_on(pthreads)
        dstats = dp["ssrc"].serving_stats()
    finally:
        dp.stop()
    if dex.errors:
        raise AssertionError(f"disagg: decode peer {dex.errors}")
    spans = pstats["disagg"]["spans"]
    adopted = dstats.get("adopted", {"spans": 0, "bytes": 0, "seconds": 0.0})
    row = {
        "phase": "disagg", "model": EDGE_LLM, "prompts": list(EDGE_PROMPTS),
        "new_tokens": EDGE_NEW, "tokens_equal_solo": [got.get(i) == solo[i] for i in range(4)],
        "frame_ids_kept": all(ids[i] == f"edge-1-{i}" for i in ids),
        "outcomes": pstats["disagg"]["counts"],
        "decode_kv_prefill_chunks": dstats["kv_prefill_chunks"],
        "decode_kv_migrations_in": dstats["kv_migrations_in"],
        "k4_launches": k4, "prefill_steps": pstats["steps"], "decode_steps": dstats["steps"],
        "k4_launches_decode_peer": k4_peer, "k4_launches_prefill": k4_prefill,
        "decode_program_replays": replayed_programs(dstats, "disagg decode peer"),
        "span_bytes": spans["bytes"], "spans": spans["spans"],
        "extract_s": spans["extract_s"], "adopt_s": adopted["seconds"],
        "wire_s": spans["wire_s"] - adopted["seconds"],
        "extract_gb_s": spans["bytes"] / spans["extract_s"] / 1e9 if spans["extract_s"] else None,
        "adopt_gb_s": adopted["bytes"] / adopted["seconds"] / 1e9 if adopted["seconds"] else None,
        # an adopted request has no first token on the peer, so the SLO
        # ledger keeps no TPOT for it: a decode step's mean time instead (a
        # step emits one token for every request decoding on the peer)
        "decode_ms_per_step": (1e3 * dstats["tokens_per_step"] / dstats["decode_tok_s"]
                               if dstats["decode_tok_s"] else None),
        "wall_s": wall,
    }
    row["wire_gb_s"] = spans["bytes"] / row["wire_s"] / 1e9 if row["wire_s"] > 0 else None
    if not (all(row["tokens_equal_solo"]) and row["frame_ids_kept"]
            and row["outcomes"].get("handoff") == 4 and row["outcomes"].get("relayed") == 4
            and row["decode_kv_prefill_chunks"] == 0 and row["decode_kv_migrations_in"] == 4
            and k4_peer == EDGE_LAYERS * dstats["steps"]
            and k4_prefill == EDGE_LAYERS * pstats["steps"] and k4 == k4_peer + k4_prefill
            and dstats["steps"] > 0):
        raise AssertionError(f"disagg: {row}")
    torch.cuda.empty_cache()
    # a decode peer too small for one span: it refuses, the prefill server
    # adopts the span back and decodes it
    sp, sex = llm_peer(parse_pipeline, dev, "4", role="decode", serve=EDGE_SMALL_PEER)
    try:
        got_s, _, pstats_s, _, _ = run_prefill(parse_pipeline, dev, "3", sp["qs"].bound_port, 4,
                                            prompts[3:])
    finally:
        sp.stop()
    row["small_peer"] = {"outcomes": pstats_s["disagg"]["counts"],
                         "tokens_equal_solo": got_s.get(0) == solo[3]}
    # each refusal benches the peer briefly; a retry after it is refused again
    small = row["small_peer"]["outcomes"]
    if sex.errors or set(small) != {"local"} or not row["small_peer"]["tokens_equal_solo"]:
        raise AssertionError(f"disagg small peer: {sex.errors or row['small_peer']}")
    torch.cuda.empty_cache()
    return row


def migrate_phase(torch, np, dev, parse_pipeline, pa, prompts, solo):
    """drain(migrate_to=peer) on a paged server after 8 generated tokens: the
    requests continue on a peer pipeline and end as the uninterrupted run."""
    from nnstreamer_tpu_torch.elements.llm_serve import _LlmServer
    from nnstreamer_tpu_torch.tensors.frame import Frame

    pp, pex = llm_peer(parse_pipeline, dev, "6")
    src = _LlmServer(model="zoo:transformer_lm", options={k: str(v) for k, v in EDGE_LLM.items()},
                     **EDGE_SERVE, default_new=EDGE_NEW, device=dev, attn_impl="pallas",
                     kv_kw=dict(PAGED), srv_id="5")
    try:
        for i, p in enumerate(prompts):
            src.submit(Frame((p,), meta={"req": i, "frame_id": f"mig-{i}"}))
        rids = list(src._pending)
        while any(len(src.cb.partials(rids).get(r) or ()) < EDGE_MIGRATE_AT for r in rids):
            src.pump()
        at = {r: len(src.cb.partials(rids)[r]) for r in rids}
        pa.paged_decode_attention_launches.reset()
        t0 = time.perf_counter()
        summary = src.drain(migrate_to=f"127.0.0.1:{pp['qs'].bound_port}/6")
        drain_s = time.perf_counter() - t0
        deadline = time.monotonic() + 300
        while len(pp["out"].frames) < len(prompts):
            if pex.errors or time.monotonic() > deadline:
                raise AssertionError(f"migrate: {pex.errors or 'peer never finished'}")
            time.sleep(0.01)
        k4 = pa.paged_decode_attention_launches.count
        stats = pp["ssrc"].serving_stats()
    finally:
        src.release_plane()
        pp.stop()
    got = {f.meta["req"]: [int(t) for t in f.tensors[0][0]] for f in pp["out"].frames}
    row = {"phase": "migrate", "layers": EDGE_LAYERS, "tokens_at_drain": sorted(at.values()),
           "summary": summary, "tokens_equal_uninterrupted": [got.get(i) == solo[i]
                                                              for i in range(len(prompts))],
           "peer_kv_prefill_chunks": stats["kv_prefill_chunks"],
           "peer_kv_migrations_in": stats["kv_migrations_in"], "k4_launches": k4,
           "peer_steps": stats["steps"], "drain_s": drain_s,
           "adopted": stats.get("adopted")}
    if not (summary["migrated"] == len(prompts) and all(row["tokens_equal_uninterrupted"])
            and stats["kv_prefill_chunks"] == 0 and stats["kv_migrations_in"] == len(prompts)
            and k4 == EDGE_LAYERS * stats["steps"]):
        raise AssertionError(f"migrate: {row}")
    del src
    torch.cuda.empty_cache()
    return row


def edge_phases(torch, np, dev, parse_pipeline, ik):
    """The edge group: query_labeling, query_fleet, disagg, migrate."""
    from nnstreamer_tpu_torch.obs import metrics as obs_metrics
    from nnstreamer_tpu_torch.ops.kernels import paged_attention as pa

    t0 = time.perf_counter()
    was_on = obs_metrics.get() is not None
    obs_metrics.enable()
    try:
        local = parse_pipeline(EDGE_LOCAL.format(w=EDGE_W, h=EDGE_H, n=EDGE_FRAMES), device=dev)
        lex = local.run(timeout=600)
        if lex.errors:
            raise AssertionError(f"edge local labels: {lex.errors}")
        local_labels = edge_labels(local)
        ql = query_labeling_phase(torch, np, dev, parse_pipeline, ik, local_labels)
        emit(ql)
        print("query_labeling: " + "; ".join(
            f"{ct} fps {ql[ct]['fps']:.1f} (steady {ql[ct]['steady_fps']:.1f}) "
            f"rtt mean {ql[ct]['rtt_us_mean']:.0f} us, max {ql[ct]['rtt_us_max']:.0f} us "
            f"(p50 ~{ql[ct]['rtt_us_p50_est']:.0f}, p99 ~{ql[ct]['rtt_us_p99_est']:.0f})"
            for ct in ("TCP", "SHM", "HYBRID")), flush=True)
        fl = query_fleet_phase(np, dev, parse_pipeline, ik, local_labels)
        emit(fl)
    finally:
        if not was_on:
            obs_metrics.disable()
    t1 = time.perf_counter()
    prompts = edge_prompts(np)
    solo = solo_tokens(dev, prompts)
    torch.cuda.empty_cache()
    dg = disagg_phase(torch, np, dev, parse_pipeline, pa, prompts, solo)
    emit(dg)
    print(f"disagg: span {dg['span_bytes']} B, extract {dg['extract_gb_s']:.2f} GB/s, "
          f"wire {dg['wire_gb_s']:.2f} GB/s, adopt {dg['adopt_gb_s']:.2f} GB/s, "
          f"decode peer {dg['decode_ms_per_step']:.3f} ms a step", flush=True)
    mg = migrate_phase(torch, np, dev, parse_pipeline, pa, prompts, solo)
    emit(mg)
    return {"k1_launches": sum(ql[ct]["k1_launches"] for ct in ("TCP", "SHM", "HYBRID"))
            + fl["k1_launches"], "k4_launches": dg["k4_launches"] + mg["k4_launches"],
            "k4_launches_decode_peer": dg["k4_launches_decode_peer"],
            "labeling_s": t1 - t0, "seconds": time.perf_counter() - t0}


# -- the mesh group (ROADMAP A.8a) ------------------------------------------------
#
# The card's machine has one H100, so every mesh here has one position. Each
# check runs the mesh path itself (its own program, its own counters) and
# holds it against the unsharded path on the same inputs; a mesh of two
# raises, naming both counts.

MESH_FRAMES = 32  # the labeling runs
MESH_PIPELINE = PIPELINE.replace("model=zoo:mobilenet_v2 ", "model=zoo:mobilenet_v2 {props}")
MESH_PLANE_FRAMES = 48  # a stream, in the plane and placement runs
MESH_SERVE_REQUESTS = 8  # one full slot batch of the serving traffic
MESH_BOUND = "64G"  # [plane] memory_per_device of the placement check
MESH_TOO_FEW = r"needs? 2 devices, have 1"


def mesh_labels(parse_pipeline, dev, ik, props):
    """The labeling pipeline with ``props`` on its filter → (labels, K1
    launches, the filter's mesh program (None: unsharded; read before the
    run, whose end closes the backend), the model's forward calls)."""
    p = parse_pipeline(MESH_PIPELINE.format(n=MESH_FRAMES, live="", props=props), device=dev)
    p.negotiate()
    be = p["f"].backend
    mm = be.mesh_model
    if mm is not None and (be._fn is not mm or be.traceable_fn() is not None):
        raise AssertionError("mesh_filter: the filter does not run its mesh program")
    calls = []
    be.module.register_forward_pre_hook(lambda m, a: calls.append(1))
    ik.crop_resize_launches.reset()
    ex = p.run(timeout=600)
    if ex.errors:
        raise AssertionError(f"mesh_filter: {ex.errors}")
    labels = [int(f.tensors[0][0]) for f in p["out"].frames]
    return labels, ik.crop_resize_launches.count, mm, len(calls)


def mesh_filter_phase(torch, np, dev, parse_pipeline, ik):
    """(a) labeling with ``custom=mesh:dp1`` and with the accelerator's
    mesh clause against the unsharded filter: labels equal, K1 once a
    frame, the model run by the mesh program on the card every frame."""
    base, k1_base, _, _ = mesh_labels(parse_pipeline, dev, ik, "")
    out = {"phase": "mesh_filter", "frames": MESH_FRAMES, "labels_first4": base[:4],
           "k1_launches_unsharded": k1_base}
    for name, props in (("custom", 'custom="mesh:dp1" '),
                        ("accelerator", "accelerator=true:gpu:mesh=dp1 ")):
        labels, k1, mm, calls = mesh_labels(parse_pipeline, dev, ik, props)
        if mm is None:
            raise AssertionError(f"mesh_filter {name}: the filter has no mesh program")
        if mm.n_rows != 1 or mm.row_devices[0].type != torch.device(dev).type:
            raise AssertionError(f"mesh_filter {name}: rows {mm.row_devices}")
        if labels != base:
            raise AssertionError(f"mesh_filter {name}: labels differ from the unsharded filter's")
        if k1 != MESH_FRAMES or calls < MESH_FRAMES:
            raise AssertionError(f"mesh_filter {name}: K1 {k1}, model calls {calls} for "
                                 f"{MESH_FRAMES} frames")
        out[name] = {"k1_launches": k1, "model_calls": calls, "labels_equal": True,
                     "mesh": mm.mesh.shape, "row_device": str(mm.row_devices[0])}
    out["k1_launches"] = out["custom"]["k1_launches"] + out["accelerator"]["k1_launches"]
    return out


def mesh_plane_run(parse_pipeline, dev, ik, name, props):
    """Two 720p labeling streams through plane ``name`` with ``props`` →
    (labels by stream, the plane's stats, K1 launches)."""
    from nnstreamer_tpu_torch.serving_plane import plane as plane_mod

    p = parse_pipeline(PLANE_PIPELINE.format(n=MESH_PLANE_FRAMES, plane=f" plane={name}{props}",
                                             decode=PLANE_LABELS), device=dev)
    p.negotiate()
    ik.crop_resize_launches.reset()
    ex = p.start()
    done = ex.wait(600)
    stats = plane_mod.get(name).stats()
    ex.stop()
    if ex.errors or not done:
        raise AssertionError(f"mesh_plane {name}: {ex.errors or 'no EOS within 600 s'}")
    labels = [[int(f.tensors[0][0]) for f in p[f"out{k}"].frames] for k in range(2)]
    return labels, stats, ik.crop_resize_launches.count


def mesh_plane_phase(torch, np, dev, parse_pipeline, ik):
    """(b) two streams through plane-mode=shard plane-devices=1 against the
    single-device plane: labels equal, the shard program's stats."""
    single, s_stats, _ = mesh_plane_run(parse_pipeline, dev, ik, "chip-mesh-single", "")
    shard, stats, k1 = mesh_plane_run(parse_pipeline, dev, ik, "chip-mesh-shard",
                                      " plane-mode=shard plane-devices=1")
    if stats.get("program") != "shard" or stats.get("mesh_devices") != 1:
        raise AssertionError(f"mesh_plane: the plane's program {stats.get('program')}, "
                             f"mesh_devices {stats.get('mesh_devices')}")
    if shard != single or any(len(x) != MESH_PLANE_FRAMES for x in shard):
        raise AssertionError("mesh_plane: labels differ from the single-device plane's")
    if k1 != 2 * MESH_PLANE_FRAMES:
        raise AssertionError(f"mesh_plane: K1 launched {k1} times for 2 x {MESH_PLANE_FRAMES}")
    return {"phase": "mesh_plane", "frames_a_stream": MESH_PLANE_FRAMES, "k1_launches": k1,
            "labels_equal": True, "program": stats["program"],
            "mesh_devices": stats["mesh_devices"], "dispatches": stats["dispatches"],
            "avg_batch": stats["avg_batch"], "single_avg_batch": s_stats["avg_batch"],
            "labels": single}


def mesh_serving_phase(torch, np, dev, lm, prompts, plain, plain_profile):
    """(c) the slot-sharded batcher over a one-position mesh at the
    widths of ``lm``, on the serving traffic's first 8 prompts, against
    the unsharded batcher's tokens (``plain``, a drive_requests result on
    the same prompts): greedy tokens equal, K3 = layers x steps from the
    shard's own counter, every program the shard's CUDA graph; device time
    a step by class (K3's among them) over 8 profiled steps beside the
    unsharded batcher's (``plain_profile``, a decode_profile of 8 steps)."""
    from nnstreamer_tpu_torch.models import serving as sv
    from nnstreamer_tpu_torch.ops.kernels import decode_attention as da
    from nnstreamer_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    n_layers = len(lm.blocks)
    cb = sv.ContinuousBatcher(lm, MISTRAL["n_heads"], **SERVE, attn_impl="pallas",
                              mesh=make_mesh(1, axes=("dp",)), device=dev)
    (shard,) = cb.shards
    if shard.n != SERVE["n_slots"] or shard.device.type != torch.device(dev).type:
        raise AssertionError(f"mesh_serving: shard of {shard.n} slots on {shard.device}")
    drive_requests(cb, [prompts[0][:64]], 4)  # warm-up: the shard's programs captured
    steps0 = cb.stats()["steps"]
    shard.k3_launches.reset()
    da.decode_attention_launches.reset()
    run = drive_requests(cb, prompts[:MESH_SERVE_REQUESTS], NEW_TOKENS)
    k3 = shard.k3_launches.count
    steps = cb.stats()["steps"] - steps0
    st = cb.stats()
    programs = replayed_programs(st, "mesh_serving")
    if not all(name.startswith("shard0/") for name in programs):
        raise AssertionError(f"mesh_serving: programs {list(programs)} are not the shard's")
    if k3 != n_layers * steps or da.decode_attention_launches.count != k3:
        raise AssertionError(f"mesh_serving: the shard's K3 counter {k3} (all launches "
                             f"{da.decode_attention_launches.count}) for {n_layers} layers x "
                             f"{steps} steps")
    want = plain["tokens"][:MESH_SERVE_REQUESTS]
    diff = [i for i, (a, b) in enumerate(zip(run["tokens"], want)) if a != b]
    if diff or any(t is None or len(t) != NEW_TOKENS for t in run["tokens"]):
        raise AssertionError(f"mesh_serving: requests {diff} differ from the unsharded batcher")
    prof = decode_profile(torch, cb, prompts, 8)
    del cb, shard
    torch.cuda.empty_cache()
    return {
        "phase": "mesh_serving", "config": "llm-serving-mistral7b", "layers": n_layers,
        **{k: MISTRAL[k] for k in ("d_model", "n_heads", "n_kv_heads", "d_ff", "vocab")},
        **SERVE, "mesh": {"dp": 1}, "requests": MESH_SERVE_REQUESTS, "new_tokens": NEW_TOKENS,
        "tokens_equal_unsharded": True, "k3_launches": k3, "steps": steps,
        "layers_x_steps": n_layers * steps, "program_replays": programs,
        "ms_per_step_p50": pct(run["pump_ms_per_step"], 0.5),
        "unsharded_ms_per_step_p50": pct(plain["pump_ms_per_step"], 0.5),
        "admit_step_ms_p50": pct(run["admit_step_ms"], 0.5),
        "profile_steps": 8, "per_step": per_step(prof, 8),
        "unsharded_per_step": per_step(plain_profile, 8),
        "seconds": time.perf_counter() - t0,
    }


def mesh_refusal_phase(torch, dev, parse_pipeline):
    """(d) a mesh of two on one card raises, naming both counts: the
    filter's mesh:dp2, make_mesh(2), and plane-mode=shard plane-devices=2."""
    import re

    from nnstreamer_tpu_torch.parallel.mesh import make_mesh
    from nnstreamer_tpu_torch.single import SingleShot

    calls = {
        "custom_mesh_dp2": lambda: SingleShot(framework="torch", model="zoo:mobilenet_v2",
                                              custom="mesh:dp2", device=dev).open(),
        "make_mesh_2": lambda: make_mesh(2, axes=("dp",)),
        "plane_shard_2": lambda: parse_pipeline(PLANE_PIPELINE.format(
            n=1, plane=" plane=chip-mesh-two plane-mode=shard plane-devices=2",
            decode=""), device=dev).negotiate(),
    }
    out = {"phase": "mesh_refusals"}
    for name, call in calls.items():
        try:
            call()
        except Exception as exc:  # noqa: BLE001 — the message is the check
            if not re.search(MESH_TOO_FEW, str(exc)):
                raise AssertionError(f"mesh_refusals {name}: {exc!r}") from exc
            out[name] = str(exc)
        else:
            raise AssertionError(f"mesh_refusals {name}: a mesh of 2 did not raise")
    return out


def mesh_placement_phase(torch, dev, parse_pipeline, ik, want_labels):
    """(e) place_pipeline over the two labeling streams on one card under
    the configured bound: every stage on cuda:0 and left unpinned (fused),
    labels equal to the plane's; a bound below a stage raises."""
    from nnstreamer_tpu_torch.serving_plane import PlacementError, place_pipeline

    desc = PLANE_PIPELINE.format(n=MESH_PLANE_FRAMES, plane="", decode=PLANE_LABELS)
    old = os.environ.get("NNS_TPU_PLANE_MEMORY_PER_DEVICE")
    os.environ["NNS_TPU_PLANE_MEMORY_PER_DEVICE"] = MESH_BOUND
    try:
        p = parse_pipeline(desc, device=dev)
        plan = place_pipeline(p)
    finally:
        if old is None:
            os.environ.pop("NNS_TPU_PLANE_MEMORY_PER_DEVICE")
        else:
            os.environ["NNS_TPU_PLANE_MEMORY_PER_DEVICE"] = old
    from nnstreamer_tpu_torch.analysis.costmodel import estimate_stage_bytes

    costs = {name: estimate_stage_bytes(p[name]) for name in plan}
    if plan != {"f0": 0, "f1": 0}:
        raise AssertionError(f"mesh_placement: plan {plan}")
    if any(p[name].backend._pinned is not None for name in plan):
        raise AssertionError("mesh_placement: a stage on device 0 was pinned")
    ik.crop_resize_launches.reset()
    ex = p.run(timeout=600)
    if ex.errors:
        raise AssertionError(f"mesh_placement: {ex.errors}")
    labels = [[int(f.tensors[0][0]) for f in p[f"out{k}"].frames] for k in range(2)]
    if labels != want_labels:
        raise AssertionError("mesh_placement: labels differ from the plane's")
    small = min(costs.values()) - 1
    try:
        place_pipeline(parse_pipeline(desc, device=dev), per_device_bytes=small)
    except PlacementError as exc:
        refused = str(exc)
    else:
        raise AssertionError(f"mesh_placement: a {small}-byte bound did not raise")
    return {"phase": "mesh_placement", "bound": MESH_BOUND, "plan": plan,
            "stage_bytes": costs, "k1_launches": ik.crop_resize_launches.count,
            "labels_equal": True, "small_bound_refused": refused}


def mesh_phases(torch, np, dev, parse_pipeline, ik, serving):
    """The mesh group: mesh_filter, mesh_plane, mesh_refusals,
    mesh_placement; ``serving`` is the mesh_serving result the slot serving
    phase made on its own weights (reported here with the group)."""
    t0 = time.perf_counter()
    filt = mesh_filter_phase(torch, np, dev, parse_pipeline, ik)
    emit(filt)
    plane = mesh_plane_phase(torch, np, dev, parse_pipeline, ik)
    emit({k: v for k, v in plane.items() if k != "labels"})
    emit(mesh_refusal_phase(torch, dev, parse_pipeline))
    place = mesh_placement_phase(torch, dev, parse_pipeline, ik, plane["labels"])
    emit(place)
    seconds = time.perf_counter() - t0
    return {"k1_launches": filt["k1_launches"] + plane["k1_launches"] + place["k1_launches"],
            "k3_launches": serving["k3_launches"], "serving": serving,
            "seconds": seconds + serving["seconds"], "pipelines_seconds": seconds}


# -- the train group: training and sequence parallelism ----------------------------

TRAIN_LM = dict(MISTRAL, n_layers=4)  # Mistral-7B's widths, 4 of its 32 layers
TRAIN_LM_TOKENS = 2049  # [1, 2049]: 2048 inputs and their next tokens
TRAIN_KV_CHUNK = 512
TRAIN_LR = 0.1  # the reference's make_lm_train_step default
# the ring's gradient against dense attention's, each leaf relative to its
# largest magnitude (float32, TF32 off; reading 8.2e-6 on an H100)
TRAIN_LM_GRAD_RTOL = 5e-5
# Mixtral-8x7B's expert widths in the reference's two-matrix expert form
TRAIN_MOE = dict(vocab=32000, d_model=4096, n_heads=32, n_kv_heads=8, n_layers=2, d_ff=14336,
                 n_experts=8, moe_d_ff=14336)
TRAIN_MOE_TOKENS = 1025
TRAIN_TOP_K = 2
TRAIN_ULYSSES = dict(MISTRAL, n_layers=2)
TRAIN_ULYSSES_TOKENS = 1025
TRAIN_PIPE = (4, 256)  # microbatches, tokens: x [4, 256, d_model] through the 4-layer stack
TRAIN_MBV2 = dict(size=224, num_classes=1001, batch=32, check_batch=4)
# the card's float64 batch-4 step against the CPU's: every leaf of the
# parameters and the momentum within this of its largest magnitude, plus
# 1e-14 of the tree's largest (both cast the logits to float32, whose ulp
# the gradient amplifies; in float32 the gradient itself is ill-conditioned).
# Readings on an H100: parameters 6.1e-8, momentum 1.2e-6
TRAIN_MBV2_F64_RTOL = 1e-5
TRAIN_NO_KERNEL = ("no hand-written kernel runs on the training path: the reference's "
                   "training reaches no pl.pallas_call (K5 has no backward; ring attention "
                   "and Ulysses attend in jnp), so the port's train steps run torch ops, "
                   "their convs and matmuls cuDNN's and cuBLAS's")


def cuda_ms(torch, fn):
    """(fn's result, its ms on the card's stream between two CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def peak_gb(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def timed_steps(torch, step, state, args, n):
    """``n`` steps on the same batch → (state, losses, ms a step, peak GB
    a step)."""
    losses, ms, peaks = [], [], []
    for _ in range(n):
        torch.cuda.reset_peak_memory_stats()
        out, t = cuda_ms(torch, lambda: step(*state, *args))
        state, loss = out[:-1], out[-1]
        losses.append(float(loss))
        ms.append(t)
        peaks.append(peak_gb(torch))
    return state, losses, ms, peaks


def falling(losses) -> bool:
    return all(math.isfinite(x) for x in losses) and all(
        b < a for a, b in zip(losses, losses[1:]))


def lm_tokens(torch, dev, vocab, n, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, vocab, (1, n), generator=g, device=dev, dtype=torch.int32)


def train_lm_phase(torch, np, dev):
    """(a) the dp×sp×ep LM step at Mistral-7B's widths (4 layers, float32),
    ring attention with kv_chunk 512 over tokens [1, 2049]: three steps,
    finite and falling; the first loss within 1e-4 relative of dense
    attention's on the same weights, and the gradient too (every leaf
    within TRAIN_LM_GRAD_RTOL of its largest magnitude); the ring and the
    dense forward + backward timed alike. (d) the pipeline, pp = 1 over the same stack, 4
    microbatches, against the sequential forward within 2e-4."""
    from nnstreamer_tpu_torch.models import transformer as tfm
    from nnstreamer_tpu_torch.parallel import lm as plm
    from nnstreamer_tpu_torch.parallel import pipeline_parallel as ppl
    from nnstreamer_tpu_torch.parallel.mesh import make_mesh

    model = plm.init_lm_params(torch.Generator(device=dev).manual_seed(0), device=dev,
                               **TRAIN_LM)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = lm_tokens(torch, dev, TRAIN_LM["vocab"], TRAIN_LM_TOKENS)
    with torch.no_grad():
        dense_loss = float(plm.loss_fn(model, tokens, TRAIN_LM["n_heads"]))
        # (d) the pipeline over the same 4-layer stack
        m, t = TRAIN_PIPE
        x = torch.randn((m, t, TRAIN_LM["d_model"]), generator=torch.Generator(
            device=dev).manual_seed(1), device=dev)
        pos = torch.arange(t, device=dev)
        seq = tfm.apply_layers(model, x, TRAIN_LM["n_heads"], pos)
        fwd = ppl.make_pipeline_forward(
            make_mesh(1, axes=("pp",), devices=dev.type),
            lambda xb, blocks: tfm.apply_layers(blocks, xb, TRAIN_LM["n_heads"], pos), m)
        piped, pipe_ms = cuda_ms(torch, lambda: fwd(model.blocks, x))
        pipe_err = float((piped - seq).abs().max())
    del seq, piped, x
    if not pipe_err <= 2e-4:
        raise AssertionError(f"train_pipeline: {pipe_err} from the sequential forward")
    pipe = {"phase": "train_pipeline", "pp": 1, "microbatches": m, "x": [m, t, TRAIN_LM["d_model"]],
            "layers": TRAIN_LM["n_layers"], "max_abs_err": pipe_err, "ms": pipe_ms}

    mesh = make_mesh(1, axes=("dp", "sp", "ep"), devices=dev.type)
    step, params = plm.make_lm_train_step(mesh, model, TRAIN_LM["n_heads"], attn="ring",
                                          learning_rate=TRAIN_LR, kv_chunk=TRAIN_KV_CHUNK)
    del model
    torch.cuda.empty_cache()
    # the ring and the dense forward + backward, timed alike on the step's own
    # weights, each after a warm-up call of both
    _, row_model, ring_attn, _ = step.rows[0]
    fb = {}
    pieces = [p for st in params.values() for _, p in st.local()]
    for name, attn in (("warm", ring_attn), ("warm", None), ("ring", ring_attn),
                       ("dense", None)):
        torch.cuda.reset_peak_memory_stats()
        _, fb[name] = cuda_ms(torch, lambda: plm.loss_fn(row_model, tokens, TRAIN_LM["n_heads"],
                                                          attn_fn=attn).backward())
        fb[name + "_peak_gb"] = peak_gb(torch)
        if name == "ring":
            ring_grads = [p.grad for p in pieces]
        elif name == "dense":
            # the backward on the card: the ring's gradient against dense
            # attention's, leaf by leaf
            grad_rel = max(float((g - p.grad).abs().max() / p.grad.abs().max())
                           for g, p in zip(ring_grads, pieces))
            del ring_grads
        for p in pieces:
            p.grad = None
    (_,), losses, ms, peaks = timed_steps(torch, step, (params,), (tokens,), 3)
    rel = abs(losses[0] - dense_loss) / abs(dense_loss)
    if not falling(losses) or not rel <= 1e-4 or not grad_rel <= TRAIN_LM_GRAD_RTOL:
        raise AssertionError(f"train_lm: losses {losses}, dense {dense_loss} (rel {rel}), "
                             f"gradient {grad_rel} from dense attention's")
    del step, params, row_model
    torch.cuda.empty_cache()
    return {"phase": "train_lm", "widths": TRAIN_LM, "params": n_params,
            "tokens": [1, TRAIN_LM_TOKENS], "attn": "ring", "kv_chunk": TRAIN_KV_CHUNK,
            "lr": TRAIN_LR, "losses": losses, "dense_loss": dense_loss,
            "first_loss_rel_to_dense": rel, "grad_rel_to_dense": grad_rel,
            "grad_rtol": TRAIN_LM_GRAD_RTOL, "step_ms": ms, "step_peak_gb": peaks,
            "fwd_bwd_ms_ring": fb["ring"], "fwd_bwd_ms_dense": fb["dense"],
            "fwd_bwd_peak_gb_ring": fb["ring_peak_gb"],
            "fwd_bwd_peak_gb_dense": fb["dense_peak_gb"]}, pipe


def train_moe_phase(torch, np, dev):
    """(b) MoE at Mixtral-8x7B's expert widths (8 experts of 14336, top 2,
    d 4096), 2 layers, tokens [1, 1025]: the ep path against moe_ffn_dense
    on the first layer's FFN input within 1e-5 relative, and two steps,
    finite and falling."""
    from nnstreamer_tpu_torch.models import transformer as tfm
    from nnstreamer_tpu_torch.parallel import lm as plm
    from nnstreamer_tpu_torch.parallel import moe as pmoe
    from nnstreamer_tpu_torch.parallel.mesh import make_mesh

    model = plm.init_lm_params(torch.Generator(device=dev).manual_seed(2), device=dev,
                               **TRAIN_MOE)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = lm_tokens(torch, dev, TRAIN_MOE["vocab"], TRAIN_MOE_TOKENS, seed=3)
    mesh = make_mesh(1, axes=("dp", "sp", "ep"), devices=dev.type)
    blk = model.blocks[0]
    with torch.no_grad():
        x = tfm.embed_lookup(model.embed, tokens[:, :-1], torch.float32)
        y = tfm.rmsnorm(x, blk.ln2)  # layer 0's FFN input, as block_ffn gives it
        p = {"gate": blk.moe_gate, "w_in": blk.moe_w_in, "w_out": blk.moe_w_out}
        ep, ep_ms = cuda_ms(torch, lambda: pmoe.make_moe_ffn(mesh, "ep", TRAIN_TOP_K)(y, p))
        dense = pmoe.moe_ffn_dense(y, p, TRAIN_TOP_K)
        rel = float((ep - dense).abs().max() / dense.abs().max())
    del x, y, ep, dense
    if not rel <= 1e-5:
        raise AssertionError(f"train_moe: the ep path is {rel} from moe_ffn_dense")
    step, params = plm.make_lm_train_step(mesh, model, TRAIN_MOE["n_heads"], attn="ring",
                                          ep_axis="ep", top_k=TRAIN_TOP_K,
                                          learning_rate=TRAIN_LR)
    del model, blk, p
    torch.cuda.empty_cache()
    (_,), losses, ms, peaks = timed_steps(torch, step, (params,), (tokens,), 2)
    if not falling(losses):
        raise AssertionError(f"train_moe: losses {losses}")
    del step, params
    torch.cuda.empty_cache()
    return {"phase": "train_moe", "widths": TRAIN_MOE, "top_k": TRAIN_TOP_K, "params": n_params,
            "tokens": [1, TRAIN_MOE_TOKENS], "ep_vs_dense_rel": rel, "ep_ffn_ms": ep_ms,
            "losses": losses, "step_ms": ms, "step_peak_gb": peaks}


def train_ulysses_phase(torch, np, dev):
    """(c) the Ulysses step at Mistral-7B's widths, 2 layers: finite."""
    from nnstreamer_tpu_torch.parallel import lm as plm
    from nnstreamer_tpu_torch.parallel.mesh import make_mesh

    model = plm.init_lm_params(torch.Generator(device=dev).manual_seed(4), device=dev,
                               **TRAIN_ULYSSES)
    tokens = lm_tokens(torch, dev, TRAIN_ULYSSES["vocab"], TRAIN_ULYSSES_TOKENS, seed=5)
    step, params = plm.make_lm_train_step(make_mesh(1, axes=("dp", "sp"), devices=dev.type),
                                          model, TRAIN_ULYSSES["n_heads"], attn="ulysses",
                                          learning_rate=TRAIN_LR)
    del model
    torch.cuda.empty_cache()
    (_,), losses, ms, peaks = timed_steps(torch, step, (params,), (tokens,), 1)
    if not math.isfinite(losses[0]):
        raise AssertionError(f"train_ulysses: loss {losses}")
    del step, params
    torch.cuda.empty_cache()
    return {"phase": "train_ulysses", "widths": TRAIN_ULYSSES,
            "tokens": [1, TRAIN_ULYSSES_TOKENS], "loss": losses[0], "step_ms": ms[0],
            "step_peak_gb": peaks[0]}


def mbv2_batch(torch, n, size, classes, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 256, (n, size, size, 3), generator=g, dtype=torch.uint8),
            torch.randint(0, classes, (n,), generator=g, dtype=torch.int64))


def train_mobilenet_phase(torch, np, dev):
    """(e) MobileNet-v2's dp×tp step at full width (224², 1001 classes),
    batch 32, three steps on the same batch, each loss lower than the last;
    batch 4 on the same weights against the port's CPU step: the float32
    loss within 1e-4 relative, and one float64 step's parameters and
    momentum leaf by leaf within TRAIN_MBV2_F64_RTOL (cuDNN's deterministic
    algorithms). (f) its train state (parameters and momentum) saved and
    restored onto the mesh: the eval loss bit-equal, and the next step
    equal to the uninterrupted step bit for bit."""
    from nnstreamer_tpu_torch.models import mobilenet_v2 as mb
    from nnstreamer_tpu_torch.parallel import checkpoint as ckpt
    from nnstreamer_tpu_torch.parallel import train as ptrain
    from nnstreamer_tpu_torch.parallel.mesh import make_mesh

    cfg = TRAIN_MBV2
    model = mb.MobileNetV2(num_classes=cfg["num_classes"],
                           generator=torch.Generator().manual_seed(0))
    images, labels = mbv2_batch(torch, cfg["batch"], cfg["size"], cfg["num_classes"], 0)
    small = tuple(t[:cfg["check_batch"]] for t in (images, labels))
    cpu_mesh = make_mesh(1, axes=("dp", "tp"), devices="cpu")
    mesh = make_mesh(1, axes=("dp", "tp"), devices=dev.type)
    cpu_step, cpu_p, _ = ptrain.make_train_step(cpu_mesh, model)
    cpu_loss = cpu_step.loss(cpu_p, *small)  # the step's loss: its forward, before the update
    # one float64 step of batch 4 on the CPU and on the card: the backward and
    # the update, every leaf of the parameters and the momentum
    model64 = copy.deepcopy(model).double()
    after = {}
    was = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for where, on, d in (("cpu", cpu_mesh, "cpu"), ("card", mesh, dev)):
            st, sp, so = ptrain.make_train_step(on, model64.to(d), compute_dtype=torch.float64)
            sp, so, _ = st(sp, so, *(t.to(d) for t in small))
            after[where] = [{k: v.pieces[0, 0].detach().cpu() for k, v in tree.items()}
                            for tree in (sp, so)]
            del st, sp, so
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was
    del model64
    f64_rel = {}
    for i, what in enumerate(("params", "momentum")):
        ref, got = after["cpu"][i], after["card"][i]
        scale = max(float(v.abs().max()) for v in ref.values())
        f64_rel[what] = max(float((got[k] - ref[k]).abs().max())
                            / (float(ref[k].abs().max()) + 1e-9 * scale) for k in ref)
        bad = [k for k in ref if float((got[k] - ref[k]).abs().max())
               > TRAIN_MBV2_F64_RTOL * float(ref[k].abs().max()) + 1e-14 * scale]
        if bad:
            raise AssertionError(f"train_mobilenet: the float64 step's {what} on the card "
                                 f"differ from the CPU's at {bad[:4]}")
    gpu = model.to(dev)
    check_step, cp, co = ptrain.make_train_step(mesh, gpu)
    _, _, gpu_small = check_step(cp, co, *(t.to(dev) for t in small))
    rel = abs(float(gpu_small) - float(cpu_loss)) / abs(float(cpu_loss))
    if not rel <= 1e-4:
        raise AssertionError(f"train_mobilenet: batch 4 loss {float(gpu_small)} on the card, "
                             f"{float(cpu_loss)} on the CPU")
    del check_step, cp, co
    step, params, opt = ptrain.make_train_step(mesh, gpu)
    args = (images.to(dev), labels.to(dev))
    (params, opt), losses, ms, peaks = timed_steps(torch, step, (params, opt), args, 3)
    if not falling(losses):
        raise AssertionError(f"train_mobilenet: losses {losses}")
    out = {"phase": "train_mobilenet", "size": cfg["size"], "num_classes": cfg["num_classes"],
           "batch": cfg["batch"], "mesh": mesh.shape, "lr": 0.05, "momentum": 0.9,
           "losses": losses, "step_ms": ms, "step_peak_gb": peaks,
           "check_batch": cfg["check_batch"], "check_loss_card": float(gpu_small),
           "check_loss_cpu": float(cpu_loss), "check_rel": rel,
           "check_f64_rel_params": f64_rel["params"], "check_f64_rel_momentum": f64_rel["momentum"],
           "check_f64_rtol": TRAIN_MBV2_F64_RTOL}

    # (f) checkpoints: deterministic convolutions, so a step can repeat bit for bit
    was = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "mbv2")
            eval_args = mbv2_batch(torch, cfg["batch"], cfg["size"], cfg["num_classes"], 1)
            eval_args = tuple(t.to(dev) for t in eval_args)
            want_eval = step.loss(params, *eval_args)
            ckpt.save(path, {"params": params, "opt": opt})
            size_mb = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 1e6
            _, _, want_loss = step(params, opt, *args)  # the uninterrupted step
            want = {k: v.pieces[0, 0].detach().clone() for k, v in params.items()}
            fresh, fp, fo = ptrain.make_train_step(mesh, gpu)
            restored = ckpt.restore(path, like={"params": fp, "opt": fo},
                                    shardings={"params": fresh.shardings, "opt": fresh.shardings})
            on_mesh = all(p.device == mesh.devices[idx] for st in restored["params"].values()
                          for idx, p in st.local())
            got_eval = fresh.loss(restored["params"], *eval_args)
            _, _, got_loss = fresh(restored["params"], restored["opt"], *args)
            same_params = all(torch.equal(fp[k].pieces[0, 0], v) for k, v in want.items())
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was
    if not (on_mesh and torch.equal(got_eval, want_eval) and torch.equal(got_loss, want_loss)
            and same_params):
        raise AssertionError(f"train_checkpoint: on_mesh {on_mesh}, eval {float(got_eval)} vs "
                             f"{float(want_eval)}, next {float(got_loss)} vs {float(want_loss)}, "
                             f"params equal {same_params}")
    ck = {"phase": "train_checkpoint", "leaves": 2 * len(params), "megabytes": size_mb,
          "pieces_on_mesh": on_mesh, "eval_loss": float(got_eval), "eval_bit_equal": True,
          "next_step_loss": float(got_loss), "next_step_bit_equal": True}
    return out, ck, gpu


def train_multihost_phase(torch, np, dev, model):
    """(g) multihost at world size 1 on nccl: initialize, barrier,
    is_primary, process_info, one MobileNet step over the global mesh; a
    mesh of 2 raises naming both counts."""
    import re
    import socket

    from nnstreamer_tpu_torch.parallel import multihost
    from nnstreamer_tpu_torch.parallel import train as ptrain
    from nnstreamer_tpu_torch.parallel.mesh import make_mesh

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    t0 = time.perf_counter()
    multihost.initialize(coord, num_processes=1, process_id=0, device="cuda")
    try:
        init_s = time.perf_counter() - t0
        multihost.barrier("train-group")
        info = multihost.process_info()
        mesh = make_mesh(axes=("dp", "tp"))
        if mesh.ranks is None or mesh.ranks.tolist() != [[0]] or not multihost.is_primary():
            raise AssertionError(f"train_multihost: mesh {mesh} ranks {mesh.ranks}")
        step, params, opt = ptrain.make_train_step(mesh, model)
        images, labels = mbv2_batch(torch, TRAIN_MBV2["check_batch"], TRAIN_MBV2["size"],
                                    TRAIN_MBV2["num_classes"], 2)
        (_, _, loss), ms = cuda_ms(torch, lambda: step(params, opt, images.to(dev),
                                                       labels.to(dev)))
        try:
            make_mesh(2, axes=("dp",))
        except ValueError as exc:
            if not re.search(MESH_TOO_FEW, str(exc)):
                raise AssertionError(f"train_multihost: {exc!r}") from exc
            refused = str(exc)
        else:
            raise AssertionError("train_multihost: a mesh of 2 did not raise")
        import torch.distributed as dist

        backend = dist.get_backend()
    finally:
        multihost.shutdown()
    if not math.isfinite(float(loss)) or info["process_count"] != 1:
        raise AssertionError(f"train_multihost: loss {float(loss)}, {info}")
    return {"phase": "train_multihost", "backend": backend, "init_s": init_s,
            "process_info": info, "mesh": mesh.shape, "loss": float(loss), "step_ms": ms,
            "mesh_of_2": refused}


def train_phases(torch, np, dev):
    """The train group: train_lm (+ train_pipeline), train_moe,
    train_ulysses, train_mobilenet (+ train_checkpoint), train_multihost;
    each phase frees its weights before the next."""
    t0 = time.perf_counter()
    lm_out, pipe = train_lm_phase(torch, np, dev)
    emit(lm_out)
    emit(pipe)
    emit(train_moe_phase(torch, np, dev))
    emit(train_ulysses_phase(torch, np, dev))
    mb_out, ck, model = train_mobilenet_phase(torch, np, dev)
    emit(mb_out)
    emit(ck)
    emit(train_multihost_phase(torch, np, dev, model))
    torch.cuda.empty_cache()
    return {"phase": "train", "seconds": time.perf_counter() - t0,
            "kernels_launched": 0, "why_no_kernel": TRAIN_NO_KERNEL}


def ab_turn(tree: str, npz: str) -> int:
    """One turn of ``--ab``: K1's cases and K2 at the SSD frame, 6300 and
    25200 candidates with the kernels of the checkout at ``tree`` (its own
    build), plus the floor of a launch: the device time of a one-element
    ``fill_``, the nearest PyTorch comes to an empty kernel. Prints one
    JSON line."""
    sys.path[0] = os.path.abspath(tree)
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.ops import detection as det
    from nnstreamer_tpu_torch.ops.kernels import _build
    from nnstreamer_tpu_torch.ops.kernels import image_kernels as ik
    from nnstreamer_tpu_torch.ops.kernels import nms as nk

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["image_kernels", "nms"])
    k1 = [{k: c[k] for k in ("case", "max_abs_err", "kernel_ms", "kernel_records",
                             "kernel_stream_ms", "library_ms", "bound_ms")}
          for c in k1_cases(torch, np, ik)]
    saved = np.load(npz)
    inputs = {"ssd-frame-1917": (saved["boxes"], saved["scores"]),
              "synthetic-6300": synthetic_boxes(np, 6300, 6300),
              "synthetic-25200": synthetic_boxes(np, 25200, 25200)}
    k2 = []
    for name, arrays in inputs.items():
        boxes, scores = (torch.from_numpy(a).cuda() for a in arrays)
        _, sboxes, sscores = det.rank(boxes, scores)
        alive, _ = nk._cuda_nms(sboxes, sscores, NMS_IOU)
        if not torch.equal(alive > 0, nk.plain_nms_mask(sboxes, sscores, NMS_IOU)):
            raise AssertionError(f"ab {name}: kernel differs from plain")
        ms, records, reps, stream_ms, one_ms = nms_times(torch, nk, sboxes, sscores)
        k2.append({"case": name, "kernel_ms": ms, "kernel_records": records,
                   "kernel_reps": reps, "kernel_stream_ms": stream_ms,
                   "kernel_alone_ms": one_ms})
    one = torch.empty(1, device="cuda")
    floor_ms, floor_records = device_ms(torch, lambda x: x.fill_(1.0), [(one,)], 100,
                                        per_launch=True)
    emit({"ab_turn": os.path.abspath(tree), "k1": k1, "k2": k2,
          "floor_fill1_ms": floor_ms, "floor_records": floor_records})
    return 0


def ab_main(parent: str) -> int:
    """``--ab PARENT``: K1 and K2 of the checkout at PARENT against this
    one's, on one card in four turns (parent, change, change, parent), each
    a process of its own; prints each turn's line, then a summary of the
    means and change / parent ratios."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

    here = os.path.dirname(os.path.abspath(__file__))
    print(gpu_info(), flush=True)
    boxes, scores = ssd_frame_candidates(torch, parse_pipeline, torch.device("cuda"))
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "ssd_frame.npz")
        np.savez(npz, boxes=boxes.cpu().numpy(), scores=scores.cpu().numpy())
        for label, tree in (("parent", parent), ("change", here), ("change", here),
                            ("parent", parent)):
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--ab-turn", tree, npz],
                capture_output=True, text=True, timeout=900,
            )
            if run.returncode != 0:
                print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
                raise AssertionError(f"ab turn {label} failed (rc {run.returncode})")
            turn = json.loads(run.stdout.strip().splitlines()[-1])
            turn["label"] = label
            emit(turn)
            turns.append(turn)
    summary = {}
    for kernel in ("k1", "k2"):
        for i, case in enumerate(turns[0][kernel]):
            mean = {lab: sum(t[kernel][i]["kernel_ms"] for t in turns if t["label"] == lab) / 2
                    for lab in ("parent", "change")}
            summary[case["case"]] = {**mean, "ratio": mean["change"] / mean["parent"]}
    emit({"ab_summary": summary,
          "floor_fill1_ms": [t["floor_fill1_ms"] for t in turns]})
    return 0


ANALYSIS_KV = (
    "tensorsrc dimensions=64 types=int32 num-frames=1 ! tensor_llm_serversink id=analysis "
    'custom="vocab:32000,d_model:4096,n_heads:32,n_kv_heads:8,n_layers:32,d_ff:14336" '
    "n-slots=8 max-len=4096 prompt-len=512 kv-memory-bound=4G"
)


def analysis_phases(torch, np, dev, parse_pipeline, ik):
    """The analysis group (docstring 53-56) on ``dev``, every kernel's
    library built. Returns its summary: the seconds, K1's launches in the
    cross-checked run, and the analyzer's row a kernel (its first case)."""
    import contextlib
    import io

    from nnstreamer_tpu_torch.analysis.kscope_cli import main as kscope
    from nnstreamer_tpu_torch.analysis.xray import dispatch_table, xray
    from nnstreamer_tpu_torch.cli import main as launch

    t_group = time.perf_counter()
    # 53. the launch analyzer against each .cu's own launch: nns-kscope-torch
    # as a user runs it (its default device, cuda, reads every launch)
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = kscope(["--json"])
    doc = json.loads(out.getvalue())
    rows = doc["cases"]
    bad = [r for r in rows if r["plan_matches"] is not True
           or any("regs" not in ln for ln in r["launches"])]
    if rc != 0 or bad or doc["diagnostics"]:
        raise AssertionError(f"analysis_kernels: rc {rc}, plans differ or unread {bad} "
                             f"or findings {doc['diagnostics']}")
    emit({"phase": "analysis_kernels", "cases": rows, "seconds": time.perf_counter() - t0})

    # 54. the dispatch table on the card
    table = dispatch_table(dev)
    if any(r["error"] or r["engaged"] != "kernel" or r["launches"] < 1 for r in table):
        raise AssertionError(f"analysis_dispatch: {table}")
    emit({"phase": "analysis_dispatch", "rows": table})

    # 55. nns-launch --check: the flagship pipeline clean, the KV bound caught
    checks = {}
    for name, desc, want in (("labeling_720p", PIPELINE.format(n=FRAMES, live=""), 0),
                             ("kv_bound_mistral7b", ANALYSIS_KV, 1)):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = launch(["--check", desc])
        checks[name] = {"rc": rc, "output": out.getvalue().strip().splitlines(),
                        "seconds": time.perf_counter() - t0}
        if rc != want:
            raise AssertionError(f"analysis_check {name}: rc {rc}, want {want}: {out.getvalue()}")
    if not any(line.startswith("NNS-W115") for line in checks["kv_bound_mistral7b"]["output"]):
        raise AssertionError(f"analysis_check: no NNS-W115 in {checks['kv_bound_mistral7b']}")
    emit({"phase": "analysis_check", **checks})

    # 56. nns-xray with backends open, then a cross-checked run
    t0 = time.perf_counter()
    desc = PIPELINE.format(n=FRAMES, live="")
    xr = xray(desc, device=dev)
    xray_s = time.perf_counter() - t0
    if xr.degraded or xr.codes or len(xr.chains) != 1:
        raise AssertionError(f"analysis_crosscheck: xray {xr.render()}")
    os.environ["NNS_XRAY_CROSSCHECK"] = "1"
    try:
        ik.crop_resize_launches.reset()
        p = parse_pipeline(desc, device=dev)
        ex = p.run(timeout=600)
        k1 = ik.crop_resize_launches.count
    finally:
        del os.environ["NNS_XRAY_CROSSCHECK"]
    cc = ex.last_crosscheck
    if cc is None or cc["delta"] != {"h2d": 0, "d2h": 0} or k1 != FRAMES:
        raise AssertionError(f"analysis_crosscheck: {cc}, K1 {k1} for {FRAMES} frames")
    ch = xr.chains[0]
    emit({"phase": "analysis_crosscheck", "frames": FRAMES, "k1_launches": k1,
          "chain": ch.name, "compiled": ch.compiled,
          "params_bytes": ch.cost.params_bytes, "transient_bytes": ch.cost.transient_bytes,
          "predicted_per_frame": xr.predicted,
          "boundaries": [(b.direction, b.producer, b.consumer, b.reason, b.bytes_per_frame)
                         for b in xr.boundaries],
          "crosscheck": cc, "xray_seconds": xray_s})
    first = {}
    for r in rows:
        first.setdefault(r["tpu_kernel"], r)
    return {"seconds": time.perf_counter() - t_group, "k1_launches": k1, "rows": first}


def count_traces():
    """Wrap the analyzers' segment trace (analysis/costmodel.py
    ``trace_program``, which every chain verdict runs) to tally its calls
    and host seconds over the whole script: the set-up cost the chain
    verdicts add. Returns the tally, filled as the script runs."""
    from nnstreamer_tpu_torch.analysis import costmodel

    tally = {"traces": 0, "seconds": 0.0, "first_s": None}
    real = costmodel.trace_program

    def timed(fn, sig):
        t0 = time.perf_counter()
        try:
            return real(fn, sig)
        finally:
            dt = time.perf_counter() - t0
            tally["traces"] += 1
            tally["seconds"] += dt
            if tally["first_s"] is None:
                tally["first_s"] = dt

    costmodel.trace_program = timed
    return tally


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    traces = count_traces()
    from nnstreamer_tpu_torch.ops.kernels import _build
    from nnstreamer_tpu_torch.ops.kernels import image_kernels as ik
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
    from nnstreamer_tpu_torch.single import SingleShot

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = gpu_info()
    kind = torch.cuda.get_device_name(0)
    # the host's cores and load: the pipelines' fps and latency are host-bound
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "host_cpus": os.cpu_count(), "host_loadavg_1_5_15": os.getloadavg()})

    # 1. build -------------------------------------------------------------
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    if "flash_attention" not in sources:
        raise AssertionError(f"build: flash_attention.cu missing from {sources}")
    t0 = time.perf_counter()
    libs = _build.build(sources)
    emit({"phase": "build", "sources": sources, "seconds": time.perf_counter() - t0,
          "libraries": [str(p.name) for p in libs.values()]})

    # 2. kernels -------------------------------------------------------------
    cases = k1_cases(torch, np, ik)
    emit({"phase": "kernels", "cases": cases})

    # 3. pipeline ------------------------------------------------------------
    dev = torch.device("cuda")
    run_pipeline(parse_pipeline, dev, 4)  # warm-up: cuDNN, allocator, library
    cpu_labels, _, _ = run_pipeline(parse_pipeline, "cpu", 4)
    out_devices = set()
    ik.crop_resize_launches.reset()
    labels, wall, lat_free = run_pipeline(
        parse_pipeline, dev, FRAMES,
        hook=lambda m, i, o: out_devices.add(o.device.type),
    )
    launches = ik.crop_resize_launches.count
    if launches != FRAMES:
        raise AssertionError(f"K1 launched {launches} times for {FRAMES} frames")
    if out_devices != {"cuda"}:
        raise AssertionError(f"filter outputs on {out_devices}, want cuda")
    if len(labels) != FRAMES or labels[:4] != cpu_labels:
        raise AssertionError(f"labels {labels[:4]} != CPU run {cpu_labels}")
    ik.crop_resize_launches.reset()
    _, _, lat_live = run_pipeline(parse_pipeline, dev, FRAMES, live=True)
    live_launches = ik.crop_resize_launches.count
    if live_launches != FRAMES:
        raise AssertionError(f"paced run: K1 launched {live_launches} times")
    emit({
        "phase": "pipeline", "frames": FRAMES, "k1_launches": launches,
        "labels_first4": labels[:4], "cpu_labels_first4": cpu_labels,
        "fps": FRAMES / wall, "wall_s": wall,
        "free_latency_ms_p50": pct(lat_free, 0.5), "free_latency_ms_p99": pct(lat_free, 0.99),
        "paced30_latency_ms_p50": pct(lat_live, 0.5),
        "paced30_latency_ms_p99": pct(lat_live, 0.99),
    })

    # 3a. segments: the cells' fused segments as replayed CUDA graphs ----------
    from nnstreamer_tpu_torch.ops.kernels import nms as nk

    emit(segments_phases(torch, np, dev, parse_pipeline, ik, nk))

    # 4. profile -------------------------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    p = parse_pipeline(PIPELINE.format(n=16, live=""), device=dev)
    p.negotiate()  # model built and warmed outside the profiled window
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p.run(timeout=600)
        prof_wall = time.perf_counter() - t0
    emit({"phase": "profile", "frames": 16,
          **profile_classes(torch, prof, prof_wall, [("crop_resize (K1)", "crop_resize")])})

    # 5. single --------------------------------------------------------------
    x = np.random.default_rng(0).integers(0, 256, (1, 224, 224, 3)).astype(np.uint8)
    with SingleShot(framework="torch", model="zoo:mobilenet_v2", device=dev) as s:
        (gpu_logits,) = s.invoke(x)
        gpu_logits = gpu_logits.cpu()
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.invoke(x)[0].cpu()
            times.append((time.perf_counter() - t0) * 1e3)
    with SingleShot(framework="torch", model="zoo:mobilenet_v2", device="cpu") as s:
        (cpu_logits,) = s.invoke(x)
    err = (gpu_logits - cpu_logits).abs().max().item()
    tol = 1e-3 * cpu_logits.abs().max().item()  # float32, two summation orders
    if gpu_logits.shape != (1, 1001) or not torch.isfinite(gpu_logits).all():
        raise AssertionError(f"bad logits {gpu_logits.shape}")
    if not err <= tol or gpu_logits.argmax() != cpu_logits.argmax():
        raise AssertionError(f"single: GPU vs CPU logits err {err} > {tol} or top-1 differs")
    emit({"phase": "single", "max_abs_err": err, "tolerance": tol,
          "top1": int(gpu_logits.argmax()), "invoke_ms_p50": sorted(times)[10]})

    # 6. routing ---------------------------------------------------------------
    routing = routing_phase(torch, np, dev, parse_pipeline, ik)
    emit(routing)

    # 7. nms_kernels ---------------------------------------------------------
    from nnstreamer_tpu_torch.models import ssd_mobilenet
    from nnstreamer_tpu_torch.ops import detection as det

    ssd_boxes, ssd_scores = ssd_frame_candidates(torch, parse_pipeline, dev)

    def on_dev(boxes, scores):
        return torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)

    def registry_case(n):
        # the JAX package's kernel registry inputs (ops/pallas/nms.py _boxes_scores)
        rng = np.random.default_rng(9)
        xy = rng.uniform(0, 60, (n, 2))
        wh = rng.uniform(2, 30, (n, 2))
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        return on_dev(boxes, rng.uniform(0.05, 1.0, n).astype(np.float32))

    tie_boxes, _ = synthetic_boxes(np, 512, 3)
    tie_scores = np.random.default_rng(4).choice([0.0, 0.3, 0.6, 0.9], 512).astype(np.float32)
    nms_cases = [
        nms_case(torch, det, nk, "registry-n32", *registry_case(32), max_out=8),
        nms_case(torch, det, nk, "registry-n100", *registry_case(100), max_out=16),
        nms_case(torch, det, nk, "ssd-frame-1917", ssd_boxes, ssd_scores),
        nms_case(torch, det, nk, "synthetic-6300", *on_dev(*synthetic_boxes(np, 6300, 6300))),
        nms_case(torch, det, nk, "synthetic-25200", *on_dev(*synthetic_boxes(np, 25200, 25200))),
        nms_case(torch, det, nk, "ties-512", *on_dev(tie_boxes, tie_scores)),
        # the word edges: one word short, one, one and a bit, two and a bit
        *(nms_case(torch, det, nk, f"edge-n{n}",
                   *on_dev(*synthetic_boxes(np, n, n, size=(0.05, 0.5))))
          for n in (63, 64, 65, 129)),
        nms_case(torch, det, nk, "dead-tail-2000",
                 *on_dev(*synthetic_boxes(np, 2000, 2000, zero_below=0.9))),
    ]
    emit({"phase": "nms_kernels", "iou_threshold": NMS_IOU, "cases": nms_cases})
    ssd_case = nms_cases[2]

    # 8. detection -------------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        priors_path = os.path.join(tmp, "box-priors.txt")
        ssd_mobilenet.write_box_priors(priors_path)
        run_detection(parse_pipeline, dev, 4, priors_path)  # warm-up
        cpu_frames, _, _ = run_detection(parse_pipeline, "cpu", 2, priors_path)
        out_devices = set()
        ik.crop_resize_launches.reset()
        nk.nms_launches.reset()
        det_frames, det_wall, _ = run_detection(
            parse_pipeline, dev, FRAMES, priors_path,
            hook=lambda m, i, o: out_devices.update(t.device.type for t in o),
        )
        det_k1, det_k2 = ik.crop_resize_launches.count, nk.nms_launches.count
        if det_k1 != FRAMES or det_k2 != FRAMES:
            raise AssertionError(
                f"detection: K1 launched {det_k1}, K2 {det_k2} times for {FRAMES} frames"
            )
        if out_devices != {"cuda"}:
            raise AssertionError(f"detection: filter outputs on {out_devices}, want cuda")
        if len(det_frames) != FRAMES:
            raise AssertionError(f"detection: {len(det_frames)} frames out of {FRAMES}")
        det_err = 0.0
        for g, c in zip(det_frames[:2], cpu_frames):
            g, c = g.tensors[0], c.tensors[0]
            if g.shape != (100, 6) or not np.isfinite(g).all():
                raise AssertionError(f"detection: bad detections {g.shape}")
            if not np.array_equal(g[:, 4], c[:, 4]):
                raise AssertionError("detection: classes or their order differ from the CPU run")
            det_err = max(det_err, float(np.abs(g - c).max()))
        if not det_err <= 1e-5:
            raise AssertionError(f"detection: GPU vs CPU max abs err {det_err} > 1e-5")
        ik.crop_resize_launches.reset()
        nk.nms_launches.reset()
        _, _, det_lat = run_detection(parse_pipeline, dev, FRAMES, priors_path, live=True)
        if (ik.crop_resize_launches.count, nk.nms_launches.count) != (FRAMES, FRAMES):
            raise AssertionError("detection paced run: K1/K2 not once per frame")
        nk.nms_launches.reset()
        host_frames, _, _ = run_detection(parse_pipeline, dev, 4, priors_path, pp="auto")
        host_k2 = nk.nms_launches.count
        if host_k2 != 4:
            raise AssertionError(f"host-render decode: K2 launched {host_k2} times for 4 frames")
        for f in host_frames:
            t = f.tensors[0]
            if t.shape != (480, 640, 4) or t.dtype != np.uint8:
                raise AssertionError(f"host-render decode: overlay {t.shape} {t.dtype}")
        emit({
            "phase": "detection", "frames": FRAMES, "k1_launches": det_k1,
            "k2_launches": det_k2,
            "detections_first_frame": int((det_frames[0].tensors[0][:, 5] > 0).sum()),
            "gpu_vs_cpu_max_abs_err": det_err,
            "fps": FRAMES / det_wall, "wall_s": det_wall,
            "paced30_latency_ms_p50": pct(det_lat, 0.5),
            "paced30_latency_ms_p99": pct(det_lat, 0.99),
            "host_render": {"frames": 4, "k2_launches": host_k2,
                            "overlay": list(host_frames[0].tensors[0].shape),
                            "boxes_first_frame": len(host_frames[0].meta["detections"])},
        })

        # 9. detection_profile -------------------------------------------------
        p = parse_pipeline(
            DET_PIPELINE.format(n=16, live="", priors=priors_path, pp="device"), device=dev
        )
        p.negotiate()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            p.run(timeout=600)
            prof_wall = time.perf_counter() - t0
    emit({"phase": "detection_profile", "frames": 16, **profile_classes(
        torch, prof, prof_wall,
        [("nms (K2)", "nms_kernel"), ("crop_resize (K1)", "crop_resize")],
    )})

    # 10. single_ssd ------------------------------------------------------------
    x = np.random.default_rng(1).integers(0, 256, (1, 300, 300, 3)).astype(np.uint8)
    invokes = 20
    with SingleShot(framework="torch", model="zoo:ssd_mobilenet_v2_pp", device=dev) as s:
        s.invoke(x)  # warm-up (also infers the output spec)
        torch.cuda.synchronize()
        nk.nms_launches.reset()
        gpu_out = [t.cpu() for t in s.invoke(x)]
        times = []
        for _ in range(invokes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            [t.cpu() for t in s.invoke(x)]
            times.append((time.perf_counter() - t0) * 1e3)
        pp_k2 = nk.nms_launches.count
    with SingleShot(framework="torch", model="zoo:ssd_mobilenet_v2_pp", device="cpu") as s:
        cpu_out = list(s.invoke(x))
    if pp_k2 != invokes + 1:
        raise AssertionError(f"single_ssd: K2 launched {pp_k2} times for {invokes + 1} invokes")
    (gb, gc, gs, gn), (cb, cc, cs, cn) = gpu_out, cpu_out
    if not (torch.equal(gn, cn) and torch.equal(gc, cc)):
        raise AssertionError(f"single_ssd: num/classes differ: {gn} {gc} vs {cn} {cc}")
    pp_err = max((gb - cb).abs().max().item(), (gs - cs).abs().max().item())
    pp_tol = 1e-4 * max(cb.abs().max().item(), cs.abs().max().item(), 1e-30)
    if not pp_err <= pp_tol:
        raise AssertionError(f"single_ssd: GPU vs CPU err {pp_err} > {pp_tol}")
    emit({"phase": "single_ssd", "num": int(gn.item()), "max_abs_err": pp_err,
          "tolerance": pp_tol, "k2_launches": pp_k2, "invokes": invokes + 1,
          "invoke_ms_p50": sorted(times)[invokes // 2]})

    # 10a-10f. the vision families and cascades -------------------------------
    emit({"phase": "host", "host_loadavg_1_5_15": os.getloadavg()})
    vision = vision_phases(torch, np, dev, parse_pipeline, ik, nk, det)
    torch.cuda.empty_cache()

    # 10g-10j. the wire codecs, script subplugins and flexible input -------------
    codecs_k1 = codecs_phases(torch, np, dev, parse_pipeline, ik, {
        "labels": labels, "fps": FRAMES / wall,
        "paced30_latency_ms_p50": pct(lat_live, 0.5),
        "paced30_latency_ms_p99": pct(lat_live, 0.99)})

    k3_by_name, k3_launches, slot_ttft, mesh_serving = llm_phases(torch, np, dev,
                                                                   parse_pipeline)
    k3_main = k3_by_name["serve-f32-pos600"]
    k4_main, k4_launches = paged_phases(torch, np, dev, parse_pipeline, k3_by_name, slot_ttft)
    torch.cuda.empty_cache()
    graphs = serving_graphs_phases(torch, np, dev)
    emit({k: v for k, v in graphs.items() if k not in ("slot", "paged")})
    spec = speculative_phases(torch, np, dev)
    emit({k: v for k, v in spec.items() if k not in ("spec_ngram", "prefixes", "spec_draft_self",
                                                     "spec_sampling")})
    state = serving_state_phases(torch, np, dev)
    emit({"phase": "serving_state", "seconds": state["seconds"],
          "k3_launches": state["k3_launches"], "k4_launches": state["k4_launches"]})
    k5_main, k5_launches = flash_phases(torch, np, dev, parse_pipeline)
    torch.cuda.empty_cache()
    plane = plane_phases(torch, np, dev, parse_pipeline, ik)
    emit({"phase": "plane", "seconds": plane["seconds"]})
    sources = model_sources_phases(torch, np, dev, parse_pipeline, ik)
    emit({"phase": "model_sources", "seconds": sources["seconds"]})
    faults = faults_phases(torch, np, dev, parse_pipeline, ik)
    emit({"phase": "faults", "seconds": faults["seconds"]})
    observe = observe_phases(torch, np, dev, parse_pipeline, ik)
    emit({"phase": "observe", "seconds": observe["seconds"]})
    edge = edge_phases(torch, np, dev, parse_pipeline, ik)
    emit({"phase": "edge", "seconds": edge["seconds"]})
    emit(mesh_serving)
    mesh = mesh_phases(torch, np, dev, parse_pipeline, ik, mesh_serving)
    emit({"phase": "mesh", "seconds": mesh["seconds"],
          "pipelines_seconds": mesh["pipelines_seconds"],
          "serving_seconds": mesh_serving["seconds"]})
    torch.cuda.empty_cache()
    emit(train_phases(torch, np, dev))
    torch.cuda.empty_cache()
    analysis = analysis_phases(torch, np, dev, parse_pipeline, ik)
    emit({"phase": "analysis", "seconds": analysis["seconds"]})
    # the segment traces of every chain verdict and analyzer in the script
    emit({"phase": "segment_traces", **traces})

    def launch_analysis(tk):
        """The analyzer's row of the kernel's first main-path case."""
        row = analysis["rows"][tk]
        return {"case": row["case"], "bound_ms": row["bound_ms"], "launches": [
            {k: ln[k] for k in ("kernel", "grid", "block", "dyn_smem", "regs", "static_smem",
                                "local_bytes", "blocks_per_sm")} for ln in row["launches"]]}

    main_case = cases[0]
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "crop_resize",
        "launch_analysis": launch_analysis("K1"),
        "route": "cuda",
        "source": "nnstreamer_tpu_torch/csrc/image_kernels.cu",
        "replaces": "nnstreamer_tpu/ops/pallas/image_kernels.py:165",
        "launches": launches,
        "launches_routing": {"crop_entry": routing["k1_crop_launches"],
                             "resize_entry": routing["k1_resize_launches"]},
        "routing_crop_case": {k: cases[-1][k] for k in (
            "case", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by")},
        "launches_vision": vision["k1_launches"],
        "launches_codec_labeling": codecs_k1,
        "launches_plane_pipelines": plane["plane_pipelines"]["k1_launches"],
        "launches_model_sources": sources["k1_launches"],
        "launches_faults": faults["k1_launches"],
        "launches_observe": observe["k1_launches"],
        "launches_edge": edge["k1_launches"],
        "launches_mesh": mesh["k1_launches"],
        "launches_analysis": analysis["k1_launches"],
        "vision_cases": [{k: c[k] for k in (
            "case", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for c in vision["k1_cases"]],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }, {
        "name": "nms",
        "launch_analysis": launch_analysis("K2"),
        "route": "cuda",
        "source": "nnstreamer_tpu_torch/csrc/nms.cu",
        "replaces": "nnstreamer_tpu/ops/pallas/nms.py:119",
        "launches": det_k2,
        "max_abs_err": ssd_case["max_abs_err"],
        "ms": ssd_case["kernel_ms"],
        "plain_ms": ssd_case["plain_ms"],
        "bound_ms": ssd_case["bound_ms"],
        "bound_by": ssd_case["bound_by"],
        "library_ms": None,  # no PyTorch call computes greedy NMS
        "launches_yolo": vision["k2_launches"],
        "yolo_case": {k: vision["k2_case"][k] for k in (
            "case", "n", "m", "kept", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        "redesigned": "IoU bitmask in 64x64 tiles across the SMs, then a one-block scan "
                      "of 64-bit words (one barrier a word block)",
    }, {
        "name": "decode_attention",
        "launch_analysis": launch_analysis("K3"),
        "route": "cuda",
        "source": "nnstreamer_tpu_torch/csrc/decode_attention.cu",
        "replaces": "nnstreamer_tpu/ops/pallas/decode_attention.py:178",
        "launches": k3_launches,
        "launches_speculative": spec["k3_launches"],
        "launches_windowed_ring": state["k3_launches"],
        "launches_mesh_serving": mesh["k3_launches"],
        "ring_cases": [{k: c[k] for k in (
            "case", "pos_min", "pos_max", "live_rows", "max_abs_err", "kernel_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")} for c in state["windowed_ring"]["k3_cases"]],
        "max_abs_err": k3_main["max_abs_err"],
        "ms": k3_main["kernel_ms"],
        "plain_ms": k3_main["plain_ms"],
        "bound_ms": k3_main["bound_ms"],
        "bound_by": k3_main["bound_by"],
        "library_ms": k3_main["library_ms"],
        "redesigned": "history split across blocks with a combine kernel, cp.async ring, "
                      "every warp busy",
    }, {
        "name": "paged_decode_attention",
        "launch_analysis": launch_analysis("K4"),
        "route": "cuda",
        "source": "nnstreamer_tpu_torch/csrc/paged_attention.cu",
        "replaces": "nnstreamer_tpu/ops/pallas/paged_attention.py:202",
        "launches": k4_launches,
        "launches_speculative": spec["k4_launches"],
        "launches_serving_state": state["k4_launches"],
        "launches_llm_plane": plane["llm_plane"]["k4_launches"],
        "launches_edge": edge["k4_launches"],
        "launches_edge_decode_peer": edge["k4_launches_decode_peer"],
        "max_abs_err": k4_main["max_abs_err"],
        "ms": k4_main["kernel_ms"],
        "plain_ms": k4_main["plain_ms"],
        "bound_ms": k4_main["bound_ms"],
        "bound_by": k4_main["bound_by"],
        "library_ms": None,  # no PyTorch call attends through a block table
        "redesigned": "history split across blocks with a combine kernel, cp.async ring, "
                      "every warp busy",
    }, {
        "name": "flash_attention",
        "launch_analysis": launch_analysis("K5"),
        "route": "cuda",
        "source": "nnstreamer_tpu_torch/csrc/flash_attention.cu",
        "replaces": "nnstreamer_tpu/ops/pallas/flash_attention.py:158",
        "launches": k5_launches,
        "max_abs_err": k5_main["max_abs_err"],
        "ms": k5_main["kernel_ms"],
        "plain_ms": k5_main["plain_ms"],
        "bound_ms": k5_main["bound_ms"],
        "bound_by": k5_main["bound_by"],
        "library_ms": k5_main["library_ms"],
        "redesigned": "tensor cores: wgmma with a split P·V (bf16, fp16), 3xTF32 "
                      "mma.sync (float32)",
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def sources_main() -> int:
    """``--sources``: only the model_sources group (K1 built first)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from nnstreamer_tpu_torch.ops.kernels import _build
    from nnstreamer_tpu_torch.ops.kernels import image_kernels as ik
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": gpu_info(), "kind": torch.cuda.get_device_name(0),
          "host_cpus": os.cpu_count(), "host_loadavg_1_5_15": os.getloadavg()})
    _build.build(["image_kernels"])
    out = model_sources_phases(torch, np, torch.device("cuda"), parse_pipeline, ik)
    emit({"phase": "model_sources", "seconds": out["seconds"]})
    return 0


def faults_main() -> int:
    """``--faults``: only the faults group (K1 built first)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from nnstreamer_tpu_torch.ops.kernels import _build
    from nnstreamer_tpu_torch.ops.kernels import image_kernels as ik
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": gpu_info(), "kind": torch.cuda.get_device_name(0),
          "host_cpus": os.cpu_count(), "host_loadavg_1_5_15": os.getloadavg()})
    _build.build(["image_kernels"])
    out = faults_phases(torch, np, torch.device("cuda"), parse_pipeline, ik)
    emit({"phase": "faults", "seconds": out["seconds"]})
    return 0


def observe_main() -> int:
    """``--observe``: only the observe group (K1 built first)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from nnstreamer_tpu_torch.ops.kernels import _build
    from nnstreamer_tpu_torch.ops.kernels import image_kernels as ik
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": gpu_info(), "kind": torch.cuda.get_device_name(0),
          "host_cpus": os.cpu_count(), "host_loadavg_1_5_15": os.getloadavg()})
    _build.build(["image_kernels"])
    out = observe_phases(torch, np, torch.device("cuda"), parse_pipeline, ik)
    emit({"phase": "observe", "seconds": out["seconds"]})
    return 0


def edge_main() -> int:
    """``--edge``: only the edge group (K1 and K4 built first)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from nnstreamer_tpu_torch.ops.kernels import _build
    from nnstreamer_tpu_torch.ops.kernels import image_kernels as ik
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": gpu_info(), "kind": torch.cuda.get_device_name(0),
          "host_cpus": os.cpu_count(), "host_loadavg_1_5_15": os.getloadavg()})
    _build.build(["image_kernels", "paged_attention"])
    out = edge_phases(torch, np, torch.device("cuda"), parse_pipeline, ik)
    emit({"phase": "edge", "seconds": out["seconds"], "k1_launches": out["k1_launches"],
          "k4_launches": out["k4_launches"]})
    return 0


def plane_main() -> int:
    """``--plane``: only the plane group (the kernels it runs built first)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from nnstreamer_tpu_torch.ops.kernels import _build
    from nnstreamer_tpu_torch.ops.kernels import image_kernels as ik
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": gpu_info(), "kind": torch.cuda.get_device_name(0),
          "host_cpus": os.cpu_count(), "host_loadavg_1_5_15": os.getloadavg()})
    _build.build(["image_kernels", "paged_attention"])
    out = plane_phases(torch, np, torch.device("cuda"), parse_pipeline, ik)
    emit({"phase": "plane", "seconds": out["seconds"]})
    return 0


def mesh_main() -> int:
    """``--mesh``: only the mesh group (K1 and K3 built first), with its
    serving check on Mistral-7B-width weights of its own, against an
    unsharded batcher on the same prompts first."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from nnstreamer_tpu_torch.models import serving as sv
    from nnstreamer_tpu_torch.models import transformer as tfm
    from nnstreamer_tpu_torch.ops.kernels import _build
    from nnstreamer_tpu_torch.ops.kernels import image_kernels as ik
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": gpu_info(), "kind": torch.cuda.get_device_name(0),
          "host_cpus": os.cpu_count(), "host_loadavg_1_5_15": os.getloadavg()})
    _build.build(["image_kernels", "decode_attention"])
    dev = torch.device("cuda")
    lm = tfm.init_params(torch.Generator(device=dev).manual_seed(0), **MISTRAL, device=dev)
    prompts = slot_traffic(np, np.random.default_rng(0))[:MESH_SERVE_REQUESTS]
    cb = sv.ContinuousBatcher(lm, MISTRAL["n_heads"], **SERVE, attn_impl="pallas", device=dev)
    drive_requests(cb, [prompts[0][:64]], 4)
    plain = drive_requests(cb, prompts, NEW_TOKENS)
    plain_profile = decode_profile(torch, cb, prompts, 8)
    del cb
    torch.cuda.empty_cache()
    serving = mesh_serving_phase(torch, np, dev, lm, prompts, plain, plain_profile)
    emit(serving)
    del lm
    torch.cuda.empty_cache()
    out = mesh_phases(torch, np, dev, parse_pipeline, ik, serving)
    emit({"phase": "mesh", "seconds": out["seconds"], "k1_launches": out["k1_launches"],
          "k3_launches": out["k3_launches"]})
    return 0


def analysis_main() -> int:
    """``--analysis``: only the analysis group (every kernel built first:
    the analyzer reads each library's launch query)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from nnstreamer_tpu_torch.ops.kernels import _build
    from nnstreamer_tpu_torch.ops.kernels import image_kernels as ik
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": gpu_info(), "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "host_cpus": os.cpu_count(), "host_loadavg_1_5_15": os.getloadavg()})
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    _build.build(sources)
    emit({"phase": "build", "sources": sources, "seconds": time.perf_counter() - t0})
    out = analysis_phases(torch, np, torch.device("cuda"), parse_pipeline, ik)
    emit({"phase": "analysis", "seconds": out["seconds"], "k1_launches": out["k1_launches"]})
    return 0


def train_main() -> int:
    """``--train``: only the train group (it builds no kernel: none runs
    on the training path)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": gpu_info(), "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "host_cpus": os.cpu_count(), "host_loadavg_1_5_15": os.getloadavg()})
    emit(train_phases(torch, np, torch.device("cuda")))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--analysis"] and len(sys.argv) == 2:
        sys.exit(analysis_main())
    if sys.argv[1:2] == ["--train"] and len(sys.argv) == 2:
        sys.exit(train_main())
    if sys.argv[1:2] == ["--mesh"] and len(sys.argv) == 2:
        sys.exit(mesh_main())
    if sys.argv[1:2] == ["--plane"] and len(sys.argv) == 2:
        sys.exit(plane_main())
    if sys.argv[1:2] == ["--sources"] and len(sys.argv) == 2:
        sys.exit(sources_main())
    if sys.argv[1:2] == ["--faults"] and len(sys.argv) == 2:
        sys.exit(faults_main())
    if sys.argv[1:2] == ["--observe"] and len(sys.argv) == 2:
        sys.exit(observe_main())
    if sys.argv[1:2] == ["--edge"] and len(sys.argv) == 2:
        sys.exit(edge_main())
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3:
        sys.exit(ab_main(sys.argv[2]))
    if sys.argv[1:2] == ["--ab-turn"] and len(sys.argv) == 4:
        sys.exit(ab_turn(sys.argv[2], sys.argv[3]))
    sys.exit(main())
