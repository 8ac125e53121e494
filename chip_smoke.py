"""Drive the PyTorch/CUDA port's serving and training paths on one
NVIDIA GPU (with ``--multi-gpu``, its data-parallel paths on four).

    python3 chip_smoke.py [--out results.json] [--seed N] [--profile]
                          [--phases kernels,epilogue,...,compile,observability]
                          [--parent CSRC [--parent CSRC ...]]
    python3 chip_smoke.py --multi-gpu [--out results.json]   # 4 cards
                          [--multi-phases kvstore,...,group2ctx]

Phases (any failure raises and exits non-zero):

1. Device: require CUDA; print the card's name and power limit, and
   whether cv2 and PIL import here (with their versions).
2. Build every hand-written kernel of ``mxtpu_torch/csrc`` with nvcc
   (one process per source, started together) and print the seconds;
   print each kernel instance's registers and spills (the LM's flash
   instances must not spill: the forward's float32 D=64 with and without
   lse, the backward's dK/dV and dQ kernels at D=64 in float32 and
   bfloat16, and the wide pair's three kernels at D <= 256 in both types)
   and, where the toolkit has cuobjdump, count each flash library's
   tensor-core (HMMA) instructions (none is a failure). With ``--parent
   CSRC`` (the ``csrc`` directory of another tree, such as the parent
   commit or a variant of this one; repeatable) also build that tree's
   flash, ROIPooling and CTC sources (those it has), started before
   this tree's so that every nvcc runs at once, and print the same
   figures for them.
3. Flash kernel vs plain: the flash-attention kernel against its plain
   PyTorch version on the card, at the LM path's shapes and at edge
   cases, in float32 (max abs err <= 2e-4) and bfloat16 (<= 2e-2); then,
   at the served shape for B = 1 and 4 in both types, CUDA-event times of
   the kernel, the plain version and the library call that computes the
   same function (timed as a yardstick only; the port never calls it),
   beside the least time the card could take (bound_ms): float32 counted
   as three TF32 tensor-core passes, the route the kernel takes. Then the
   forward and the backward at head dim 96 (d_model 768 over 8 heads),
   which the wrappers zero-pad to the kernel's 128, against the plain
   version, timed beside D=128 at the same shape. Then the wide pair
   (``csrc/flash_attn_wide.cu``, head dims above 128, unpadded, on the
   tensor cores) at D = 129, 160, 192, 256, 512, 513, 640 and 1024, causal
   and not, T != S with T and S not tile multiples, NaN past every end:
   forward and lse against the plain version, backward within 1e-4 (f32)
   / 2e-2 (bf16) of max(1, |plain|) and bit-identical on repeat; timed at
   B=4, H=8, T=1024, D=256 beside the plain versions, SDPA's forward and
   backward, the bounds and the pair's route figure (its own products at
   the tensor-core peak), and at B=1 (its blocks against the SMs); then
   at D = 512, 640 and 1024 (the column blocks' recompute in the route
   figure).
3b. Epilogue kernel vs plain: the BN-apply+ReLU(+residual) kernel
   against its plain version at ResNet-50's bucket-32 sites, channel-minor
   and NCHW, float32 and bfloat16, with and without the residual, a
   ragged M, C = 37 and planted NaN/inf: max abs err must be 0 and the
   NaN positions equal. Then CUDA-event times beside bound_ms (bytes).
   No one PyTorch call computes relu(x*s+b)[+r], so library_ms is null.
3c. Flash backward kernel vs plain: the backward (dq, dk, dv) against
   its plain version on the same q, k, v, o, dO and lse, and the forward
   kernel's lse against the plain lse, at the LM's shapes and at edge
   cases (T, S in {1, 15, 16, 17, 63, 64, 65, 127, 129}, around the 16-row
   warp tiles and the 64-row block tiles; T != S under the causal mask;
   S = 0; D 32/64/128; NaN stored past every tensor's end; storage
   offsets that are not 16-byte aligned), float32 (error / max(1,
   |plain|) <= 1e-4) and bfloat16 (<= 2e-2); a second call must give
   bit-identical dq, dk and dv. Then CUDA-event times at the
   LM's shape beside the plain version, the bound at the card's peak for
   each type (f32 as three TF32 passes, bf16 on the tensor cores; the
   figure of the kernel's own 7-product route printed beside it), SDPA's
   backward alone as the library yardstick, and the forward with and
   without lse. Last, the float32 kernel at B=1, H=1 and the LM's T, S
   and D beside a CPU emulation of its arithmetic, with each MMA's f32
   sum rounded to nearest and truncated as the tensor cores truncate it:
   the errors show which model the card follows (printed, not gated).
   With ``--parent``,
   phases 3 and 3c also time each other tree's kernels on the same
   inputs, in turns: parent, this, this, parent (the wide pair's forward
   and backward in both types too, at D = 256 and 512).
4. LM serving: the transformer LM at GPT-2-small widths with seeded
   random weights, served by ``ServingSession`` on gpu(0) with buckets
   (1, 4): 8 requests of 1024 tokens from 4 client threads. Checks that
   every probability row is finite and sums to 1, that the flash kernel
   ran exactly once per layer per dispatched batch, and that one answer
   matches a ``Predictor`` on cpu() (the plain versions).
5. ResNet-50 serving: pre-activation ResNet-50 v2 at 224x224 with seeded
   random weights and BN statistics, served with buckets (1, 8, 32): 64
   requests from 8 client threads. Checks 50 fused BatchNorm->ReLU sites,
   ``launches == 50 x dispatched batches`` for the epilogue kernel,
   finite rows summing to 1, and one answer against a cpu() Predictor.
6. LM training: the transformer LM at GPT-2-small widths and depth
   trained through ``Module.fit`` on gpu(0) with Adam, from seeded Xavier
   weights, on one seeded batch (B=4, T=1024) repeated 8 times. Checks a
   finite cross-entropy that falls, and exactly one flash forward and one
   flash backward launch per layer per step; prints step ms, tokens/s,
   peak device memory, one step with the fused update against one
   through the Updater in turns, and
   (``--profile``) one step's device time by kernel. Then one SGD step of
   a 2-layer model at full width, B=1, on gpu(0) and on a cpu() Module
   from the same weights, each held to the exact step of a float64
   gradient: the GPU's outputs within TRAIN_OUT_RTOL of the CPU's and its
   distance from the exact step no more than TRAIN_CPU_FACTOR times the
   CPU f32 step's own; a GPU step with TF32 GEMMs must fail both gates.
7. ResNet-50 training through ``Module.fit`` (``resnet_training``;
   see ``phase_resnet_training``).
8. Gluon ResNet-50 training (``gluon``): the zoo's ``resnet50_v2`` at
   224x224, full depth and width, f32 with TF32 off, Xavier weights from
   a numpy seed on gpu(0) (deferred shapes resolved by the first batch),
   ``DataLoader(ArrayDataset(images, labels), batch_size=256)`` over phase
   7's 512 seeded images, ``SoftmaxCrossEntropyLoss`` and
   ``Trainer(..., "sgd", lr 0.1, momentum 0.9).step(256)``: 8 hybridized
   steps of ``autograd.record()`` / ``backward()`` / ``step``, 4 with
   ``hybridize(False)``, 4 hybridized again with ``num_workers=2``.
   Gates: a finite loss that falls, moving statistics that moved,
   ``save_params`` reloaded by a fresh net bit for bit, the hybridized
   evaluation forward (B=256, outside ``record()``) launching the
   epilogue at its 50 fused sites and within 1e-4 of the plain epilogue,
   and the narrow ResNetV2's one SGD step on gpu(0) hybridized and
   imperative held to the float64 step as phase 7 holds resnet-8 (a TF32
   control must fail). Prints step ms (host clock, each step ending in a
   device sync; mean after 2 warm-up steps) and the DataLoader's share of
   it, images/s, MFU, peak memory, and phase 7's Module step beside it.
9. Data parallelism on one card (``data_parallel``): mxtpu's KVStore
   cases on CUDA values, "local" and "device" (a pushed list summed, an
   updater on the store, set_optimizer's SGD with momentum), each pulled
   value bit for bit the same arithmetic on the host; then phase 7's
   ResNet-50 v2 for 4 steps (B=256, 512 images, 2 epochs) through
   ``fit(kvstore="dist_sync")`` on a one-rank NCCL group (the kvstore
   path: every parameter pushed, all-reduced, updated by the Updater on
   the store and pulled): with cuDNN deterministic its weights and
   statistics within 1e-4 (of max(1, |w|)) of the same 4 steps through
   the fused local path (printed: whether bit-identical); then, with
   cuDNN as phase 7 runs it, a finite falling cross-entropy and the
   evaluation forward's 50 epilogue launches within 1e-4 of the plain
   epilogue. Prints its step ms beside phase 7's, and the push/pull
   loop's host ms.
10. The LSTM bucketing LM (``rnn``; BASELINE config 4 at
   example/rnn/lstm_bucketing.py's widths: 2 layers, 200 hidden, 200
   embed, batch 32, buckets 10-60, vocabulary 10,000; f32, TF32 off in
   cuBLAS and cuDNN). The RNN op's cuDNN route against the plain loop on
   the card, outputs and the gradients of data, parameters and both
   states, at the LM's shape (T=60, N=32, I=H=200, L=2) and at edges
   (each mode, bidirectional, T=1, N=1 and batch-1 states, no
   state_outputs, the clip route), within RNN_OP_TOL; both routes' times
   at the LM's shape beside the operations bound (67 TFLOP/s) and
   nn.LSTM's (the library yardstick), and whether torch copies the flat
   vector into cuDNN's buffer. Then ``BucketingModule.fit`` unfused
   (stacked LSTMCell unroll) and ``--fused`` (one FusedRNNCell: cuDNN) on
   a seeded synthetic corpus (1600 sentences of 4-60 ids, the example's
   next-id pattern; PTB is not in the repository), 3 epochs, SGD lr 0.01,
   momentum 0.9, wd 1e-5, clip 1.0, Xavier(in, 2.34). Gates: each
   variant's first step at bucket 60 (loss and every gradient) against
   the same step in float64 on cpu() within RNN_GRAD_TOL, a TF32 control
   step failing it; CE falling over 8 steps of one batch; after fit,
   every bucket's module on the same parameter, gradient and optimizer
   state tensors; the unfused fit on the loop only, the fused on cuDNN.
   Prints per-epoch perplexity, each bucket's step ms (host clock to a
   sync), words/s, kernel launches and device-busy share of a step
   (torch.profiler), peak memory. Last, Gluon's ``rnn.LSTM(200,
   num_layers=2)`` between an Embedding and a Dense(10000): the first
   step's gradients against float64 on cpu(), then SGD ``Trainer.step``s
   imperative and hybridized, timed; the loss must fall.
11. The SSD detector (``ssd``; BASELINE config 5 at example/ssd's
   widths: vgg16_reduced at 300x300, 20 classes, 6 scales, 7,486
   anchors, nms_topk 400; f32, TF32 off; synthetic painted boxes, VOC
   not being in the repository). The suppression kernel against its
   plain version on the card, bit for bit, on the candidates decoded
   from the full-width net's outputs at B=32 and on adversarial sets
   (one class overlapping, IoUs at the threshold, -inf tails,
   force_suppress, NaN boxes, K = 1, 37 and 1,376, -inf and NaN scores
   between live ones), then its CUDA-event time beside the plain
   version's and bound_ms. The same at nms_topk -1 (the op's default):
   all 7,486 candidates of the net's outputs, bit for bit at B=4 (the
   plain version's K x K temporaries), the kernel timed at B=32, the
   plain version at B=4. The first training step
   at B=2 against float64 on the card (the f32 run's targets fed to a
   graph that takes them as variables; the hard-negative margin, the
   hardness drift and the anchors whose float64 target differs printed),
   within SSD_GRAD_TOL, a TF32 control failing it and a cpu() f32 step
   printed. ``Module.fit`` with MultiBoxMetric and examples/ssd/train.py's
   SGD at B=32 (the upstream batch) and B=8 (mxtpu's example's), one
   seeded batch 8 times: CE must fall; step ms, images/s and the share of
   67 TFLOP/s, launches and the device-busy share of a step and the
   MultiBox ops' device ms (torch.profiler), the metric's host copy,
   peak memory; one kernel launch a step. ``get_symbol`` through
   ``Module.forward(is_train=False)`` at B=32 on the trained weights: the
   kernel route's detections equal the plain route's, one launch a
   batch; MApMetric's host ms; then once more at nms_topk -1 and B=4.
   Last, the twin of test_ssd_gate (tiny,
   64x64, 12 epochs of 8 batches) from the port's Xavier draws at seeds
   0-4: each CrossEntropy < 1.2 and checkpoint reloaded bit for bit, the
   mean mAP above max(the mean untrained mAP, 0.05).
12. The inference and inspection surface (``surface``): ResNet-50 v2
   (224x224, seeded weights) over 512 seeded images in an NDArrayIter at
   B=256: ``Module.predict`` bit for bit against ``iter_predict``'s
   batches and within 1e-5 of the same Module's unfused walk, 50 epilogue
   launches a batch, images/s; the feature extractor (``get_internals``
   of the flatten output bound in a new Module) bit for bit against what
   a Monitor with that pattern captures in the full net's sampled
   forward (both walks unfused on a sampled batch), and its own fused
   forward within 1e-5 of it; a ``SequentialModule`` of the ResNet-50
   trunk and a fc1+SoftmaxOutput head, 3 SGD steps at B=64 (TF32 off,
   cuDNN deterministic), within 1e-5 of the single Module from the same
   weights; ``install_monitor`` on one ResNet-50 SGD step at B=64: one
   stat a visible output, the outputs and weights bit for bit against
   the unmonitored fused step, both steps' ms; the port's twin of
   examples/module/python_loss.py on gpu(0) above its 0.9 gate; the LM
   at GPT-2-small widths through the Predictor (``forward_batch`` at
   buckets 1 and 4, ``reshaped``, ``partial_forward`` to the end bit for
   bit against ``forward``, ``load_checkpoint_predictor`` over a port
   checkpoint's ``.params`` bytes bit for bit against the dict-built
   one; 12 flash launches a forward); the LM at d_model 1024 over 4
   heads (head dim 256, 2 layers) served through the Predictor against
   a cpu() one, then one SGD step: the wide forward and backward
   launched once a layer each; the served forward's and the step's ms,
   and with ``--parent`` the same with the other tree's wide pair, in
   turns.
13. The record pipeline (``records``; BASELINE configs 2 and 5 fed from
   ``.rec`` files). Packs, with the port's packers under a temporary
   directory, a train ``.rec``/``.idx`` of 1,280 JPEGs at 256x256 (the
   edge ``im2rec --resize 256`` leaves ImageNet at; labels the
   brightened channel of ``make_rec``'s images, so there is something to
   learn), a val ``.rec`` of 512 and a detection ``.rec`` of 64 painted
   boxes at 300x300, printing each one's seconds and bytes. Then
   ``ImageRecordIter`` alone as train_imagenet.py:65-70 sets it (B=256,
   224x224, shuffle, rand_crop, rand_mirror, the ImageNet means): two
   epochs at 4 and 8 decode threads, images/s beside the ~670 a second
   ResNet-50's in-memory step needs; gates: an epoch at 8 threads twice
   and at 1 thread bit-identical, the first batch equal to a numpy decode
   (cv2, the same drawn crops, mirrors and means), the tail batch's pad
   and wrapped rows, ``ImageRecordUInt8Iter``'s pixels equal to the float
   iterator's. Then config 2 end to end (``train_imagenet_twin``: every
   line of train_imagenet.py:64-106 in the port's names): ResNet-50 v2
   ``Module.fit`` on gpu(0) from the train ``.rec`` through
   ``ResizeIter(train, 5)`` for 2 epochs, SGD lr 0.1, momentum 0.9, wd
   1e-4 with ``MultiFactorScheduler``, ``kvstore="local"``, ``Accuracy``
   and ``TopKAccuracy(top_k=5)``, ``Speedometer``, the val ``.rec``
   scored each epoch; prints the step ms and images/s (medians inside an
   epoch), the iterator's wait each step (host clock), then the same
   module on one record batch: its step from the cpu() batch and from
   the batch on the card, the batch's host-to-card copy (pageable,
   pinned), the card's busy share (the kernels and copies of a profiled
   step over the record-fed median), and phase 7's in-memory fit step by
   the same statistic when phase 7 ran. Gates: a finite cross-entropy that
   ends lower than it starts, the evaluation forward on a val batch with
   50 epilogue launches within 1e-4 of the plain epilogue,
   ``Module.predict`` over the val iterator (2 batches, 50 launches
   each), TopKAccuracy's device sum equal to its host sum. Then config 5:
   the SSD (vgg16_reduced, 300x300, B=32) through ``Module.fit`` from the
   detection ``.rec`` by ``ImageDetRecordIter`` as examples/ssd/
   train.py:81-84 sets it, 2 epochs of 2 steps (step ms, images/s, the
   iterator's wait); gates: a finite loss, the label boxes in [0, 1], the
   suppression kernel once a step; then ``ssd_eval`` through
   ``ImageDetRecordIter`` as evaluate.py:130 sets it: the kernel once a
   batch, bit for bit against its plain loop.
14. The rest of the Python frontend (``frontend``; ROADMAP A.14 and
   C.8-C.13) on phase 7's model and images: ResNet-50 v2 (224x224, 1000
   classes, B=256, f32) initialized by ``Mixed`` (Orthogonal for the FC
   weight, MSRAPrelu for the convolutions, One/Zero for the rest),
   ``Module.fit`` for 2 epochs of 2 steps with Nadam (wd 1e-4) on the
   Updater path, ``Speedometer`` and ``ProgressBar``, one val batch
   scored each epoch with ``LogValidationMetricsCallback``, and a
   composite of Accuracy, TopKAccuracy(5), CrossEntropy and MSE/RMSE/MAE
   against the one-hot label on the device. Gates: a finite loss each
   step; 50 epilogue launches each score, and the evaluation forward's
   50 bit for bit against the plain epilogue; each device metric's sum
   within 1e-6 relative of its host update. Then each new optimizer's 4
   updates at the 2048x1000 FC weight (SGD's multi_precision on float16)
   on gpu(0) against cpu() within 1e-6 of the largest value, SGLD's
   noise by its moments; every ``random`` sampler and ``sample_*`` op,
   2^22 draws on the card, mean and variance within 5 standard errors,
   the same seed the same bits; C.8-C.13 on CUDA tensors against cpu().
   Prints the Nadam step against phase 7's fused SGD step.
15. The rest of the image zoo and the op tranche (``zoo``; ROADMAP
   A.15 and A.7's tensor/nn names): inception_v3, inception_v4 and
   inception_resnet_v2 at 299x299 and googlenet at 224, 1000 classes,
   seeded weights and BN statistics, served at B=32 through
   ``Module.predict`` on gpu(0): probabilities finite and summing to 1,
   the epilogue once per fused site (94, 149, 204, 0), the first rows
   within 1e-4 of a cpu() Predictor's, the evaluation forward within
   1e-4 of the plain epilogue; the epilogue alone at each model's sites,
   its ms beside the bytes bound grouped by plane size (8x8, 17x17,
   35x35, 71x71 and up). inception_v3 trained 3 SGD steps at B=32 through
   ``Module.fit`` (a finite cross-entropy, every weight and moving
   statistic moved). Gluon's densenet121, inceptionv3, mobilenet1.0,
   vgg16_bn, squeezenet1.0 and alexnet from ``get_model``, hybridized,
   one inference forward at B=32 (224; 299 for inceptionv3) with the
   fused-site count and the plain-epilogue gate, then 2 ``Trainer.step``s
   of densenet121 at B=32. Every case of ``tests/op_tranche_cases.py`` on
   CUDA tensors against cpu() (indices out of range included, the
   context synchronized after each), and Gluon's Conv2DTranspose.
16. The Faster R-CNN at the VGG16 widths of MXNet's example/rcnn
   (``rcnn``; ROADMAP A.7's second tranche): ``models.rcnn``'s "vgg16"
   configuration (conv1_1-conv5_3, the RPN at 9 anchors over a 37x62
   conv5_3 map, Proposal at 12,000 / 2,000, ``proposal_target`` as a
   numpy Custom op, ROIPooling 7x7 over 2 x 128 ROIs, fc6/fc7 of 4096,
   21 classes) trained through ``Module`` on gpu(0) at 600x1000, B=2,
   f32 with TF32 off, SGD at the reference's lr 0.001, momentum 0.9 and
   wd 5e-4, conv1 and conv2 fixed, from Xavier weights, on one seeded
   synthetic batch repeated: every loss finite, the combined loss (the
   RPN's and stage 2's cross-entropies and box losses, scaled as their
   gradients are) lower at the last step than at the first; step ms
   (host clock to a sync), the device-busy share of a profiled step, the
   host's share in the Custom op, peak memory; then the test symbol's
   forward (Proposal at 6,000 / 300) on 2 images: 600 ROIs, finite
   probabilities summing to 1. The counts, set to 0 before each: one
   ROIPooling forward and one backward launch a training step, one
   forward for the test forward, one ``multibox_nms`` launch a Proposal
   at K = 12,000 (training) and 6,000 (test). Then the ROIPooling kernels
   alone at the training shape (R = 256, C = 512, 7x7, a 2x512x37x62
   map after a ReLU, ROIs with .5 corners), at the test forward's R = 600
   (forward only) and over one large window (1x8x160x240 at 1/1) against
   their plain version: the forward bit for bit, the backward within
   1e-6 of the largest and bit-identical on repeat, each timed beside
   its plain version and its bytes bound over the map pixels the bins
   cover (no library call: the card has no torchvision), the earlier
   kernels' times beside, the backward's two launches timed apart under the profiler;
   with ``--parent``, the parent's ROIPooling kernels in turns and its
   backward against this tree's bit for bit.
17. The LSTM-OCR trained with CTC (``ctc``): examples/ctc/lstm_ocr.py at
   its defaults (``models/ctc_ocr.py``: 3,072 synthetic digit strips,
   2,764 to train, two LSTMCells of 64 unrolled over T=32 steps of 32
   features, 11 classes with the blank first, B=32, Adam at 0.01,
   Xavier) through ``Module.fit`` on gpu(0) for one epoch (87 steps, the
   last padded): the CTC loss finite and lower over the last 5 steps
   than over the first 5, exactly one ``ctc_loss_fwd`` and one
   ``ctc_loss_bwd`` launch a step; step ms and the device-busy share of
   a profiled step; the prediction module's greedy-decode accuracy on
   the 308 held-out strips (each frame's probabilities summing to 1)
   and the trained graph's loss on gpu(0) against a cpu() Module. One
   Gluon ``CTCLoss`` step under ``autograd.record`` on gpu(0) against
   the CPU (one launch of each kernel). Then the kernel pair
   (``csrc/ctc_loss.cu``) against its plain version on the same card
   tensors at every case of ``tests/final_op_cases.CTC_CASES`` (the
   infeasible alignments at 1e30 with the adjoint gradient, data and
   label lengths, the blank last, interleaved padding, labels >= C, NaN
   logits, an OCR batch) and at a speech shape (T=800, N=32, C=29, 100
   to 200 labels): the loss within 1e-5 relative, the gradient within
   1e-5 of the largest, bit-identical on repeat; each kernel timed at
   the OCR and the speech shapes beside the plain version,
   ``F.ctc_loss`` (forward, and forward+backward), the function's bytes
   bound, this route's bytes (the stored alpha and the backward's
   cotangents) and the scan's route bound (T - 1 steps of one step's
   dependent chain, ``CTC_STEP_CHAIN``, at the card's top SM clock),
   and both gradients held to the float64 plain version. With
   ``--parent``, the other tree's CTC pair in turns with this one at
   both shapes, its loss bit for bit this one's.
18. The sparse NDArray (``sparse``): the sparse example's flow
   (``models/sparse_linear.py``: LibSVMIter's ``CSRNDArray`` batches,
   ``row_sparse_pull`` from a local kvstore holding the weight on the
   card, a row_sparse gradient pushed through the store's SGD) at its
   defaults on gpu(0) for 5 epochs, train accuracy rising; csr·dense and
   csrᵀ·dense (a row_sparse result over the touched columns) at 8,192
   rows x 1,000,000 features with 20 non-zeros a row, each within 1e-5
   of the float64 product on the host and timed beside its bytes bound;
   csr + csr and a retain of half the csrᵀ·dense rows there, on the
   card, against scipy's sum and the rows themselves, timed; every
   linalg and contrib case of ``tests/final_op_cases.py`` on CUDA
   tensors against cpu() (gelqf's cuSOLVER Q and L against LAPACK's).
19. ``dist_async`` and the TCP parameter server (``dist_async``): two
   worker processes (``--kv-worker``) on gpu(0) join from ``env://``;
   rank 0 hosts the async ``KVServer`` and the mlp trains through
   ``fit(kvstore="dist_async")``: rank 1's push is visible to its next
   pull while rank 0 waits at a barrier, the weights are finite and the
   server's versions count every push. Then the launch form: ``python
   -m mxtpu_torch.kvstore_server`` as the server and two workers under
   ``MXTPU_ROLE=worker`` on ``dist_sync``, each on its half of every
   batch: their weights within 1e-6 of one process on the whole batch
   and the same bits on both. Every subprocess has a timeout.
20. The scaffolding layer (``scaffolding``): the LM of phase 4 served by
   ``ServingSession`` behind its HTTP server, a few requests, then
   ``GET /metrics`` and ``GET /v1/metrics`` scraped: the request and
   batch counters, ``span_ms{span="batch[...]"}`` and the ``engine_*``
   series count what was sent, each batch span's parent is one of its
   requests' spans, and the flash forward launches once a layer a batch.
   The LM trained as in phase 6 through ``Module.fit(tuned=...)`` with a
   saved ``TunedConfig`` (``fit.max_in_flight=3``, ``fit.metric_sync=4``)
   in turns with telemetry on, off, off, on (the tuned knobs and the same
   knobs given explicitly alternating): ``_fit_knobs`` is the
   artifact's, the weights of every turn are bit-identical, the ``fit_*``
   series count the steps when on and nothing when off, the flash
   launches are the same in every turn, and the step ms of both settings
   are printed (not gated). A fifth fit pushes a write -> two reads ->
   write chain onto the native ``ThreadedEngine`` mid-fit, in a span
   whose trace id each op's dispatch span carries, and runs the profiler
   (``api`` mode, with its torch.profiler session) around two steps:
   the ops ran in dependency order, ``engine_ops_completed`` counts them,
   ``nd.waitall()`` returns after a slow engine op and a long card kernel
   launched just before it, the chrome trace holds ``fit.step`` and
   ``executor.forward``/``backward`` with their trace ids, and the
   torch.profiler trace the flash kernels. Last, phase 19's launch form
   (``dist_sync`` over the TCP server, the mlp) bare and under
   ``MXTPU_FAULTS`` (ECONNRESET at ``kvstore.push`` and ``kvstore.pull``,
   p = 0.25) with ``MXTPU_KVSTORE_RETRIES=10``: each faulted worker's
   snapshot shows ``fault_injected`` and ``retry_attempts`` above 0 and
   its weights are bit-identical to the bare run's.
21. The compile pipeline (``compile``; see ``phase_compile``).
22. Observability (``observability``, ``OBS``): the LM of phase 6 fit
   8 steps with health off and on from one init, in f32 and under
   ``bf16``: 96 + 96 flash launches each, one step's health rows against
   float64 sums of that step's gradients and weights, the metric
   accumulator's syncs equal, the weights bit for bit, step ms in turns;
   again in f32 with a default-stat Monitor over the attention outputs
   (its taps ride the cadence, the fused step stays armed). A sampled
   ResNet-50 step with the Monitor adapter against an unsampled one and
   the per-op path's (phase 12's row). ResNet-50 v2 fit 3 steps with
   health at B=256: the ledger by origin, ``reconcile()`` at a quiescent
   point (the fit's untracked bytes 0), ``liveness_ledger_check``, the
   evaluation forward's 50 epilogue launches bit for bit the plain
   epilogue. An LR bomb (one divergence at the step that fired it, one
   postmortem); an injected wait at ``executor.device_wait`` past the
   watchdog's deadline (one postmortem naming it, the weights the bare
   fit's); the LM served behind the HTTP server (``/debug/state``,
   ``/debug/trace``, the corpus's service rows); ``python -m
   mxtpu_torch.tune search`` on the card and a ``fit(tuned=...)`` with
   an ``OnlineController`` attached.
23. Continuous serving (``continuous``, ``CONT``): the LM of phase 4 in
   ``ServingSession(mode="continuous", max_in_flight=2)``, 16 requests
   from 4 threads, every served batch bit for bit a direct Predictor on
   gpu(0) at its bucket on the same inputs, 12 flash launches a batch,
   ``rep.dispatch``'s host ms against the batch's device ms; burst and
   continuous in turns (requests/s, ``dispatch_idle_gap_ms``,
   ``refill_latency_ms``, ``batch_exec_ms``, the answer copy's ms);
   ``swap_model`` to a second seeded weight set while 4 threads send (no
   failed request, every batch its version's direct Predictor's, none of
   the old version after the swap returned), ``prewarm`` and a rollback
   with zero program builds. ResNet-50 v2 served continuously: 50
   epilogue launches a batch, each bit for bit the plain epilogue on its
   inputs. Over HTTP (the mlp): 429s past ``max_queue``, a 504 deadline,
   503 after close, ``/healthz``, ``/v1/version``, the three serving
   panels of ``/debug/state``, a kill at ``serving.replica.collect``
   quarantining and respawning the replica. The LR bomb of phase 22 at
   an lr of 1e39 (past f32, ROADMAP C.22).
24. Decode (``decode``, ``DECODE``): the paged attention decoder at
   GPT-2-small's widths on a ``PagedArena`` (the ledger's ``decode_kv``
   at 604 MB with every block live), 16 requests joined equal to alone,
   NaN in every freed block inert, a 900-token prompt joining 4 decoding
   sequences with no prefill stall (the longest gap between tokens),
   ``POST /v1/generate?stream=1``, each ``serving.decode.*`` fault point
   once through ``MXTPU_FAULTS`` with no slot or block leaked, and the
   LSTM LM's step at config 4's widths on a ``SequenceSlotArena``
   (joined equal to alone); tokens/s, step ms by bucket, prefill-chunk
   ms. Decode runs no hand-written kernel (its products are cuBLAS's).
25. Elastic (``elastic``, ``ELASTIC``), under a ``tempfile`` directory
   checked for free disk and removed at the end: the LM of phase 6 (B=4,
   Adam, its seeded weights) trained through ``Module.fit`` over an
   ``NDArrayIter`` of 8 distinct seeded batches, shuffled, 8 steps. In
   f32 and then under ``MXTPU_PIPELINE=bf16``: two uninterrupted fits
   (bit-identical or not, and their relative L2 distance); a fit with
   ``elastic=ElasticConfig(prefix, every_n_steps=2, sync=True)`` killed
   from the batch callback at step 4, whose last generation must hold
   the live params, Adam moments and counters bit for bit (f32 masters
   under bf16); ``fit(resume=prefix)`` to the end: bit for bit the
   uninterrupted run where the repeat was bit-identical, else within 4x
   its distance, with exactly (8 - 4) x 12 flash forwards and as many
   backwards, every one bf16 under bf16. Then elastic off and on
   (``every_n_steps=1``, async) in turns, 3 rounds of 6 steps, the first
   dropped: step ms, the capture's host ms
   (``elastic_snapshot_stall_ms``), host syncs in the capture (torch's
   sync debug mode; must be 0), the writer's ms, bytes and MB/s a
   generation, generations written and coalesced, the clones' device
   bytes and the ledger's drift from the allocator after the fit.
   ResNet-50 v2 (224x224, B=64, SGD) on 256 seeded images for 2 epochs,
   with 64 evaluation images and ``callback.module_checkpoint`` (async)
   at each epoch end, inside ``Supervisor.run``: SIGTERM sent from step
   2's batch callback, the final generation (after step 3) durable
   before ``Preempted`` propagates and bit for bit the live state, the
   SIGTERM handler after ``run`` the one before it, ``fit(resume=True)``
   to the end within 4x the distance of two uninterrupted runs (cuDNN's
   atomics), every evaluation batch's 50 epilogue launches bit for bit
   the plain epilogue on their inputs. The mlp wedged by one injected
   ``executor.device_wait`` past the watchdog's deadline:
   ``Supervisor.run`` retries once from the last generation and ends;
   ``elastic_retries`` and ``elastic_restores`` each +1. Its seconds.
26. Prints the kernels' JSON line (each kernel's launches by path, the
   ``records``, ``frontend``, ``zoo``, ``rcnn``, ``ctc``,
   ``scaffolding``, ``compile``, ``observability``, ``continuous`` and
   ``elastic`` paths included), then the device line last.

``--multi-gpu`` runs, in place of the phases, the data-parallel paths
over 4 cards (it raises below 4 CUDA devices; the default run never
takes it): the kernels built once; the KVStore cases over gpu(0..3) and
a push+pull of ResNet-50's parameter set, timed; each kernel on each of
cuda:1-3 against its plain version there (phases 3, 3b, 3c's gates);
ResNet-50 v2 ``Module.fit`` over [gpu(0..3)], kvstore "device", B=256
(64 a card), 8 steps on the fused path (BatchNorm over the whole batch,
one NCCL all-reduce of the gradients a step), with step ms, images/s
(per chip, against one card at B=64 and at B=256 timed in the same
call), the gradient sum's device and host ms, a step's host ms, peak
memory per card, and gates: a finite falling cross-entropy, replicas'
weights and moving statistics bit-identical, the evaluation forward's
50 epilogue launches on each card within 1e-4 of the plain epilogue;
the LM at phase 6's widths over 4 cards (B=4 a card, Adam, 4 steps:
tokens/s, 12 flash forward and 12 backward launches a step on each
card); ``dist_sync`` with 4 processes, one per card (``--dist-worker``),
NCCL: ResNet-50 v2 for 4 steps, the ranks' weights bit-identical;
Gluon's resnet50_v2 hybridized over 4 cards (``split_and_load``,
``Trainer(kvstore="device")``), 4 steps: step ms and the Trainer's
push/pull host ms; then the mesh: ResNet-50 v2 through
``Module(context=gpu(0)).fit(mesh=4)`` (``multi_mesh``: cross-replica
weight-update sharding, held to the replicated path, the collectives'
device and host ms, optimizer-state bytes a card), ring and Ulysses
attention at the LM's widths over 4 cards (``multi_seq``: held to the
plain attention and its backward in float64, flash launches by card, ms
against ``FlashAttentionFunction`` on one card) and MoE, a pipeline and ``DataParallelTrainer`` each
held to one card, and ``DataParallelTrainer(shard_params=True)`` on a
(2, 2) mesh held to ``shard_params=False``, each card holding half of
every split parameter (``multi_parallel``); then ``group2ctx`` placement
(``multi_group2ctx``): the model-parallel LSTM of
examples/rnn/model_parallel_lstm.py at config 4's widths ('embed_rnn1'
on gpu(0), 'rnn2_head' on gpu(1)) for 4 SGD steps through the Executor
against the same net on gpu(0) alone (outputs and weights within 1e-6;
each group's kernels on its own card under the profiler; step ms and
cross-device copies); last, the tp and fsdp meshes (``mesh_tp``): the
LM at phase 6's widths and depth through ``Module(context=gpu(0)).fit``
on ``mesh="data:2,tp:2"`` and ``"data:2,fsdp:2"``: first FullyConnected's
and Embedding's tp forms on the cards against float64 at the LM's
shapes, and one SGD step at B=4 on each mesh and on gpu(0) alone
against the exact step (the float64 gradient on the host): each mesh
no farther from it than 4 times the one-card step (f32 is far from
exact on this model, phase 6's
``train_step_vs_cpu``); then B=8, SGD with momentum, 4 steps on each
mesh and on the replicated fused path over [gpu(0..3)] from the same
weights: one tp all-reduce a FullyConnected a step (an fsdp all-gather
and reduce-scatter a weight), the first of each collective held to the
host's arithmetic (``CheckedCollectives``), each card's parameter and
optimizer-state bytes within the replicated bytes plus the split ones
over their split factor, 12 flash forward and 12 backward launches a
step on every card; tokens/s per chip beside the replicated run, the
collectives' device ms, each mesh's distance from the replicated
weights. Then Convolution's tp form on the cards against float64 at
ResNet-50's shapes, and ResNet-50 v2 at ``multi_mesh``'s batch for 4
steps under ``data:2,tp:2`` with cuDNN deterministic and the fused
step's collectives in replica order (``OrderedCollectives``): its
weights and statistics after the first and the last step within
max(1e-4, 4x) the one-card path's own distance from the replicated
path, and the evaluation forward's 50 epilogue launches on each card.
``--multi-phases`` runs a subset (then no summary and no device line,
rc 1). Its own summary line, then the device line, last.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import logging
import os
import random
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
# the operations/s of each type the kernels compute in: f32 on the CUDA
# cores, bf16 and TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32_OPS_PER_S = 495e12
# the flash kernel computes an f32 product as three TF32 products
# (3xTF32: big*small + small*big + big*big)
TF32_PASSES = 3
# the flash instances of the LM's paths, float32 D=64: without lse
# (served) and with it (trained)
FLASH_PATH_INSTANCES = ("flash_fwd_kernel<float, 64, false>",
                        "flash_fwd_kernel<float, 64, true>")
# the backward's instances on the LM's shape (D=64), both kernels, both
# types
FLASH_BWD_PATH_INSTANCES = tuple(
    "flash_bwd_%s_kernel<%s, 64>" % (kern, typ)
    for kern in ("dkdv", "dq") for typ in ("float", "bf16"))
# products of 2*D flops for each live pair in the backward: the five the
# gradient needs (S, dP, dV, dK, dQ), and the seven the kernels do (S and
# dP again in the dQ kernel, so that no output needs atomics)
BWD_PRODUCTS = 5
BWD_ROUTE_PRODUCTS = 7

LM = dict(vocab_size=50257, seq_len=1024, num_layers=12, num_heads=12,
          d_model=768, d_ff=3072)  # GPT-2 small (Radford et al. 2019)
BUCKETS = (1, 4)
# LM training (phase 6): Adam on one seeded batch repeated `steps` times
TRAIN = dict(batch=4, steps=8, warmup=2, lr=5e-4)
# the 2-layer GPU vs CPU step: SGD lr, output tolerance (probabilities,
# relative, element by element), and how far from the exact float64 step
# the GPU's f32 step may be, as a multiple of the CPU f32 step's distance.
# On an H100 the f32 GPU step reads 6.7e-6 and 0.34, a step with TF32
# GEMMs 6.7e-4 and 3.4: each gate sits between the two
TRAIN_CPU_LR = 0.01
TRAIN_OUT_RTOL = 5e-5
TRAIN_CPU_FACTOR = 1.0
N_REQUESTS = 8
N_CLIENTS = 4
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# backward: max |kernel - plain| / max(1, max |plain|) over dq, dk, dv.
# f32: both sum in f32, in other orders; bf16: both round their f32 sums
# to bf16 (2^-8 relative), so one bf16 ulp of the largest value
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# forward lse, absolute: ex2.approx and log2f against torch's exp/log
LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}

# pre-activation ResNet-50 v2 (He et al. 2016), mxtpu/models/resnet.py
RESNET = dict(num_classes=1000, num_layers=50, image_shape=(3, 224, 224))
RESNET_SITES = 50  # bn0 + 3 per bottleneck unit x 16 + bn1
RESNET_BUCKETS = (1, 8, 32)
RESNET_REQUESTS = 64
RESNET_CLIENTS = 8
# (shape, channel axis): ResNet-50's bucket-32 extremes, bn0 (112x112x64)
# and bn1 (7x7x2048), channel-minor as the TPU kernel takes them and NCHW
# as the served graph hands them over; a ragged M; C = 37
EPILOGUE_CASES = [((401408, 64), -1), ((1568, 2048), -1),
                  ((32, 64, 112, 112), 1), ((32, 2048, 7, 7), 1),
                  ((1000, 72), -1), ((999, 37), -1)]
EPILOGUE_MAIN = ((32, 64, 112, 112), 1)  # bn0 at bucket 32, as served
# ResNet-50 v2 trained through Module.fit (phase 7), as mxtpu's bench.py
# configures its headline run (bench.py:535-559): B=256, Xavier gaussian
# "in" magnitude 2, SGD lr 0.1, momentum 0.9, rescale 1/B; 512 seeded
# images for 4 epochs (8 steps), prefetched onto the card, a checkpoint
# at each epoch's end
RESNET_TRAIN = dict(batch=256, images=512, epochs=4, warmup=2, lr=0.1,
                    momentum=0.9, copy_steps=3)
# bench.py:23: 3 x (2 x 4.089 GFLOP) a trained image (forward + backward)
RESNET_FLOPS_PER_IMAGE = 3 * 2 * 4.089e9
# the one-step gate of phase 7: resnet-8 at B=32 (mxtpu's tests' size)
RESNET8 = dict(num_classes=10, num_layers=8, image_shape=(3, 28, 28))
RESNET8_BATCH = 32
RESNET8_LR = 0.1
# Gluon's resnet50_v2 trained through autograd.record and Trainer.step
# (phase 8), the loop of examples/gluon/image_classification.py: the same
# 512 images, batch, initializer and SGD as phase 7; 8 hybridized steps
# and 4 imperative with DataLoader(num_workers=0), then 4 hybridized with
# a threaded DataLoader; the one-step gate's net is the zoo's narrowest
# ResNetV2 at resnet-8's size
GLUON_TRAIN = dict(batch=256, hybrid_steps=8, imperative_steps=4,
                   worker_steps=4, num_workers=2, warmup=2, lr=0.1,
                   momentum=0.9)
GLUON_NARROW = dict(layers=[1, 1, 1], channels=[16, 16, 32, 64],
                    classes=10, thumbnail=True)
# phase 9 (data_parallel): phase 7's ResNet-50 for 4 steps through
# fit(kvstore="dist_sync") on a one-rank NCCL group and through the fused
# local path; --multi-gpu: the data-parallel paths over 4 cards
DP_STEPS = 4
MULTI = dict(gpus=4, batch=256, steps=8, lm_batch=4, lm_steps=4,
             dist_steps=4, gluon_steps=4, kv_iters=5)
# BASELINE config 4 (phase 10, rnn): example/rnn/lstm_bucketing.py's
# widths in MXNet v0.11 (2 LSTM layers, 200 hidden, 200 embed, batch 32,
# PTB's 10,000-word vocabulary and buckets) with this repo's example's
# optimizer (examples/rnn/lstm_bucketing.py:107-112), on a seeded
# synthetic corpus (PTB is not in the repository): 1600 sentences of
# 4-60 ids, 3 epochs. The op's cuDNN route is held to the loop within
# RNN_OP_TOL of max(1, |loop|); each first step's gradients to float64
# within RNN_GRAD_TOL of each parameter's largest, its loss within
# RNN_GRAD_TOL relative
RNN_LM = dict(vocab=10000, num_embed=200, num_hidden=200, num_layers=2,
              batch=32, buckets=(10, 20, 30, 40, 50, 60))
RNN_OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-5,
           "clip_gradient": 1.0}
RNN_TRAIN = dict(sentences=1600, lengths=(4, 60), epochs=3, fall_steps=8,
                 timed_steps=5)
# Gluon's LSTM LM (T=35, the PTB word LM's) takes SGD at lr 0.1 on one
# batch, so that its loss falls visibly in 8 steps
RNN_GLUON = dict(seq_len=35, steps=4, lr=0.1)
RNN_OP_TOL = 1e-4
RNN_GRAD_TOL = 1e-4
# --multi-gpu group2ctx: examples/rnn/model_parallel_lstm.py at config
# 4's widths (PTB word-LM's seq 35), SGD lr 0.5 as the example's default
MP_LSTM = dict(hidden=200, vocab=10000, seq_len=35, batch=32, steps=4,
               lr=0.5, tol=1e-6)
# BASELINE config 5 (phase 11, ssd): example/ssd's vgg16_reduced SSD at
# 300x300 with VOC's 20 classes and 6 scales (7,486 anchors, 26.05 M
# parameters), B=32 (the upstream example's batch; mxtpu's example
# defaults to 8, timed beside it), nms_topk 400, on synthetic painted
# boxes (examples/ssd/_synth.py; VOC is not in the repository), SGD with
# examples/ssd/train.py's momentum 0.9 and wd 5e-4 at its lr 1e-3
SSD = dict(num_classes=20, num_scales=6, network="vgg16_reduced",
           data_shape=300, batch=32, small_batch=8, nms_topk=400)
SSD_OPT = {"learning_rate": 1e-3, "momentum": 0.9, "wd": 5e-4}
SSD_TRAIN = dict(fall_steps=8, timed_steps=5, f64_batch=2)
SSD_EVAL = 2  # held-out batches of B=32
# images of the checks at nms_topk -1 (all 7,486 anchors): the plain
# version's K x K temporaries take ~224 MB an image each
SSD_ALL_ANCHORS_BATCH = 4
# 30.2 GMAC an image forward (mxtpu's symbol at 300x300): 60.4 GFLOP,
# three times that with the backward
SSD_FLOPS_PER_IMAGE = 3 * 60.4e9
# the first step against float64 at B=2: each gradient within
# SSD_GRAD_TOL of its largest exact value (floored at 1e-6 of the net's
# largest), cls_prob and loc_loss likewise. On an H100 the f32 step reads
# 5.2e-4 (the first convolutions' bias gradients: sums of 180,000 terms
# of both signs), a step with TF32 in cuBLAS and cuDNN 1.1e-1: the gate
# sits between the two
SSD_GRAD_TOL = 5e-3
# the gate's twin (tests/test_examples_gate.py:91-115) from the port's own
# Xavier draw at each of these numpy seeds
SSD_GATE_SEEDS = (0, 1, 2, 3, 4)
# operations of one IoU and its test: 4 min/max, 2 extents and their 2
# clamps, the product, the union's add and subtract, the quotient, the
# compare (the two areas are counted once a box, not a pair)
NMS_IOU_OPS = 14
# the suppression kernel's two launches (csrc/multibox_nms.cu)
NMS_LAUNCHES = ("nms_matrix_kernel", "nms_sweep_kernel")
# the wide flash pair (head dims above 128): the dims it is held to its
# plain versions at, the timed shape (B, H, T, D), and the wider dims timed
# at that shape (D past 256: the pair's column blocks recompute the scores)
WIDE_DIMS = (129, 160, 192, 256, 512, 513, 640, 1024)
WIDE_TIMED = (4, 8, 1024, 256)
WIDE_WIDER = (512, 640, 1024)
# phase 12: ResNet-50 predict over `images` at B=`batch`; SequentialModule
# and the monitored step at B=`seq_batch`, SGD as phase 7's
SURFACE = dict(images=512, batch=256, seq_batch=64, seq_steps=3, lr=0.1,
               momentum=0.9)
# the LM at d_model 1024 over 4 heads (head dim 256), 2 layers
WIDE_LM = dict(vocab_size=50257, seq_len=1024, num_layers=2, num_heads=4,
               d_model=1024, d_ff=4096)
# its served forward and SGD step timed in turns with another tree's wide
# pair: rounds of (parent, this, this, parent), each time the median of
# `served` or `step` calls
WIDE_LM_TURNS = dict(rounds=10, served=10, step=5)
# examples/module/python_loss.py's settings and its gate (test_examples_
# gate.py's test_python_loss_module_gate)
PYLOSS = dict(epochs=8, batch_size=32, num_examples=1024, seed=4, gate=0.9)
# phase 13: 1,280 + 512 JPEGs at 256x256 (im2rec --resize 256's edge) whose
# labels are the brightened channel (i % 3) of make_rec's images, and 64
# painted-box images at 300x300; B=256 (train_imagenet.py's default);
# ResNet-50's in-memory step of ~381 ms at B=256 needs ~670 images/s
RECORDS = dict(train=1280, val=512, edge=256, label_classes=3, det=64,
               det_edge=300, batch=256, threads=(4, 8), iter_epochs=2,
               need_images_per_s=670, tail_batch=200, uint8_batches=2,
               epochs=2, epoch_size=5, speedometer_period=2,
               memory_steps=4, ssd_batch=32, ssd_epochs=2)
#: phase 16: the Faster R-CNN's configuration in models.rcnn, its batch,
#: the training steps on one repeated batch (the first and last losses
#: gated), the timed steps after them, and the reference's SGD settings
RCNN = dict(config="vgg16", batch=2, fall_steps=6, timed_steps=3,
            lr=0.001, momentum=0.9, wd=0.0005)
#: the ROIPooling kernels timed alone at the training shape: 2 x 128 ROIs
#: over the 2 x 512 x 37 x 62 conv5_3 map, 7x7 bins at 1/16; and at the
#: test forward's 2 x 300 ROIs over the same map
ROI_TIMED = dict(rois=256, test_rois=600, channels=512, shape=(37, 62),
                 image=(600, 1000), pooled=(7, 7), iters=5)
#: the earlier ROIPooling kernels (a thread an output with an int32 tie
#: count; a thread a pixel walking every ROI) at the training shape,
#: forward and backward ms (PERF.md §6, run a3; an H100 80GB HBM3 at
#: 700 W), printed beside this tree's
ROI_EARLIER_MS = {"forward": 0.1276, "backward": 1.7623}
PHASES = ("kernels", "epilogue", "backward", "serving", "resnet", "training",
          "resnet_training", "gluon", "data_parallel", "rnn", "ssd",
          "surface", "records", "frontend", "zoo", "rcnn", "ctc", "sparse",
          "dist_async", "scaffolding", "compile", "observability",
          "continuous", "decode", "elastic")
# phase 25, elastic: the LM of phase 6 over `lm_batches` distinct seeded
# batches (shuffled), `lm_steps` steps, killed at step `kill_at` with a
# generation every `every` steps (sync) and `keep` kept, resumed within
# `resume_factor` x the repeat distance when the repeat is not
# bit-identical; `rounds` rounds of elastic off / on (every step, async)
# of `turn_steps` steps; ResNet-50 v2 at B=`resnet_batch` over
# `resnet_images` images for `resnet_epochs` epochs with `resnet_eval`
# evaluation images, SIGTERM sent from step `sigterm_after`'s callback;
# the mlp wedged by one `wedge_ms` wait at executor.device_wait after
# `wedge_after` waits, past the watchdog's `wedge_wait_s` deadline; the
# free disk wanted, in generations of the LM
ELASTIC = dict(lm_batches=8, lm_steps=8, kill_at=4, every=2, keep=2,
               resume_factor=4.0, rounds=3, turn_steps=6, resnet_batch=64,
               resnet_images=256, resnet_epochs=2, resnet_eval=64,
               resnet_lr=0.1, resnet_momentum=0.9, sigterm_after=2,
               mlp_batch=64, mlp_steps=6, mlp_lr=0.1, wedge_ms=1500,
               wedge_after=3, wedge_wait_s=0.25, wedge_interval_s=0.05,
               disk_generations=4)
# phase 21, the compile pipeline: ResNet-50 v2 predicted under
# (layout, bf16) at B=`batch`; the LM of phase 6 trained TRAIN["steps"]
# steps under bf16; ResNet-50 trained `remat_steps` steps at B=
# `remat_batch` without remat, with fit.remat=auto + remat_reuse and with
# fit.remat=block (`remat_rounds` rounds of turns of `remat_turn_steps`
# steps), and the fused step's update (`update_iters` calls a turn); the
# quantized ResNet-50 after a calibration forward at B=`calib_batch`.
# Times: `rounds` turns (f32, pipeline, pipeline, f32, ...) of `iters`
# calls each. The bf16 LM's cross-entropy may be `lm_ce_rtol` (relative)
# from the f32 fit's at each step: 5.5x the largest reading of a sound
# plan (1.8e-4), and below what a plan with no f32 island but the loss
# head does (1.9e-3 from the second step on, 1.1e-2 by the eighth; NVIDIA
# H100 80GB HBM3, 700.00 W), which the phase runs as its control and
# which must stray past it
COMPILE = dict(batch=32, calib_batch=4, remat_batch=64, remat_steps=3,
               rounds=3, iters=10, lm_turn_steps=3, remat_rounds=2,
               remat_turn_steps=3, update_iters=5, lm_ce_rtol=1e-3, lr=0.1,
               momentum=0.9)
MULTI_PHASES = ("kvstore", "kernels", "resnet", "mesh", "lm", "dist_sync",
                "gluon", "seq", "parallel", "group2ctx", "mesh_tp")
# --multi-gpu mesh_tp: the LM at phase 6's widths on 2-D meshes of the 4
# cards, B=8, SGD with momentum; each card's bytes may exceed the
# replicated ones plus the split ones over their factor by slack_bytes;
# a mesh's first step may be exact_factor times farther from the float64
# step than the one-card step
MESH_TP = dict(batch=8, steps=4, lr=0.01, momentum=0.9,
               meshes=("data:2,tp:2", "data:2,fsdp:2"),
               resnet_mesh="data:2,tp:2", slack_bytes=0, exact_factor=4.0)
# phase 20: the served requests, the trained fit's knobs (a TunedConfig)
# and the turns of telemetry on and off; the faulted launch form's schedule
# and retries (each worker's pushes and pulls fail with p = 0.25)
SCAFFOLD = dict(requests=4, clients=2, max_in_flight=3, metric_sync=4,
                turns=(True, False, False, True), profiled_steps=(5, 6),
                engine_step=3, engine_op_s=0.02, faults=(
                    "kvstore.push:kind=errno,errno=ECONNRESET,p=0.25,seed=7;"
                    "kvstore.pull:kind=errno,errno=ECONNRESET,p=0.25,seed=8"),
                retries=10)
# dist_async: the mlp (784-128-64-10) on seeded images, a global batch of
# 64 (32 a worker), 2 epochs; each subprocess's time limit in seconds
KV_ASYNC = dict(examples=512, batch=64, epochs=2, lr=0.1, timeout=300)


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of fn() over ``iters`` back-to-back calls. The
    calls queue behind a spin kernel that outlasts their host-side cost,
    so the card runs them back to back even where one call takes longer
    on the host than on the card (a ~20 us kernel behind its Python
    wrapper)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0  # host and device, an upper bound
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # ~2e9 cycles a second at the card's top clock: spin at least as long
    # as twice the host time of the calls, at most ~1 s
    torch.cuda._sleep(int(min(2.0 * call_s * iters, 1.0) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_pairs(t, s, causal):
    """Live (row, key) pairs of one head: every pair, or under the causal
    mask (col <= row, top-left) min(row + 1, S) keys for each row."""
    if not causal:
        return t * s
    n = min(t, s)
    return n * (n + 1) // 2 + max(t - s, 0) * s


def attention_flops(b, h, t, s, d, causal):
    """Flops of the attention forward: live (row, key) pairs times 4*d
    (q.k and p.v, a multiply and an add each)."""
    return 4.0 * d * attention_pairs(t, s, causal) * b * h


def attention_bound_ms(b, h, t, s, d, causal, dtype):
    """Least time for the attention forward: its operations on the
    tensor cores (f32 as TF32_PASSES TF32 passes at the TF32 peak, bf16 at
    the bf16 peak), or q, k, v read and o written once against the HBM
    rate, whichever is larger."""
    flops = attention_flops(b, h, t, s, d, causal)
    if dtype == torch.float32:
        ops_ms = TF32_PASSES * flops / PEAK_TF32_OPS_PER_S * 1e3
    else:
        ops_ms = flops / PEAK_OPS_PER_S[dtype] * 1e3
    nbytes = (2 * b * h * t * d + 2 * b * h * s * d) * \
        torch.empty((), dtype=dtype).element_size()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def cuda_core_ms(b, h, t, s, d, causal):
    """The f32 flops against the CUDA cores' f32 peak: the bound of the
    earlier CUDA-core kernel, printed beside the tensor-core bound for
    continuity."""
    return attention_flops(b, h, t, s, d, causal) / \
        PEAK_OPS_PER_S[torch.float32] * 1e3


def ptxas_instances(text):
    """(kernel instance, registers, spill store bytes, spill load bytes)
    of each entry function that one ``nvcc -Xptxas -v`` log reports."""
    rows, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _instance_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1))) + spill)
            name, spill = None, (0, 0)
    return rows


def _instance_name(sym):
    """'flash_fwd_kernel<float, 64, false>' from a mangled template name
    (the argument forms csrc/ uses: float, bf16, int, bool)."""
    m = re.search(r"([a-z_]+_kernel)I(.*?E)E", sym)
    if not m:
        return sym
    words = {"f": "float", "13__nv_bfloat16": "bf16", "Lb0E": "false",
             "Lb1E": "true"}
    args = re.findall(r"13__nv_bfloat16|Li\d+E|Lb[01]E|f", m.group(2))
    return "%s<%s>" % (m.group(1), ", ".join(words.get(a, a[2:-1])
                                             for a in args))


def sass_hmma(path):
    """HMMA instructions in a library's SASS (cuobjdump -sass), or None
    where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, check=True, timeout=300)
    return sum("HMMA" in line for line in out.stdout.splitlines())


def check_flash_build(build):
    """The flash instances of the LM's paths (and every instance of the
    wide pair) do not spill, and each flash library's SASS (where the
    toolkit has cuobjdump) holds tensor-core HMMA instructions. Returns
    {library: HMMA count}."""
    counts = {}
    for lib, names in (("flash_attn_fwd", FLASH_PATH_INSTANCES),
                       ("flash_attn_bwd", FLASH_BWD_PATH_INSTANCES),
                       ("flash_attn_wide", None)):
        inst = {row[0]: row for row in
                ptxas_instances(build.build_log[lib]["ptxas"])}
        if names is None:
            names = sorted(inst) or ["every instance"]
        for name in names:
            row = inst.get(name)
            if row is None:
                # reused from an earlier build of the same source: no log
                log("  %s: %s: no ptxas log (library reused)" % (lib, name))
            elif row[2] or row[3]:
                raise AssertionError("%s spills: %s" % (name, row))
        hmma = sass_hmma(build._target(lib)[1])
        if hmma is None:
            log("  %s: no cuobjdump, SASS not checked" % lib)
            continue
        log("  %s: %d HMMA instructions in the SASS (cuobjdump -sass)"
            % (lib, hmma))
        if hmma == 0:
            raise AssertionError("%s has no HMMA instruction" % lib)
        counts[lib] = hmma
    return counts


class ParentKernels:
    """Another tree's flash, ROIPooling and CTC sources (``--parent``: its
    ``csrc`` directory; those of NAMES it holds), built with this tree's
    nvcc flags into ``build/mxtpu_torch/parent<index>``, the flash ones
    bound by ``attention.bind``, to time them in turns with this tree's
    kernels on the same inputs through the wrappers' own launch code
    (``attention._launch``, ``_launch_bwd``), ROIPooling's by
    ``roi_binding`` and CTC's by ``ctc_binding``. ``kernels`` maps each
    launcher (``attention._SOURCE``), "roi_pooling" and "ctc_loss" to its
    binding."""

    NAMES = ("flash_attn_fwd", "flash_attn_bwd", "flash_attn_wide",
             "roi_pooling", "ctc_loss")

    def __init__(self, build, csrc, index=0):
        self.csrc = csrc
        self.dir = build.BUILD_DIR / ("parent%d" % index)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._procs = {}
        for name in self.NAMES:
            src = os.path.join(csrc, name + ".cu")
            if not os.path.exists(src):
                log("  parent %s: no %s.cu" % (csrc, name))
                continue
            out = self.dir / ("lib%s.so" % name)
            self._procs[name] = (build.spawn(src, out), out)
        self.kernels, self.ptxas, self.hmma = {}, {}, {}

    def finish(self, att):
        """Wait for the builds started by __init__, bind the libraries and
        print their registers, spills and HMMA counts."""
        import ctypes
        for name, (proc, out) in self._procs.items():
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise AssertionError("%s %s does not build:\n%s"
                                     % (self.csrc, name, text))
            self.ptxas[name] = ptxas_instances(text)
            self.hmma[name] = sass_hmma(out)
            lib = ctypes.CDLL(str(out))
            if name == "roi_pooling":
                self.kernels[name] = roi_binding(
                    lib, roi_takes_tie_count(os.path.join(self.csrc,
                                                          name + ".cu")))
            if name == "ctc_loss":
                self.kernels[name] = ctc_binding(
                    lib, ctc_takes_scratch(os.path.join(self.csrc,
                                                        name + ".cu")))
            for launcher, source in att._SOURCE.items():
                if source == name:
                    self.kernels[launcher] = att.bind(lib, launcher)
            for inst, regs, st, ld in self.ptxas[name]:
                log("  parent %s %s: %s: %d registers, %d bytes spill "
                    "stores, %d bytes spill loads" % (self.csrc, name, inst,
                                                      regs, st, ld))
            log("  parent %s %s: %s HMMA instructions" % (self.csrc, name,
                                                          self.hmma[name]))
        return self


def in_turns(parent_fn, this_fn, iters):
    """CUDA-event ms of two versions of one call, in turns: parent, this,
    this, parent. Returns ([parent ms], [this ms])."""
    p1 = cuda_ms(parent_fn, iters)
    t1 = cuda_ms(this_fn, iters)
    t2 = cuda_ms(this_fn, iters)
    p2 = cuda_ms(parent_fn, iters)
    return [p1, p2], [t1, t2]


def phase_kernels(att, gen, parents=()):
    """Flash kernel vs its plain version; returns the timed rows (f32 and
    bf16 at each bucket of the served shape) and the worst error by type.
    With ``parents`` (ParentKernels), each timed row also holds each other
    tree's forward and this tree's, timed in turns on the same inputs."""
    F = torch.nn.functional
    cases = [  # (B, H, T, S, D, causal)
        (1, 12, 1024, 1024, 64, True),   # the served shapes: bucket 1 ...
        (4, 12, 1024, 1024, 64, True),   # ... and bucket 4
        (4, 12, 1024, 1024, 64, False),
        (2, 12, 1000, 1000, 64, True),   # ragged tail
        (2, 12, 256, 1000, 64, True),    # T != S, top-left causal
        (2, 12, 256, 1000, 64, False),
        (2, 8, 512, 512, 128, True),     # D = 128
        (2, 8, 300, 300, 32, False),     # D = 32
    ]
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, t, s, d, causal in cases:
            q = torch.randn(b, h, t, d, device="cuda", generator=gen) \
                .to(dtype)
            k = torch.randn(b, h, s, d, device="cuda", generator=gen) \
                .to(dtype)
            v = torch.randn(b, h, s, d, device="cuda", generator=gen) \
                .to(dtype)
            got = att.flash_attention(q, k, v, causal=causal)
            want = att.flash_attention_reference(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            finite = bool(torch.isfinite(got).all().item())
            log("  flash %-8s B=%d H=%d T=%d S=%d D=%d causal=%d  "
                "max_abs_err=%.3e" % (str(dtype).split(".")[1], b, h, t, s,
                                      d, causal, err))
            if not finite or not err <= TOL[dtype]:
                raise AssertionError(
                    "flash kernel disagrees with its plain version: err %r "
                    "> %r (finite=%s) at %s" % (err, TOL[dtype], finite,
                                                (b, h, t, s, d, causal,
                                                 dtype)))
            worst[dtype] = max(worst.get(dtype, 0.0), err)

    timed = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for b in BUCKETS:
            h, t, d = 12, 1024, 64
            q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
                       .to(dtype) for _ in range(3))
            got = att.flash_attention(q, k, v, causal=True)
            want = att.flash_attention_reference(q, k, v, causal=True)
            err = (got.float() - want.float()).abs().max().item()
            if not err <= TOL[dtype]:
                raise AssertionError("flash kernel disagrees at the served "
                                     "shape: %r (%s, B=%d)" % (err, name, b))
            ms = cuda_ms(lambda: att.flash_attention(q, k, v, causal=True),
                         50)
            plain_ms = cuda_ms(
                lambda: att.flash_attention_reference(q, k, v, causal=True),
                10)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), 50)
            bound_ms, bound_by = attention_bound_ms(b, h, t, t, d, True,
                                                    dtype)
            row = dict(dtype=name, B=b, max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
            extra = ""
            if dtype == torch.float32:
                row["cuda_core_ms"] = cuda_core_ms(b, h, t, t, d, True)
                extra = "; CUDA-core f32 figure %.4f ms" % row["cuda_core_ms"]
            log("  flash %s causal B=%d H=%d T=S=%d D=%d: kernel %.4f ms, "
                "plain %.4f ms, sdpa %.4f ms (kernel/sdpa %.2f), bound %.4f "
                "ms (%s; kernel at %.1f%% of it)%s, err %.3e"
                % (name, b, h, t, d, ms, plain_ms, lib_ms, ms / lib_ms,
                   bound_ms, bound_by, 100.0 * bound_ms / ms, extra, err))
            row["turns"] = []
            for parent in parents:
                this_k = att._kernel()
                pk = parent.kernels["flash_attn_fwd"]
                scale = d ** -0.5
                perr = (att._launch(pk, q, k, v, True, scale).float()
                        - got.float()).abs().max().item()
                p_ms, t_ms = in_turns(
                    lambda: att._launch(pk, q, k, v, True, scale),
                    lambda: att._launch(this_k, q, k, v, True, scale), 50)
                row["turns"].append(dict(parent=parent.csrc, parent_ms=p_ms,
                                         this_ms=t_ms, max_abs_diff=perr))
                log("    in turns with %s (parent, this, this, parent): "
                    "%.4f, %.4f, %.4f, %.4f ms; max abs diff %.3e"
                    % (parent.csrc, p_ms[0], t_ms[0], t_ms[1], p_ms[1], perr))
            timed.append(row)
    return timed, worst


def backward_flops(b, h, t, s, d, causal, products=BWD_PRODUCTS):
    """Flops of the attention backward: ``products`` products of 2*d
    flops for each live pair; by default the five that the gradient needs
    (S, dP, dV, dK, dQ). The kernels do seven (BWD_ROUTE_PRODUCTS)."""
    return products * 2.0 * d * attention_pairs(t, s, causal) * b * h


def _tensor_core_ms(flops, dtype):
    """``flops`` at the card's tensor-core peak for ``dtype``: f32 as
    TF32_PASSES TF32 passes at the TF32 peak, bf16 at the bf16 peak."""
    if dtype == torch.float32:
        return TF32_PASSES * flops / PEAK_TF32_OPS_PER_S * 1e3
    return flops / PEAK_OPS_PER_S[dtype] * 1e3


def backward_bound_ms(b, h, t, s, d, causal, dtype):
    """Least time for the attention backward at the card's peak for its
    type, as the forward's bound counts it: f32 as TF32_PASSES TF32
    passes at the TF32 peak (3xTF32 keeps f32-grade error), bf16 at the
    bf16 tensor-core peak; or q, k, v, o, dO read and dq, dk, dv written
    once plus the f32 lse, against the HBM rate; whichever is larger."""
    ops_ms = _tensor_core_ms(backward_flops(b, h, t, s, d, causal), dtype)
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = (4 * b * h * t * d + 4 * b * h * s * d) * esize + b * h * t * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def backward_route_ms(b, h, t, s, d, causal, dtype):
    """The least time of the kernels' own route: its seven products at
    the type's tensor-core peak (f32 as three TF32 passes), printed beside
    the bound."""
    return _tensor_core_ms(backward_flops(b, h, t, s, d, causal,
                                          BWD_ROUTE_PRODUCTS), dtype)


def wide_tiling(mt, d, dtype, backward=False):
    """The wide pair's launch at head dim ``d`` for ``dtype``, forward or
    (``backward``) the dK/dV and dQ kernels, as the built library reports
    it (``flash_attn_wide_tiling`` in csrc/flash_attn_wide.cu): {"columns":
    output columns a block, "rows": stationary rows a block, "blocks":
    column blocks a row tile}."""
    import ctypes
    fn = mt.build.load("flash_attn_wide").flash_attn_wide_tiling
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    if fn(d, code, int(backward), out) != 0:
        raise AssertionError("flash_attn_wide_tiling refuses D=%d" % d)
    return dict(zip(("columns", "rows", "blocks"), out))


def wide_route_flops(b, h, t, s, d, causal, z, backward=False):
    """Flops of the wide pair's own route (csrc/flash_attn_wide.cu): each
    of its ``z`` column blocks (wide_tiling's "blocks") computes the scores
    (and, in the backward, dP, in both of its kernels) over all of D, and
    its own columns' products: the forward 2 D (Z + 1) a live pair, the
    backward 2 D (4 Z + 3). At Z = 1 these are the forward's 4 D and the
    seven products of BWD_ROUTE_PRODUCTS."""
    per_pair = 2.0 * d * ((4 * z + 3) if backward else (z + 1))
    return per_pair * attention_pairs(t, s, causal) * b * h


def abs_err(got, want):
    """max |got - want| in f32 (inf on a NaN)."""
    if got.numel() == 0:
        return 0.0
    g = got.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    return (g - want.float()).abs().max().item()


def rel_err(got, want):
    """max |got - want| / max(1, max |want|), in f32 (inf on a NaN)."""
    if got.numel() == 0:
        return 0.0
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    return ((g - w).abs().max() / w.abs().max().clamp(min=1.0)).item()


def tf32_round(x):
    """f32 rounded to TF32 (10 stored mantissa bits): to nearest, ties away
    from zero, as the kernels' tf32_rna rounds (csrc/mma_sm90.cuh)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def emulated_matmul(a, b, passes, acc="rn"):
    """a @ b (f32, on the CPU) as the kernels' mma.sync m16n8k8 forms it:
    TF32 operands, one pass (big*big) or 3xTF32 (small*big, big*small,
    big*big, in that order, with x = big + small), products exact (11
    by 11 bits fit in f32), in steps of 8 along the reduction. After each
    MMA the f32 accumulator is the exact sum of it and the 8 products
    rounded to nearest (``acc="rn"``), or (``"tc"``) that sum as the
    tensor cores form it: each of the 9 addends truncated toward zero to
    2 bits below the f32 ulp of the largest of them, then the sum
    truncated to f32. Phase 3c holds the kernel against both."""
    ab, bb = tf32_round(a), tf32_round(b)
    parts = [(ab, bb)] if passes == 1 else [
        (tf32_round(a - ab), bb), (ab, tf32_round(b - bb)), (ab, bb)]
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in parts:
            x8, y8 = x[..., k0:k0 + 8], y[..., k0:k0 + 8, :]
            if acc == "rn":
                out = (out.double() + x8.double() @ y8.double()).float()
                continue
            terms = x8.unsqueeze(-1) * y8.unsqueeze(-3)
            top = torch.maximum(terms.abs().amax(dim=-2), out.abs())
            # addends in units of the grid 2^(e - 26), truncated: integers
            # below 2^26, whose sum of 9 is exact in int64
            inv = torch.ldexp(torch.ones_like(top), 26 - torch.frexp(top)[1])
            units = terms.mul_(inv.unsqueeze(-2)).trunc_().long().sum(dim=-2)
            units += out.mul(inv).trunc_().long()
            exact = units.double() / inv.double()
            out = exact.float()
            out = torch.where(out.double().abs() > exact.abs(),
                              torch.nextafter(out, torch.zeros_like(out)),
                              out)
    return out


def emulated_backward(q, k, v, out, g, lse, causal, passes, acc="rn"):
    """(dq, dk, dv) with the f32 arithmetic of csrc/flash_attn_bwd.cu on
    the CPU: S = Q K^T and dP = dO V^T by ``emulated_matmul``, P =
    exp(S*scale - lse) and dS = P (dP - delta) in f32, then dV = P^T dO,
    dK = dS^T Q and dQ = dS K by ``emulated_matmul`` (P and dS split like
    any other operand), each accumulated in one register over the whole
    reduction as the kernels accumulate it."""
    t, s, d = q.shape[2], k.shape[2], q.shape[3]
    scale = d ** -0.5
    delta = (g * out).sum(dim=-1, keepdim=True)
    p = torch.exp(emulated_matmul(q, k.transpose(-1, -2), passes, acc)
                  * scale - lse.unsqueeze(-1))
    if causal:
        p = p.masked_fill(torch.arange(s)[None, :] > torch.arange(t)[:, None],
                          0.0)
    ds = p * (emulated_matmul(g, v.transpose(-1, -2), passes, acc) - delta)
    dv = emulated_matmul(p.transpose(-1, -2), g, passes, acc)
    dk = emulated_matmul(ds.transpose(-1, -2), q, passes, acc) * scale
    dq = emulated_matmul(ds, k, passes, acc) * scale
    return dq, dk, dv


def backward_numerics(att, gen, case=(1, 1, 1024, 1024, 64, True)):
    """Where the f32 backward's error comes from: the kernel's dq, dk, dv
    at the LM's T, S and D, and the CPU emulation of its arithmetic
    (``emulated_backward``, 3xTF32) with each MMA's sum rounded to
    nearest and truncated as the tensor cores truncate it, each held
    against the plain version and the kernel (scaled as BWD_TOL scales).
    Returns the errors."""
    b, h, t, s, d, causal = case
    q, k, v, g = (x.cpu() for x in bwd_inputs(b, h, t, s, d, torch.float32,
                                              gen))
    out, lse = att.flash_attention_reference(q, k, v, causal=causal,
                                             return_lse=True)
    want = att.flash_attention_backward_reference(q, k, v, out, g, lse,
                                                  causal=causal)
    got = [x.cpu() for x in att.flash_attention_backward(
        *(x.cuda() for x in (q, k, v, out, g, lse)), causal=causal)]
    model = {acc: emulated_backward(q, k, v, out, g, lse, causal, 3, acc)
             for acc in ("rn", "tc")}

    def err(x, y):
        return max(rel_err(a, w) for a, w in zip(x, y))

    row = dict(case=list(case), kernel_vs_plain=err(got, want),
               rn_model_vs_plain=err(model["rn"], want),
               tc_model_vs_plain=err(model["tc"], want),
               kernel_vs_rn_model=err(got, model["rn"]),
               kernel_vs_tc_model=err(got, model["tc"]))
    log("  f32 backward numerics at B=%d H=%d T=%d S=%d D=%d causal=%d "
        "(scaled): kernel vs plain %.3e; 3xTF32 model vs plain, MMA sums "
        "rounded to nearest %.3e, truncated as the tensor cores do %.3e; "
        "kernel vs the round-to-nearest model %.3e, vs the truncating "
        "model %.3e" % (b, h, t, s, d, causal, row["kernel_vs_plain"],
                        row["rn_model_vs_plain"], row["tc_model_vs_plain"],
                        row["kernel_vs_rn_model"],
                        row["kernel_vs_tc_model"]))
    return row


def bwd_inputs(b, h, t, s, d, dtype, gen, offset=0, nan_tail=0):
    """q, k, v, dO of one backward case. Each is a contiguous view
    ``offset`` elements into a buffer whose other elements (before the
    view and ``nan_tail`` after it) are NaN, which the kernel must never
    read."""
    def make(n):
        numel = b * h * n * d
        buf = torch.full((offset + numel + nan_tail,), float("nan"),
                         device="cuda", dtype=dtype)
        buf[offset:offset + numel] = torch.randn(
            numel, device="cuda", generator=gen).to(dtype)
        return buf[offset:offset + numel].view(b, h, n, d)
    return tuple(make(n) for n in (t, s, s, t))


def flash_head_dim_96(att, gen, b=4, h=8, t=1024):
    """The forward and the backward at head dim 96, which the wrappers
    zero-pad to the kernel's 128 (and slice back), against the plain
    version at the LM's T, causal, in float32 and bfloat16; then
    CUDA-event times of both beside the same calls at D=128 on the same
    shape (the padded D=96 moves the bytes of D=128) and beside bound_ms
    at the true D."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        row = {"dtype": name, "B": b, "H": h, "T": t}
        for d in (96, 128):
            q, k, v, g = (torch.randn(b, h, t, d, device=gen.device,
                                      generator=gen).to(dtype)
                          for _ in range(4))
            got = att.flash_attention(q, k, v, causal=True)
            out, lse = att.flash_attention_reference(q, k, v, causal=True,
                                                     return_lse=True)
            err = abs_err(got, out)
            grads = att.flash_attention_backward(q, k, v, out, g, lse,
                                                 causal=True)
            want = att.flash_attention_backward_reference(q, k, v, out, g,
                                                          lse, causal=True)
            torch.cuda.synchronize()
            bwd_err = max(rel_err(a, w) for a, w in zip(grads, want))
            del grads, want
            if not err <= TOL[dtype] or not bwd_err <= BWD_TOL[dtype]:
                raise AssertionError(
                    "flash at D=%d disagrees with its plain version: forward "
                    "%r, backward %r (%s)" % (d, err, bwd_err, name))
            ms = cuda_ms(lambda: att.flash_attention(q, k, v, causal=True),
                         20)
            bwd_ms = cuda_ms(lambda: att.flash_attention_backward(
                q, k, v, out, g, lse, causal=True), 20)
            bound_ms, bound_by = attention_bound_ms(b, h, t, t, d, True,
                                                    dtype)
            bwd_bound_ms, bwd_bound_by = backward_bound_ms(b, h, t, t, d,
                                                           True, dtype)
            row["D%d" % d] = dict(
                max_abs_err=err, bwd_scaled_err=bwd_err, ms=ms,
                bwd_ms=bwd_ms, bound_ms=bound_ms, bound_by=bound_by,
                bwd_bound_ms=bwd_bound_ms, bwd_bound_by=bwd_bound_by)
            if d == 96:
                row["D96"]["plain_ms"] = cuda_ms(
                    lambda: att.flash_attention_reference(q, k, v,
                                                          causal=True), 5)
                row["D96"]["library_ms"] = cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, is_causal=True), 20)
        a, c = row["D96"], row["D128"]
        log("  flash %s causal B=%d H=%d T=S=%d D=96 (padded to 128): "
            "forward %.4f ms (D=128: %.4f), bound %.4f ms (%s), plain %.4f "
            "ms, sdpa %.4f ms, err %.3e; backward %.4f ms (D=128: %.4f), "
            "bound %.4f ms (%s), scaled err %.3e"
            % (name, b, h, t, a["ms"], c["ms"], a["bound_ms"], a["bound_by"],
               a["plain_ms"], a["library_ms"], a["max_abs_err"], a["bwd_ms"],
               c["bwd_ms"], a["bwd_bound_ms"], a["bwd_bound_by"],
               a["bwd_scaled_err"]))
        rows.append(row)
    return rows


def check_bwd_case(att, case, dtype, gen, offset=0, nan_tail=0):
    """The backward kernel against its plain version on one case, the
    forward kernel's lse against the plain lse, and a second call bit
    for bit against the first. Returns the scaled error."""
    b, h, t, s, d, causal = case
    name = str(dtype).split(".")[1]
    q, k, v, g = bwd_inputs(b, h, t, s, d, dtype, gen, offset, nan_tail)
    out, lse = att.flash_attention_reference(q, k, v, causal=causal,
                                             return_lse=True)
    if nan_tail:  # the lse too, past its end
        buf = torch.full((lse.numel() + nan_tail,), float("nan"),
                         device="cuda")
        buf[:lse.numel()] = lse.reshape(-1)
        lse = buf[:lse.numel()].view(lse.shape)
    got_o, got_lse = att._flash_cuda(q, k, v, causal, d ** -0.5,
                                     want_lse=True)
    fin = torch.isfinite(lse)
    lse_err = 0.0
    if bool(fin.any()):
        lse_err = (got_lse[fin] - lse[fin]).abs().max().item()
    if not torch.equal(torch.isfinite(got_lse), fin) or \
            not lse_err <= LSE_TOL[dtype]:
        raise AssertionError("flash forward lse disagrees: %r at %s"
                             % (lse_err, (case, name)))
    got = att.flash_attention_backward(q, k, v, out, g, lse, causal=causal)
    again = att.flash_attention_backward(q, k, v, out, g, lse,
                                         causal=causal)
    want = att.flash_attention_backward_reference(q, k, v, out, g, lse,
                                                  causal=causal)
    torch.cuda.synchronize()
    err = max(rel_err(a, w) for a, w in zip(got, want))
    same = all(torch.equal(a, r) for a, r in zip(got, again))
    log("  flash bwd %-8s B=%d H=%d T=%d S=%d D=%d causal=%d%s  "
        "err(dq,dk,dv)=%.3e lse_err=%.3e repeat=%s"
        % (name, b, h, t, s, d, causal,
           (" offset=%d" % offset if offset else "")
           + (" nan_tail" if nan_tail else ""), err, lse_err,
           "bit-identical" if same else "DIFFERS"))
    if not err <= BWD_TOL[dtype]:
        raise AssertionError(
            "flash backward kernel disagrees with its plain version: %r > "
            "%r at %s" % (err, BWD_TOL[dtype], (case, name, offset)))
    if not same:
        raise AssertionError("flash backward is not deterministic: a "
                             "second call differs at %s" % ((case, name),))
    return err


def phase_backward(att, gen, parents=()):
    """Flash backward kernel vs its plain version on the same q, k, v, o,
    dO and lse (the plain forward's), and the forward kernel's lse vs the
    plain lse: at the LM's shapes and at edge cases, in float32 (error
    scaled by max(1, max |plain|) <= BWD_TOL) and bfloat16, each call
    repeated and held bit for bit. Then, at the LM's shape, CUDA-event
    times beside the plain version, the bound, the route's figure and
    SDPA's backward alone (torch.autograd.grad on a retained graph; timed
    as a yardstick only, never called by the port); with ``parents``,
    each other tree's backward and this tree's in turns. Returns the
    timed rows and the worst error by type."""
    F = torch.nn.functional
    cases = [(1, 12, 1024, 1024, 64, True), (4, 12, 1024, 1024, 64, True),
             (2, 4, 1024, 1024, 64, False)]
    # around the 16-row warp tiles and the 64-row block tiles, T != S
    # under the causal mask (top-left), a single key or row, no key
    for t, s in [(1, 1), (15, 15), (16, 16), (17, 17), (63, 63), (64, 64),
                 (65, 65), (127, 127), (129, 129), (63, 129), (129, 63),
                 (15, 129), (129, 17), (1, 65), (65, 1), (64, 0), (17, 0)]:
        for causal in (True, False):
            cases.append((2, 3, t, s, 64, causal))
    for d in (32, 128):
        cases += [(2, 4, 200, 200, d, True), (2, 4, 129, 65, d, False),
                  (1, 3, 65, 129, d, True), (1, 3, 17, 15, d, True)]
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in cases:
            err = check_bwd_case(att, case, dtype, gen)
            worst[dtype] = max(worst.get(dtype, 0.0), err)
        # NaN past every end; views not 16-byte aligned (plain loads)
        for case, offset, tail in [((2, 3, 129, 65, 64, True), 0, 4096),
                                   ((2, 3, 65, 129, 64, False), 0, 4096),
                                   ((2, 3, 130, 190, 64, True), 1, 64),
                                   ((1, 2, 100, 100, 128, False), 3, 64),
                                   ((1, 2, 77, 77, 32, True), 1, 0)]:
            err = check_bwd_case(att, case, dtype, gen, offset, tail)
            worst[dtype] = max(worst.get(dtype, 0.0), err)

    timed = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for b in BUCKETS:
            h, t, d = 12, LM["seq_len"], 64
            q, k, v, g = (torch.randn(b, h, t, d, device="cuda",
                                      generator=gen).to(dtype)
                          for _ in range(4))
            out, lse = att._flash_cuda(q, k, v, True, d ** -0.5,
                                       want_lse=True)

            def kern():
                return att.flash_attention_backward(q, k, v, out, g, lse,
                                                    causal=True)

            def plain():
                return att.flash_attention_backward_reference(
                    q, k, v, out, g, lse, causal=True)

            got, want = kern(), plain()
            err = max(rel_err(a, w) for a, w in zip(got, want))
            aerr = max(abs_err(a, w) for a, w in zip(got, want))
            del want
            ms = cuda_ms(kern, 20)
            plain_ms = cuda_ms(plain, 5)
            qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
            o_lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
            lib_ms = cuda_ms(lambda: torch.autograd.grad(
                o_lib, (qs, ks, vs), g, retain_graph=True), 20)
            del o_lib
            fwd_ms = cuda_ms(lambda: att.flash_attention(q, k, v,
                                                         causal=True), 20)
            fwd_lse_ms = cuda_ms(lambda: att._flash_cuda(
                q, k, v, True, d ** -0.5, want_lse=True), 20)
            bound_ms, bound_by = backward_bound_ms(b, h, t, t, d, True, dtype)
            route_ms = backward_route_ms(b, h, t, t, d, True, dtype)
            row = dict(dtype=name, B=b, max_abs_err=aerr, scaled_err=err,
                       ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       route_ms=route_ms, fwd_ms=fwd_ms,
                       fwd_lse_ms=fwd_lse_ms)
            log("  flash bwd %s causal B=%d H=%d T=S=%d D=%d: kernel %.4f "
                "ms, plain %.4f ms, sdpa bwd %.4f ms (kernel/sdpa %.2f), "
                "bound %.4f ms (%s; kernel at %.1f%% of it; the 7-product "
                "route's figure %.4f ms, kernel at %.1f%% of it), max abs "
                "err %.3e, scaled err %.3e; forward %.4f ms, with lse %.4f ms"
                % (name, b, h, t, d, ms, plain_ms, lib_ms, ms / lib_ms,
                   bound_ms, bound_by, 100.0 * bound_ms / ms, route_ms,
                   100.0 * route_ms / ms, aerr, err, fwd_ms, fwd_lse_ms))
            row["turns"] = []
            for parent in parents:
                this_k = att._kernel(att.BWD_KERNEL)
                pk = parent.kernels["flash_attn_bwd"]
                args = (q, k, v, out, g, lse, True, d ** -0.5)
                perr = max(rel_err(a, w) for a, w in zip(
                    att._launch_bwd(pk, *args), got))
                p_ms, t_ms = in_turns(lambda: att._launch_bwd(pk, *args),
                                      lambda: att._launch_bwd(this_k, *args),
                                      20)
                row["turns"].append(dict(parent=parent.csrc, parent_ms=p_ms,
                                         this_ms=t_ms, scaled_diff=perr))
                log("    in turns with %s (parent, this, this, parent): "
                    "%.4f, %.4f, %.4f, %.4f ms (parent/this %.2f); scaled "
                    "diff %.3e" % (parent.csrc, p_ms[0], t_ms[0], t_ms[1],
                                   p_ms[1], sum(p_ms) / sum(t_ms), perr))
            del got
            timed.append(row)
    return timed, worst


def epilogue_bound_ms(shape, axis, dtype, residual, out_dtype=None):
    """Least time for one epilogue pass: x (and the residual) read and y
    written once plus scale and shift, against the HBM rate; or its f32
    operations (mul, add, compare, and the residual's add) against the
    f32 peak; whichever is larger. ``out_dtype`` (default x's) is y's
    and the residual's type."""
    n = 1
    for d in shape:
        n *= d
    esize = torch.empty((), dtype=dtype).element_size()
    osize = torch.empty((), dtype=out_dtype or dtype).element_size()
    nbytes = n * (esize + osize * (2 if residual else 1)) + \
        2 * shape[axis] * 4
    ops = n * (4 if residual else 3)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def bit_err(got, want):
    """0.0 when got equals want bit for bit up to NaN payloads (NaN at the
    same places, every other value equal); else the largest difference
    (inf when the NaN positions differ)."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return float("inf")
    g, w = got[~nan], want[~nan]
    same = g == w
    if bool(same.all()):
        return 0.0
    return (g[~same].float() - w[~same].float()).abs().max().item()


def epilogue_inputs(shape, axis, dtype, residual, gen):
    c = shape[axis]
    x = (torch.randn(shape, device="cuda", generator=gen) * 2).to(dtype)
    r = torch.randn(shape, device="cuda", generator=gen).to(dtype) \
        if residual else None
    scale = torch.rand(c, device="cuda", generator=gen) + 0.5
    shift = torch.randn(c, device="cuda", generator=gen) * 0.5
    return x, scale, shift, r


def phase_epilogue(epi, gen):
    """Epilogue kernel vs its plain version, bit for bit; returns the
    timed rows (the main one is bn0 at bucket 32, f32, as served)."""
    checked = 0
    for dtype in (torch.float32, torch.bfloat16):
        for shape, axis, plant in [c + (False,) for c in EPILOGUE_CASES] + [
                ((257, 40), -1, True), ((2, 6, 9, 9), 1, True)]:
            for residual in (False, True):
                x, s, b, r = epilogue_inputs(shape, axis, dtype, residual,
                                             gen)
                if plant:  # NaN and +-inf in x
                    flat = x.view(-1)
                    flat[::7] = float("nan")
                    flat[3::11] = float("inf")
                    flat[5::13] = float("-inf")
                got = epi.bn_apply_relu_add(x, s, b, r, axis=axis)
                want = epi.bn_apply_relu_add_reference(x, s, b, r,
                                                       axis=axis)
                torch.cuda.synchronize()
                err = bit_err(got, want)
                if err != 0.0:
                    raise AssertionError(
                        "epilogue kernel differs from its plain version: "
                        "err %r at %s %s %s residual=%s"
                        % (err, shape, axis, dtype, residual))
                checked += 1
    log("  epilogue: %d cases (%d shapes incl. NaN/inf planted, f32 and "
        "bf16, with and without residual) equal the plain version bit "
        "for bit" % (checked, len(EPILOGUE_CASES) + 2))
    mixed = 0
    for xt, yt in ((torch.bfloat16, torch.float32),
                   (torch.float32, torch.bfloat16)):
        for shape, axis in EPILOGUE_CASES + [((32, 112, 112, 64), 3),
                                             ((999, 37), -1)]:
            for residual in (False, True):
                x, s, b, r = epilogue_inputs(shape, axis, xt, residual,
                                             gen)
                r = r.to(yt) if r is not None else None
                err = bit_err(
                    epi.bn_apply_relu_add(x, s, b, r, axis=axis,
                                          out_dtype=yt),
                    epi.bn_apply_relu_add_reference(x, s, b, r, axis=axis,
                                                    out_dtype=yt))
                if err != 0.0:
                    raise AssertionError(
                        "epilogue %s->%s differs from its plain version: "
                        "err %r at %s %s residual=%s"
                        % (xt, yt, err, shape, axis, residual))
                mixed += 1
    log("  epilogue across types (the bf16 rewrite's boundary sites, "
        "bf16->f32 and f32->bf16): %d cases equal the plain version bit "
        "for bit" % mixed)

    timed = []
    for spec, dtype, residual in [
            (EPILOGUE_MAIN, torch.float32, False),
            (EPILOGUE_MAIN, torch.bfloat16, False),
            (EPILOGUE_MAIN, torch.float32, True),
            (((401408, 64), -1), torch.float32, False),
            (((32, 2048, 7, 7), 1), torch.float32, False),
            (((1568, 2048), -1), torch.float32, False),
            # bn0 at bucket 32 under the layout and bf16 rewrites: the
            # rows path (channels last), bf16 in and out, and the
            # boundary pair bf16->f32
            (((32, 112, 112, 64), 3), torch.bfloat16, False),
            (((32, 112, 112, 64), 3, torch.float32), torch.bfloat16,
             False)]:
        shape, axis = spec[:2]
        out_dtype = spec[2] if len(spec) == 3 else None
        x, s, b, r = epilogue_inputs(shape, axis, dtype, residual, gen)

        def kern():
            return epi.bn_apply_relu_add(x, s, b, r, axis=axis,
                                         out_dtype=out_dtype)

        def plain():
            return epi.bn_apply_relu_add_reference(x, s, b, r, axis=axis,
                                                   out_dtype=out_dtype)

        err = bit_err(kern(), plain())
        ms = cuda_ms(kern, 100)
        plain_ms = cuda_ms(plain, 20)
        bound_ms, bound_by = epilogue_bound_ms(shape, axis, dtype, residual,
                                               out_dtype)
        row = dict(shape=list(shape), axis=axis,
                   dtype=str(dtype).split(".")[1], residual=residual,
                   out_dtype=str(out_dtype or dtype).split(".")[1],
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        log("  epilogue %-8s %s axis=%d residual=%d: kernel %.4f ms, plain "
            "%.4f ms, bound %.4f ms (%s; kernel at %.1f%% of it), err %g"
            % (row["dtype"], shape, axis, residual, ms, plain_ms, bound_ms,
               bound_by, 100.0 * bound_ms / ms, err))
        timed.append(row)
    return timed


def resnet_params(sym, seed):
    """Seeded random weights and BN statistics (numpy): He-scaled conv
    weights, with each unit's last conv at a quarter of that so the
    residual stream stays near unit scale over 16 units (at full He scale
    it grows ~1000x and the softmax is one-hot); gamma in U(0.5, 1.5),
    beta in U(-0.1, 0.1), moving_mean in N(0, 0.1), moving_var in
    U(0.5, 1.5), so the folded scale and shift are not trivial; the
    classifier N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(
        data=(1,) + RESNET["image_shape"])
    params = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        if name.endswith("_gamma"):
            w = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("_beta"):
            w = rng.uniform(-0.1, 0.1, shape)
        elif name.endswith("_bias"):
            w = np.zeros(shape)
        elif name.startswith("fc"):
            w = rng.standard_normal(shape) / np.sqrt(fan_in)
        else:
            w = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
            if name.endswith("_conv3_weight"):
                w *= 0.25
        params["arg:" + name] = w.astype(np.float32)
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        w = rng.normal(0.0, 0.1, shape) if name.endswith("_moving_mean") \
            else rng.uniform(0.5, 1.5, shape)
        params["aux:" + name] = w.astype(np.float32)
    return params


def phase_resnet(mt, epi, seed, card, profile=False):
    sym = mt.models.get_resnet(**RESNET)
    sym_json = sym.tojson()
    t0 = time.perf_counter()
    params = resnet_params(sym, seed)
    n_params = sum(v.size for v in params.values())
    log("  ResNet-50 v2 %s: %d parameters + statistics (%.3f GB f32), made "
        "in %.1f s" % (RESNET, n_params, n_params * 4 / 1e9,
                       time.perf_counter() - t0))
    shape = (1,) + RESNET["image_shape"]
    rng = np.random.default_rng(seed + 1)
    requests = [rng.standard_normal(shape, dtype=np.float32)
                for _ in range(RESNET_REQUESTS)]

    t0 = time.perf_counter()
    session = mt.serving.ServingSession(
        sym_json, params, {"data": shape}, buckets=RESNET_BUCKETS,
        contexts=[mt.gpu(0)], warmup=True)
    log("  session up in %.2f s; warmup batch ms %s"
        % (time.perf_counter() - t0, session.warmup_ms))
    answers = [None] * RESNET_REQUESTS
    latency = [None] * RESNET_REQUESTS
    errors = []

    def client(idx):
        try:
            mine = list(range(idx, RESNET_REQUESTS, RESNET_CLIENTS))
            sent = [(r, time.perf_counter(),
                     session.predict_async({"data": requests[r]}))
                    for r in mine]
            for r, t, fut in sent:
                answers[r] = fut.wait(600)[0]
                latency[r] = (time.perf_counter() - t) * 1e3
        except Exception as exc:  # re-raised on the main thread below
            errors.append(exc)

    try:
        epi.bn_apply_relu_add.launches = 0  # count the main path alone
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(RESNET_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = epi.bn_apply_relu_add.launches
        batches = session.metrics.counter("batches_dispatched").value
        stats = session.stats()
        sites = session.pool.replicas[0].base._executor.fused_sites
    finally:
        session.close()
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads) or any(a is None
                                                   for a in answers):
        raise AssertionError("not every request was answered")
    for r, out in enumerate(answers):
        if out.shape != (1, RESNET["num_classes"]):
            raise AssertionError("answer %d has shape %s" % (r, out.shape))
        if not np.isfinite(out).all():
            raise AssertionError("answer %d is not finite" % r)
        dev = np.abs(out.sum(axis=1, dtype=np.float64) - 1.0).max()
        if dev > 1e-4:
            raise AssertionError("answer %d rows sum to 1 +- %g" % (r, dev))
    if sites != RESNET_SITES:
        raise AssertionError("executor fused %d BatchNorm->ReLU sites, not "
                             "%d" % (sites, RESNET_SITES))
    if batches < 1 or launches != RESNET_SITES * batches:
        raise AssertionError("epilogue launches %d != %d sites x %d batches"
                             % (launches, RESNET_SITES, batches))
    log("  %d requests in %d batches: %d fused sites, epilogue launches "
        "%d = %d x %d" % (RESNET_REQUESTS, batches, sites, launches,
                          RESNET_SITES, batches))
    lat = np.array(latency)
    top = np.array([a.max() for a in answers])
    log("  [%s] %.3f images/s; request latency ms (client): p50 %.1f, p99 "
        "%.1f, max %.1f; session request_latency_ms p50 %.1f p99 %.1f; "
        "batch_exec_ms mean %.2f; top probability min %.3g max %.3g"
        % (card, RESNET_REQUESTS / wall, np.percentile(lat, 50),
           np.percentile(lat, 99), lat.max(),
           stats["request_latency_ms"]["p50_ms"],
           stats["request_latency_ms"]["p99_ms"],
           stats["batch_exec_ms"]["mean_ms"], top.min(), top.max()))

    h = session.metrics.histogram("batch_exec_ms")
    log("  batch_exec_ms over %d batches: min %.2f, mean %.2f, max %.2f"
        % (h.count, h.min, h.mean, h.max))
    x = np.concatenate(requests[:max(RESNET_BUCKETS)])
    breakdown = batch_breakdown(mt, sym_json, params, x, profile,
                                "ResNet-50")
    # every BatchNorm of ResNet-50 v2 feeds a ReLU, so the 50 fused sites
    # are its 50 BatchNorm outputs: their shapes at the largest bucket
    bn_nodes = [n for n in sym._topo() if not n.is_variable
                and n.op.name == "BatchNorm"]
    site_shapes = mt.sym.Group([mt.symbol.Symbol([(n, 0)])
                                for n in bn_nodes]).infer_shape(
        data=x.shape)[1]
    sites_bound_ms = sum(epilogue_bound_ms(tuple(s), 1, torch.float32,
                                           False)[0] for s in site_shapes)
    breakdown["epilogue_sites_bound_ms"] = sites_bound_ms
    log("  the %d epilogue sites of one bucket-%d forward: bound %.4f ms "
        "(bytes: each activation read and written once)"
        % (len(site_shapes), x.shape[0], sites_bound_ms))
    if profile:
        epi_ms = sum(v for k, v in breakdown["by_kernel_ms"].items()
                     if "planes_kernel" in k or "rows_kernel" in k)
        breakdown["epilogue_device_ms"] = epi_ms
        log("  their device time in the profiled forward: %.4f ms (at "
            "%.1f%% of the bound)" % (epi_ms, 100.0 * sites_bound_ms
                                      / max(epi_ms, 1e-9)))
    t0 = time.perf_counter()
    cpu_pred = mt.Predictor(sym_json, params, ctx=mt.cpu(),
                            input_shapes={"data": shape})
    cpu_pred.forward(data=requests[0])
    ref = cpu_pred.get_outputs()[0]
    abs_err = float(np.abs(answers[0] - ref).max())
    log("  gpu vs cpu Predictor on request 0: max abs err %.3e (cpu "
        "forward %.1f s)" % (abs_err, time.perf_counter() - t0))
    if not abs_err <= 1e-4:
        raise AssertionError("served ResNet-50 output disagrees with the "
                             "cpu path: %g" % abs_err)
    return dict(launches=launches, batches=batches, fused_sites=sites,
                images_per_s=RESNET_REQUESTS / wall, latency_ms=latency,
                session_stats=stats, warmup_ms=session.warmup_ms,
                cpu_abs_err=abs_err, n_params=int(n_params),
                breakdown=breakdown)


def lm_params(sym, seed):
    """Seeded random weights for every argument but the inputs (numpy)."""
    rng = np.random.default_rng(seed)
    arg_shapes, _, _ = sym.infer_shape(data=(1, LM["seq_len"]))
    params = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        w = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        if name.endswith("_gamma"):
            w += np.float32(1.0)
        params["arg:" + name] = w
    return params


def phase_serving(mt, att, seed, card, profile=False):
    sym = mt.models.get_transformer_lm(**LM)
    sym_json = sym.tojson()
    t0 = time.perf_counter()
    params = lm_params(sym, seed)
    n_params = sum(v.size for v in params.values())
    log("  LM %s: %d parameters (%.3f GB f32), made in %.1f s"
        % (LM, n_params, n_params * 4 / 1e9, time.perf_counter() - t0))
    rng = np.random.default_rng(seed + 1)
    requests = [rng.integers(0, LM["vocab_size"], (1, LM["seq_len"]))
                .astype(np.float32) for _ in range(N_REQUESTS)]

    t0 = time.perf_counter()
    session = mt.serving.ServingSession(
        sym_json, params, {"data": (1, LM["seq_len"])}, buckets=BUCKETS,
        contexts=[mt.gpu(0)], warmup=True)
    log("  session up in %.2f s; warmup batch ms %s"
        % (time.perf_counter() - t0, session.warmup_ms))
    answers = [None] * N_REQUESTS
    latency = [None] * N_REQUESTS
    errors = []

    def client(idx):
        try:
            for r in range(idx, N_REQUESTS, N_CLIENTS):
                t = time.perf_counter()
                answers[r] = session.predict({"data": requests[r]})[0]
                latency[r] = (time.perf_counter() - t) * 1e3
        except Exception as exc:  # re-raised on the main thread below
            errors.append(exc)

    try:
        att.flash_attention.launches = 0  # count the main path alone
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(N_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = att.flash_attention.launches
        batches = session.metrics.counter("batches_dispatched").value
    finally:
        session.close()
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads) or any(a is None
                                                   for a in answers):
        raise AssertionError("not every request was answered")

    for r, out in enumerate(answers):
        if out.shape != (LM["seq_len"], LM["vocab_size"]):
            raise AssertionError("answer %d has shape %s" % (r, out.shape))
        if not np.isfinite(out).all():
            raise AssertionError("answer %d is not finite" % r)
        dev = np.abs(out.sum(axis=1, dtype=np.float64) - 1.0).max()
        if dev > 1e-4:
            raise AssertionError("answer %d rows sum to 1 +- %g" % (r, dev))
    if batches < 1 or launches != LM["num_layers"] * batches:
        raise AssertionError("flash launches %d != %d layers x %d batches"
                             % (launches, LM["num_layers"], batches))
    log("  %d requests in %d batches: flash launches %d = %d x %d"
        % (N_REQUESTS, batches, launches, LM["num_layers"], batches))
    lat = np.array(latency)
    log("  [%s] %.3f requests/s (%.0f tokens/s); request latency ms: "
        "p50 %.1f, max %.1f, all %s"
        % (card, N_REQUESTS / wall, N_REQUESTS * LM["seq_len"] / wall,
           np.median(lat), lat.max(), [round(x, 1) for x in latency]))

    breakdown = batch_breakdown(
        mt, sym_json, params, np.concatenate(requests[:max(BUCKETS)]),
        profile, "LM")
    t0 = time.perf_counter()
    cpu_pred = mt.Predictor(sym_json, params, ctx=mt.cpu(),
                            input_shapes={"data": (1, LM["seq_len"])})
    cpu_pred.forward(data=requests[0])
    ref = cpu_pred.get_outputs()[0]
    diff = np.abs(answers[0] - ref)
    abs_err = float(diff.max())
    rel_err = float((diff / np.maximum(np.abs(ref), 1e-30)).max())
    log("  gpu vs cpu Predictor on request 0: max abs err %.3e, max rel "
        "err %.3e (cpu forward %.1f s)"
        % (abs_err, rel_err, time.perf_counter() - t0))
    if not abs_err <= 1e-4 or not rel_err <= 1e-2:
        raise AssertionError("served output disagrees with the cpu path")
    return dict(launches=launches, batches=batches,
                requests_per_s=N_REQUESTS / wall,
                latency_ms=latency, warmup_ms=session.warmup_ms,
                cpu_abs_err=abs_err, cpu_rel_err=rel_err,
                n_params=int(n_params), breakdown=breakdown)


class RepeatBatch:
    """A DataIter over one batch, ``n`` times per epoch (the LM's labels
    are (B*T,), which NDArrayIter's one-row-per-example rule cannot
    carry; the SSD's are (B, 8, 5) boxes named ``label``)."""

    def __init__(self, mt, x, y, n, label_name="softmax_label"):
        self._batch = mt.io.DataBatch(
            data=[mt.nd.array(x, ctx=mt.cpu())],
            label=[mt.nd.array(y, ctx=mt.cpu())], pad=0)
        self.provide_data = [mt.io.DataDesc("data", x.shape)]
        self.provide_label = [mt.io.DataDesc(label_name, y.shape)]
        self.n = n
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= self.n:
            raise StopIteration
        self._i += 1
        return self._batch

    def reset(self):
        self._i = 0


def lm_batch(seed, batch, seq_len, vocab):
    """Seeded tokens (B, T) and next-token labels (B*T,), float32."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, seq_len + 1))
    return (ids[:, :-1].astype(np.float32),
            ids[:, 1:].reshape(-1).astype(np.float32))


def phase_training(mt, att, seed, card, profile=False):
    """The LM trained through Module.fit on gpu(0) at GPT-2-small widths
    and depth: Xavier weights from a numpy seed, Adam, one fixed batch
    repeated TRAIN["steps"] times. Checks finite, falling cross-entropy
    and exactly one flash forward and one flash backward launch per layer
    per step; times the steps; then holds one step of a 2-layer model at
    full width, B = 1, against a cpu() Module from the same weights."""
    cfg = dict(LM)
    sym = mt.models.get_transformer_lm(**cfg)
    b, t, steps = TRAIN["batch"], cfg["seq_len"], TRAIN["steps"]
    x, y = lm_batch(seed, b, t, cfg["vocab_size"])
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    np.random.seed(seed)
    t0 = time.perf_counter()
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mod.init_params(mt.init.Xavier())
    n_params = sum(int(np.prod(a.shape))
                   for a in mod._exec_group.execs[0].arg_dict.values()) \
        - x.size - y.size
    log("  LM %s, B=%d: %d parameters, bound and initialized in %.1f s"
        % (cfg, b, n_params, time.perf_counter() - t0))
    ce, stamps = [], []

    def record(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        ce.append(param.eval_metric.get()[1])
        param.eval_metric.reset()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    it = RepeatBatch(mt, x, y, steps)
    att.flash_attention.launches = 0  # count the main path alone
    att.flash_attention_backward.launches = 0
    t_start = time.perf_counter()
    mod.fit(it, num_epoch=1, eval_metric="ce", optimizer="adam",
            optimizer_params={"learning_rate": TRAIN["lr"]},
            initializer=None, batch_end_callback=record, metric_sync=1)
    fwd = att.flash_attention.launches
    bwd = att.flash_attention_backward.launches
    peak = torch.cuda.max_memory_allocated()
    ms = [float(v) for v in np.diff([t_start] + stamps) * 1e3]
    want = cfg["num_layers"] * steps
    log("  cross-entropy by step: %s" % [round(v, 4) for v in ce])
    log("  flash launches: forward %d, backward %d (want %d = %d layers x "
        "%d steps)" % (fwd, bwd, want, cfg["num_layers"], steps))
    if len(ce) != steps or not np.all(np.isfinite(ce)) or \
            not ce[-1] < ce[0]:
        raise AssertionError("LM training did not lower a finite "
                             "cross-entropy: %s" % ce)
    if fwd != want or bwd != want:
        raise AssertionError("flash launches fwd %d / bwd %d != %d"
                             % (fwd, bwd, want))
    warm = np.array(ms[TRAIN["warmup"]:])
    row = dict(batch=b, steps=steps, ce=ce, step_ms=ms,
               step_ms_mean=float(warm.mean()),
               tokens_per_s=float(b * t / (warm.mean() / 1e3)),
               max_memory_allocated=int(peak), n_params=n_params,
               fwd_launches=fwd, bwd_launches=bwd)
    log("  [%s] step ms %s; mean after %d warm-up steps %.2f ms, %.0f "
        "tokens/s; max_memory_allocated %.2f GB"
        % (card, [round(v, 1) for v in ms], TRAIN["warmup"],
           row["step_ms_mean"], row["tokens_per_s"], peak / 1e9))
    row["step_paths_ms"] = time_step_paths(mt, mod, x, y, card)
    if profile:
        row["profile"] = profile_step(mod, x, y, mt)
    del mod
    torch.cuda.empty_cache()
    row.update(train_step_vs_cpu(mt, seed))
    return row


def time_step_paths(mt, mod, x, y, card, pairs=10, n=3):
    """Host-clock ms of single training steps (``forward_backward`` +
    ``update``), each ended by a device sync, with the update through the
    fused rules (Adam) and through the Updater (an Adam subclass, which
    has no fused rule): ``pairs`` turns of each, ordered fused, updater,
    updater, fused, ..., of ``n`` steps, the first step of a turn not
    counted. Each turn starts a fresh optimizer
    (``init_optimizer(force_init=True)``), which leaves the work of a
    step unchanged."""

    class AdamByUpdater(mt.optimizer.Adam):
        pass

    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=mt.cpu())],
                         label=[mt.nd.array(y, ctx=mt.cpu())])
    rescale = 1.0 / x.shape[0]
    turns = {"fused": [], "updater": []}
    for path in (["fused", "updater", "updater", "fused"] * pairs)[
            :2 * pairs]:
        klass = mt.optimizer.Adam if path == "fused" else AdamByUpdater
        mod.init_optimizer(optimizer=klass(learning_rate=TRAIN["lr"],
                                           rescale_grad=rescale),
                           force_init=True)
        if (mod._fused is not None) != (path == "fused"):
            raise AssertionError("the %s turn did not arm its update" % path)
        ms = []
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.forward_backward(db)
            mod.update()
            torch.cuda.synchronize()
            if i:
                ms.append((time.perf_counter() - t0) * 1e3)
        turns[path].append(float(np.mean(ms)))
    wins = sum(u > f for f, u in zip(turns["fused"], turns["updater"]))
    q = {k: [float(v) for v in np.percentile(t, [25, 50, 75])]
         for k, t in turns.items()}
    log("  [%s] one step, host clock to a device sync, %d turns each: "
        "fused update median %.2f ms (quartiles %.2f-%.2f); Updater median "
        "%.2f ms (quartiles %.2f-%.2f); Updater/fused %.3f; fused faster "
        "in %d of %d pairs"
        % (card, pairs, q["fused"][1], q["fused"][0], q["fused"][2],
           q["updater"][1], q["updater"][0], q["updater"][2],
           q["updater"][1] / q["fused"][1], wins, pairs))
    return dict(turns_ms=turns, quartiles_ms=q, fused_wins=wins,
                pairs=pairs)


def profile_step(mod, x, y, mt):
    """One fused training step under torch.profiler: device time by
    kernel."""
    from torch.profiler import ProfilerActivity, profile as _prof
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=mt.cpu())],
                         label=[mt.nd.array(y, ctx=mt.cpu())])
    mod.forward_backward(db)
    mod.update()
    torch.cuda.synchronize()
    with _prof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        mod.forward_backward(db)
        mod.update()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    total = sum(e.device_time_total for e in events)
    log("  profiled training step: %.2f ms of device time in %d kernels"
        % (total / 1e3, len(events)))
    for e in sorted(events, key=lambda e: -e.device_time_total)[:14]:
        log("    %8.3f ms %5.1f%%  x%-4d %s"
            % (e.device_time_total / 1e3,
               100.0 * e.device_time_total / max(total, 1e-9), e.count,
               e.key[:90]))
    bwd = {e.key: e.device_time_total / 1e3 for e in events
           if "flash_bwd_" in e.key}
    log("  the flash backward's kernels in the step: %.3f ms (%.1f%%): %s"
        % (sum(bwd.values()), 100.0 * sum(bwd.values()) * 1e3
           / max(total, 1e-9), {k[:40]: round(v, 3) for k, v in
                                 bwd.items()}))
    return {"device_ms": total / 1e3, "flash_bwd_ms": sum(bwd.values()),
            "by_kernel_ms": {e.key: e.device_time_total / 1e3
                             for e in events}}


def _grads_f64(mt, sym, weights, x, y, aux=None):
    """The gradient of every parameter in float64 on the CPU (the
    executor with float64 arrays), from ``weights`` (cpu NDArrays); with
    ``aux`` (cpu NDArrays) also the aux values that training forward
    wrote back, as (grads, aux)."""
    def f64(t):
        return mt.nd.NDArray(t.double(), mt.cpu())

    args = {n: f64(v._data) for n, v in weights.items()}
    args["data"] = f64(torch.from_numpy(x))
    args["softmax_label"] = f64(torch.from_numpy(y))
    grads = {n: mt.nd.NDArray(torch.zeros_like(v._data), mt.cpu())
             for n, v in args.items() if n in weights}
    aux64 = {n: f64(v._data) for n, v in (aux or {}).items()}
    exe = sym.bind(mt.cpu(), args, args_grad=grads, aux_states=aux64)
    exe.forward(is_train=True)
    exe.backward()
    g = {n: t._data.numpy() for n, t in grads.items()}
    if aux is None:
        return g
    return g, {n: v._data.numpy() for n, v in aux64.items()}


def train_step_vs_cpu(mt, seed):
    """One SGD step of a 2-layer LM at full width, B = 1, on gpu(0) and
    on cpu() from the same weights, against the exact step (a float64
    gradient on the CPU, through the plain versions). Both f32 steps run
    with TF32 off. f32 is far from exact on this model (a LayerNorm over
    small Xavier-scale embeddings multiplies the gradient, and the sums
    over 1024 tokens and 50257 classes cancel), so the gate is relative:
    the GPU step's largest distance from the exact step must stay within
    TRAIN_CPU_FACTOR times the CPU f32 step's own, and the step's outputs
    (probabilities, before the update) within TRAIN_OUT_RTOL of the CPU's,
    element by element. A third step, on gpu(0) with TF32 GEMMs, is the
    control: a GPU step of lower precision that both gates must refuse."""
    cfg = dict(LM, num_layers=2)
    sym = mt.models.get_transformer_lm(**cfg)
    x, y = lm_batch(seed + 1, 1, cfg["seq_len"], cfg["vocab_size"])
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=mt.cpu())],
                         label=[mt.nd.array(y, ctx=mt.cpu())])
    np.random.seed(seed + 1)
    got = {}
    weights = None
    t0 = time.perf_counter()
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    for run, ctx, tf32 in (("gpu", mt.gpu(0), False),
                           ("gpu_tf32", mt.gpu(0), True),
                           ("cpu", mt.cpu(), False)):
        mod = mt.mod.Module(sym, context=ctx)
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", y.shape)])
        if weights is None:
            mod.init_params(mt.init.Xavier())
            weights = mod.get_params()[0]
        else:
            mod.init_params(arg_params=weights)
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": TRAIN_CPU_LR})
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            mod.forward_backward(db)
            mod.update()
            got[run] = (mod.get_outputs()[0].asnumpy(),
                        {k: v.asnumpy() for k, v in
                         mod.get_params()[0].items()})
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32_was
        del mod
    g64 = _grads_f64(mt, sym, weights, x, y)
    exact = {k: weights[k].asnumpy().astype(np.float64) - TRAIN_CPU_LR * g
             for k, g in g64.items()}  # SGD, rescale_grad 1/B = 1, wd 0
    c_out, c_w = got["cpu"]

    def out_err(o):
        return float((np.abs(o - c_out) / np.maximum(np.abs(c_out),
                                                     1e-30)).max())

    def dist(w):
        return max(float(np.abs(w[k] - exact[k]).max()) for k in exact)

    cpu_err = dist(c_w)
    res = {"cpu_exact_err": cpu_err,
           "cpu_weight_moved": max(float(np.abs(
               c_w[k] - weights[k].asnumpy()).max()) for k in c_w)}
    for run in ("gpu", "gpu_tf32"):
        o, w = got[run]
        res[run] = {"out_rel_err": out_err(o),
                    "out_abs_err": float(np.abs(o - c_out).max()),
                    "exact_err": dist(w),
                    "weight_err": max(float(np.abs(w[k] - c_w[k]).max())
                                      for k in c_w)}
        res[run]["exact_ratio"] = res[run]["exact_err"] / max(cpu_err,
                                                              1e-30)
        log("  2-layer full-width SGD step (lr %g), %s vs cpu: outputs max "
            "rel err %.3e (abs %.3e); updated weights %.3e apart; distance "
            "from the exact (float64) step %.3e vs the cpu f32 step's %.3e "
            "(ratio %.2f)" % (TRAIN_CPU_LR, run, res[run]["out_rel_err"],
                              res[run]["out_abs_err"],
                              res[run]["weight_err"], res[run]["exact_err"],
                              cpu_err, res[run]["exact_ratio"]))
    log("  the step moved weights by up to %.3e; three steps and the "
        "float64 gradient in %.1f s" % (res["cpu_weight_moved"],
                                        time.perf_counter() - t0))
    gpu, ctl = res["gpu"], res["gpu_tf32"]
    if not gpu["out_rel_err"] <= TRAIN_OUT_RTOL or \
            not gpu["exact_ratio"] <= TRAIN_CPU_FACTOR:
        raise AssertionError(
            "gpu training step disagrees with the cpu step: outputs rel %g "
            "(gate %g); distance from the exact step %g x the cpu's (gate "
            "%g)" % (gpu["out_rel_err"], TRAIN_OUT_RTOL, gpu["exact_ratio"],
                     TRAIN_CPU_FACTOR))
    if ctl["out_rel_err"] <= TRAIN_OUT_RTOL or \
            ctl["exact_ratio"] <= TRAIN_CPU_FACTOR:
        raise AssertionError(
            "the TF32 control step passed a gate (outputs rel %g, gate %g; "
            "exact-step ratio %g, gate %g): the gates cannot tell f32 from "
            "TF32" % (ctl["out_rel_err"], TRAIN_OUT_RTOL,
                      ctl["exact_ratio"], TRAIN_CPU_FACTOR))
    return res


def resnet_train_data(seed):
    """512 seeded images in [0, 1) (308 MB f32) and labels of 1000
    classes, as bench.py makes its batch."""
    rng = np.random.RandomState(seed)
    n = RESNET_TRAIN["images"]
    x = rng.rand(n, *RESNET["image_shape"]).astype(np.float32)
    y = rng.randint(0, RESNET["num_classes"], n).astype(np.float32)
    return x, y


class TimedCallback:
    """An epoch-end callback timed on the host clock, device work before
    and after it synchronized."""

    def __init__(self, fn):
        self.fn = fn
        self.ms = []

    def __call__(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.fn(*args)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)


def phase_resnet_training(mt, epi, seed, card, profile=False):
    """ResNet-50 v2 at 224x224 trained through Module.fit on gpu(0): f32
    with TF32 off, B=256, Xavier weights from a numpy seed, SGD, 4 epochs
    over 512 seeded images with ``device_prefetch`` and a ``do_checkpoint``
    at each epoch's end, acc and ce on the device. Gates: a finite
    cross-entropy at every step that ends lower than it starts; every
    moving statistic finite and moved; the last checkpoint reloaded by
    ``Module.load`` on gpu(0) bit for bit the live params and statistics;
    the trained model's evaluation forward launching the epilogue once at
    each of its 50 sites and within 1e-4 of the same forward through the
    epilogue's plain version; and resnet-8's one-step gate
    (``resnet8_step_vs_cpu``). Reports step ms, images/s, MFU, peak
    memory, the input copy with and without the prefetcher, the device
    time of the BatchNorm-train->ReLU pairs on their own, and with
    ``profile`` one step's device time by kernel."""
    import tempfile
    cfg = RESNET_TRAIN
    b, epochs = cfg["batch"], cfg["epochs"]
    steps = epochs * cfg["images"] // b
    sym = mt.models.get_resnet(**RESNET)
    t0 = time.perf_counter()
    x, y = resnet_train_data(seed)
    log("  %d seeded images (%.0f MB f32) in %.1f s"
        % (len(x), x.nbytes / 1e6, time.perf_counter() - t0))
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    ce, stamps = [], []

    def record(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        ce.append(dict(zip(*param.eval_metric.get()))["cross-entropy"])
        param.eval_metric.reset()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    prefix = os.path.join(tmp, "resnet50")
    ckpt = TimedCallback(mt.callback.do_checkpoint(prefix))
    try:
        np.random.seed(seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        epi.bn_apply_relu_add.launches = 0  # the training walk fuses none
        t_start = time.perf_counter()
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=b), num_epoch=epochs,
                eval_metric=["acc", "ce"], optimizer="sgd",
                optimizer_params={"learning_rate": cfg["lr"],
                                  "momentum": cfg["momentum"],
                                  "rescale_grad": 1.0 / b},
                initializer=mt.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2),
                batch_end_callback=record, epoch_end_callback=ckpt,
                metric_sync=1, device_prefetch=True)
        peak = torch.cuda.max_memory_allocated()
        train_launches = epi.bn_apply_relu_add.launches
        ms = [float(v) for v in np.diff([t_start] + stamps) * 1e3]
        log("  cross-entropy by step: %s" % [round(v, 4) for v in ce])
        if len(ce) != steps or not np.all(np.isfinite(ce)) or \
                not ce[-1] < ce[0]:
            raise AssertionError("ResNet-50 training did not lower a finite "
                                 "cross-entropy: %s" % ce)
        if train_launches:
            raise AssertionError("the training walk launched the epilogue "
                                 "%d times" % train_launches)
        warm = np.array(ms[cfg["warmup"]:])
        # every other step opens an epoch, after the last epoch's
        # checkpoint and the iterator's reset
        inner = np.array(ms[1::2][1:])
        row = dict(batch=b, steps=steps, ce=ce, step_ms=ms,
                   step_ms_mean=float(warm.mean()),
                   step_ms_within_epoch=float(inner.mean()),
                   step_ms_within_epoch_median=float(np.median(inner)),
                   checkpoint_ms=ckpt.ms,
                   images_per_s=float(b / (warm.mean() / 1e3)),
                   max_memory_allocated=int(peak))
        row["mfu"] = row["images_per_s"] * RESNET_FLOPS_PER_IMAGE / \
            PEAK_OPS_PER_S[torch.float32]
        log("  [%s] step ms %s; mean after %d warm-up steps %.2f ms (%.1f "
            "images/s, MFU %.1f%% of 67 TFLOP/s f32); steps inside an epoch "
            "%.2f ms; epoch-end checkpoints %s ms; max_memory_allocated "
            "%.2f GB" % (card, [round(v, 1) for v in ms], cfg["warmup"],
                         row["step_ms_mean"], row["images_per_s"],
                         100.0 * row["mfu"], row["step_ms_within_epoch"],
                         [round(v, 1) for v in ckpt.ms], peak / 1e9))

        args, aux = mod.get_params()
        for name, v in aux.items():
            t = v._data
            init = 0.0 if name.endswith("_moving_mean") else 1.0
            if not bool(torch.isfinite(t).all()) or \
                    bool((t == init).all()):
                raise AssertionError("moving statistic %s is not finite or "
                                     "did not move" % name)
        row["checkpoint_reload"] = check_checkpoint_reload(
            mt, prefix, epochs, sym, (args, aux), b)
        batch = mt.io.DataBatch([mt.nd.array(x[:b], ctx=mt.cpu())],
                                [mt.nd.array(y[:b], ctx=mt.cpu())])

        def forward():
            mod.forward(batch, is_train=False)
            return mod.get_outputs()[0]._data

        row.update(eval_forward_gate(
            epi, forward, lambda: mod._exec_group.execs[0].fused_sites,
            "trained model's evaluation forward"))
        row["input_copy_ms"] = time_input_copy(mt, mod, x, y, card)
        if profile:
            row["profile"] = profile_device(
                lambda: (mod.forward_backward(batch), mod.update()),
                "ResNet-50 training step")
        row["bn_relu_pairs"] = pairs = time_bn_relu_pairs(mt, sym, b, card)
        log("  the pairs' forward+backward against the step: %.1f%% of its "
            "host-clock mean" % (100.0 * pairs["fwd_bwd_ms"]
                                 / row["step_ms_mean"]))
        if profile:
            dev = row["profile"]["device_ms"]
            # as phase 6 estimates it: a run's host-clock mean less one
            # profiled step's device time
            row["idle_share_estimate"] = 1.0 - dev / row["step_ms_mean"]
            log("  ... %.1f%% of the profiled step's %.2f ms of device "
                "time; idle share, an estimate: %.1f%%"
                % (100.0 * pairs["fwd_bwd_ms"] / dev, dev,
                   100.0 * row["idle_share_estimate"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del mod
    torch.cuda.empty_cache()
    row["resnet8_step"] = resnet8_step_vs_cpu(mt, seed)
    return row


def check_checkpoint_reload(mt, prefix, epoch, sym, live, b):
    """The epoch's checkpoint, loaded by Module.load on gpu(0), gives the
    live params and statistics bit for bit."""
    mod = mt.mod.Module.load(prefix, epoch, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (b,) + RESNET["image_shape"])],
             label_shapes=[("softmax_label", (b,))], for_training=False)
    if mod.symbol.tojson() != sym.tojson():
        raise AssertionError("the checkpoint's symbol is not the model's")
    worst = 0
    for want, got in zip(live, mod.get_params()):
        if sorted(want) != sorted(got):
            raise AssertionError("the checkpoint names other arrays")
        for k in want:
            if not torch.equal(want[k]._data, got[k]._data):
                worst += 1
    log("  checkpoint of epoch %d reloaded on gpu(0): %d arrays, %d not "
        "bit-identical" % (epoch, sum(map(len, live)), worst))
    if worst:
        raise AssertionError("%d reloaded arrays differ from the live ones"
                             % worst)
    del mod
    return {"arrays": sum(map(len, live)), "differ": worst}


def eval_forward_gate(epi, forward, sites, label, expect=RESNET_SITES):
    """A trained model's evaluation forward on one batch, ``forward()``
    returning its output tensor: the epilogue kernel launches once per
    fused site (``sites()``, read after the forward; ``expect``, 50 a
    replica), and the output
    is within 1e-4 of the same forward with each site through the
    epilogue's plain version (on the same card, the same trained
    statistics)."""
    from mxtpu_torch.ops import nn as nn_ops
    epi.bn_apply_relu_add.launches = 0
    got = forward().clone()
    torch.cuda.synchronize()
    launches = epi.bn_apply_relu_add.launches
    kernel = nn_ops.bn_apply_relu_add

    def plain(x, scale, shift, residual=None, axis=-1, **_):
        return epi.bn_apply_relu_add_reference(x, scale, shift, residual,
                                               axis)

    nn_ops.bn_apply_relu_add = plain
    try:
        want = forward().clone()
    finally:
        nn_ops.bn_apply_relu_add = kernel
    err = float((got - want).abs().max())
    n_sites = sites()
    log("  %s (B=%d): %d fused sites, epilogue launches %d; vs the plain "
        "epilogue max abs err %.3e; rows finite %s"
        % (label, got.shape[0], n_sites, launches, err,
           bool(torch.isfinite(got).all())))
    if n_sites != expect or launches != expect:
        raise AssertionError("%s: %d sites, %d epilogue launches (want %d)"
                             % (label, n_sites, launches, expect))
    if not err <= 1e-4 or not bool(torch.isfinite(got).all()):
        raise AssertionError("%s disagrees with the plain epilogue: %g"
                             % (label, err))
    return {"eval_launches": launches, "eval_max_abs_err": err}


def time_input_copy(mt, mod, x, y, card):
    """Host-clock ms to get a batch into the bound input arrays, over
    ``copy_steps`` training steps each: from the host (NDArrayIter, a
    pageable copy in the executor group's ``load_batch``) and through a
    DevicePrefetchIter (the wait on the staged batch and a device-to-
    device copy). Each step trains between the copies, so the producer
    can stage the next batch meanwhile."""
    b, n = RESNET_TRAIN["batch"], RESNET_TRAIN["copy_steps"]
    # n batches: the images again from the start where they run out
    x = np.concatenate([x] * -(-n * b // len(x)))[:n * b]
    y = np.concatenate([y] * -(-n * b // len(y)))[:n * b]
    out = {}
    for how in ("host", "prefetch", "prefetch", "host"):
        it = mt.io.NDArrayIter(x, y, batch_size=b)
        if how == "prefetch":
            it = mt.io.DevicePrefetchIter(it, device=mt.gpu(0))
        ms = []
        try:
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                batch = next(it)
                mod._exec_group.load_batch(batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                mod._exec_group.execs[0].forward(is_train=True)
                mod._exec_group.execs[0].backward()
                mod.update()
                torch.cuda.synchronize()
        finally:
            if how == "prefetch":
                it.close()
        out.setdefault(how, []).extend(ms)
    log("  [%s] input copy of a B=%d batch (%.0f MB), host clock to a sync,"
        " %d steps x 2 turns: from the host %s ms (mean %.2f); through the "
        "prefetcher %s ms (mean %.2f)"
        % (card, b, x[:b].nbytes / 1e6, n,
           [round(v, 2) for v in out["host"]], np.mean(out["host"]),
           [round(v, 2) for v in out["prefetch"]],
           np.mean(out["prefetch"])))
    return out


def profile_device(step, label):
    """``step()`` once to warm, then once under torch.profiler: device
    time by kernel, and grouped by kind (convolution, GEMM, reduction,
    elementwise, copy) from the kernels' names."""
    from torch.profiler import ProfilerActivity, profile as _prof
    step()
    torch.cuda.synchronize()
    with _prof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    total = sum(e.device_time_total for e in events) / 1e3
    kinds = {}
    for e in events:
        k = e.key.lower()
        kind = ("convolution" if any(w in k for w in (
            "conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad", "fprop",
            "winograd", "fft")) else
            "gemm" if "gemm" in k or "cutlass" in k else
            "reduction" if "reduce" in k else
            "elementwise" if "elementwise" in k else
            "copy" if "copy" in k or "memcpy" in k or "memset" in k else
            "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.device_time_total / 1e3
    log("  profiled %s: %.2f ms of device time in %d kernels; by kind %s"
        % (label, total, len(events),
           {k: round(v, 2) for k, v in sorted(kinds.items())}))
    for e in sorted(events, key=lambda e: -e.device_time_total)[:16]:
        log("    %8.3f ms %5.1f%%  x%-4d %s"
            % (e.device_time_total / 1e3,
               100.0 * e.device_time_total / 1e3 / max(total, 1e-9),
               e.count, e.key[:90]))
    return {"device_ms": total, "by_kind_ms": kinds,
            "by_kernel_ms": {e.key: e.device_time_total / 1e3
                             for e in events}}


def time_bn_relu_pairs(mt, sym, b, card):
    """Device time of the step's 50 BatchNorm-train -> ReLU pairs on their
    own: at each site's shape, the port's BatchNorm in training and the
    ReLU forward, then their backward from a head gradient, timed with
    CUDA events (the same ops the training walk runs there), summed over
    the sites."""
    from mxtpu_torch.ops.tensor import relu  # the walk's, tie rule too
    op = mt.ops.registry.get_op("BatchNorm")
    dev = mt.gpu(0).torch_device
    bn_nodes = [n for n in sym._topo() if not n.is_variable
                and n.op.name == "BatchNorm"]
    shapes = mt.sym.Group([mt.symbol.Symbol([(n, 0)]) for n in bn_nodes]) \
        .infer_shape(data=(b,) + RESNET["image_shape"])[1]
    gen = torch.Generator(device=dev).manual_seed(0)
    total_fwd = total_all = 0.0
    for node, shape in zip(bn_nodes, shapes):
        a = type(node.parsed_attrs())(node.parsed_attrs())
        a["__is_train__"] = True
        c = shape[1]
        x = torch.randn(shape, device=dev, generator=gen)
        g = torch.rand(c, device=dev, generator=gen) + 0.5
        beta = torch.zeros(c, device=dev)
        mm, mv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
        head = torch.randn(shape, device=dev, generator=gen)
        xg, gg, bg = (t.clone().requires_grad_() for t in (x, g, beta))

        def fwd():
            with torch.no_grad():
                return relu(op.apply(a, [x, g, beta, mm, mv])[0])

        def fwd_bwd():
            y = relu(op.apply(a, [xg, gg, bg, mm, mv])[0])
            torch.autograd.grad(y, (xg, gg, bg), head)

        total_fwd += cuda_ms(fwd, 3, warmup=1)
        total_all += cuda_ms(fwd_bwd, 3, warmup=1)
        del x, head, xg
    torch.cuda.empty_cache()
    log("  [%s] the %d BatchNorm-train->ReLU pairs of a B=%d step on their "
        "own (CUDA events): forward %.2f ms, forward+backward %.2f ms"
        % (card, len(shapes), b, total_fwd, total_all))
    return {"sites": len(shapes), "fwd_ms": total_fwd,
            "fwd_bwd_ms": total_all}


def resnet8_step_vs_cpu(mt, seed):
    """One SGD step of resnet-8 at B=32 on gpu(0) and on cpu() from the
    same weights and statistics, against the exact step (float64 on the
    CPU): the GPU's updated weights and moving statistics no farther from
    it than TRAIN_CPU_FACTOR times the CPU f32 step's, and its outputs
    (probabilities before the update) within TRAIN_OUT_RTOL of the CPU's.
    A control step on gpu(0) with TF32 convolutions and GEMMs must fail a
    gate."""
    sym = mt.models.get_resnet(**RESNET8)
    rng = np.random.RandomState(seed + 2)
    x = rng.rand(RESNET8_BATCH, *RESNET8["image_shape"]).astype(np.float32)
    y = rng.randint(0, RESNET8["num_classes"], RESNET8_BATCH).astype(
        np.float32)
    db = mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                         [mt.nd.array(y, ctx=mt.cpu())])
    np.random.seed(seed + 2)
    got, start = {}, None
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    for run, ctx, tf32 in (("gpu", mt.gpu(0), False),
                           ("gpu_tf32", mt.gpu(0), True),
                           ("cpu", mt.cpu(), False)):
        mod = mt.mod.Module(sym, context=ctx)
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", y.shape)])
        if start is None:
            mod.init_params(mt.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
            start = mod.get_params()
        else:
            mod.init_params(arg_params=start[0], aux_params=start[1])
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": RESNET8_LR})
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            mod.forward_backward(db)
            mod.update()
            got[run] = (mod.get_outputs()[0].asnumpy(),) + tuple(
                {k: v.asnumpy() for k, v in d.items()}
                for d in mod.get_params())
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
        del mod
    g64, aux64 = _grads_f64(mt, sym, start[0], x, y, aux=start[1])
    rescale = 1.0 / RESNET8_BATCH
    exact_w = {k: start[0][k].asnumpy().astype(np.float64)
               - RESNET8_LR * rescale * g for k, g in g64.items()}
    return step_gate(got, exact_w, aux64, ("gpu",), "resnet-8 SGD step "
                     "(B=%d, lr %g)" % (RESNET8_BATCH, RESNET8_LR))


def step_gate(got, exact_w, exact_a, runs, label):
    """Hold each GPU step of ``runs`` as phase 7 holds resnet-8: ``got``
    maps a run (those, "cpu" and the "gpu_tf32" control) to its outputs
    (probabilities before the update), updated weights and moving
    statistics; a step passes when its outputs are within TRAIN_OUT_RTOL
    of the CPU's, and its weights and statistics no farther from the
    exact (float64) step than TRAIN_CPU_FACTOR times the CPU f32 step's.
    The TF32 control must fail a gate."""
    c_out, c_w, c_a = got["cpu"]

    def dist(vals, exact):
        return max(float(np.abs(vals[k] - exact[k]).max()) for k in exact)

    res = {"cpu_weight_err": dist(c_w, exact_w),
           "cpu_stat_err": dist(c_a, exact_a)}
    for run in tuple(runs) + ("gpu_tf32",):
        o, w, a = got[run]
        r = res[run] = {
            "out_rel_err": float((np.abs(o - c_out) / np.maximum(
                np.abs(c_out), 1e-30)).max()),
            "weight_err": dist(w, exact_w), "stat_err": dist(a, exact_a)}
        r["weight_ratio"] = r["weight_err"] / max(res["cpu_weight_err"],
                                                  1e-30)
        r["stat_ratio"] = r["stat_err"] / max(res["cpu_stat_err"], 1e-30)
        r["ok"] = (r["out_rel_err"] <= TRAIN_OUT_RTOL and
                   r["weight_ratio"] <= TRAIN_CPU_FACTOR and
                   r["stat_ratio"] <= TRAIN_CPU_FACTOR)
        log("  %s, %s vs cpu: outputs max rel err %.3e; distance from the "
            "exact (float64) step: weights %.3e vs the cpu f32 step's %.3e "
            "(ratio %.2f), moving statistics %.3e vs %.3e (ratio %.2f)"
            % (label, run, r["out_rel_err"], r["weight_err"],
               res["cpu_weight_err"], r["weight_ratio"], r["stat_err"],
               res["cpu_stat_err"], r["stat_ratio"]))
    for run in runs:
        if not res[run]["ok"]:
            raise AssertionError("%s: the %s step disagrees with the cpu "
                                 "step: %s" % (label, run, res[run]))
    if res["gpu_tf32"]["ok"]:
        raise AssertionError("the TF32 control step passed every gate: the "
                             "gates cannot tell f32 from TF32: %s"
                             % res["gpu_tf32"])
    return res


def gluon_narrow(mt):
    v = mt.gluon.model_zoo.vision
    g = GLUON_NARROW
    return v.ResNetV2(v.BasicBlockV2, g["layers"], g["channels"],
                      classes=g["classes"], thumbnail=g["thumbnail"])


def gluon_stripped(net):
    return {k[len(net.prefix):]: p for k, p in net.collect_params().items()}


def gluon_train_steps(mt, net, trainer, loss_fn, batches, steps):
    """``steps`` steps of the users' loop: the next batch from the
    DataLoader, ``autograd.record()`` around the forward and the loss,
    ``backward()``, ``trainer.step(B)``, the loss read back (a device
    sync). Host-clock ms of each step and of its wait on the DataLoader,
    and the losses."""
    b = GLUON_TRAIN["batch"]
    step_ms, wait_ms, losses = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data, label = next(batches)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with mt.autograd.record():
            loss = loss_fn(net(data), label)
        loss.backward()
        trainer.step(b)
        losses.append(float(loss.mean().asscalar()))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        wait_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t0) * 1e3)
    return step_ms, wait_ms, losses


def cycle(loader):
    while True:
        yield from loader


def phase_gluon(mt, epi, seed, card, module_row=None, profile=False):
    """Gluon's resnet50_v2 at 224x224 trained on gpu(0) through the
    port's autograd and Trainer (see the module docstring, phase 8).
    ``module_row`` is phase 7's result, printed beside for comparison;
    with ``profile``, one hybridized step on a batch already on the card
    is traced, and the idle share estimated from it."""
    cfg = GLUON_TRAIN
    b, warm = cfg["batch"], cfg["warmup"]
    x, y = resnet_train_data(seed)
    dataset = mt.gluon.data.ArrayDataset(x, y)
    np.random.seed(seed)
    net = mt.gluon.model_zoo.vision.resnet50_v2(
        classes=RESNET["num_classes"])
    net.initialize(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=mt.gpu(0))
    net.hybridize()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": cfg["lr"], "momentum": cfg["momentum"]})
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    epi.bn_apply_relu_add.launches = 0  # the training walks fuse none
    runs = {}
    for name, steps, workers, hybrid in (
            ("hybridized", cfg["hybrid_steps"], 0, True),
            ("imperative", cfg["imperative_steps"], 0, False),
            ("hybridized_workers", cfg["worker_steps"], cfg["num_workers"],
             True)):
        net.hybridize(hybrid)
        batches = cycle(mt.gluon.data.DataLoader(dataset, batch_size=b,
                                                 num_workers=workers))
        try:
            step_ms, wait_ms, losses = gluon_train_steps(
                mt, net, trainer, loss_fn, batches, steps)
        finally:
            batches.close()
        mean = float(np.mean(step_ms[warm:]))
        wait = float(np.mean(wait_ms[warm:]))
        runs[name] = dict(steps=steps, num_workers=workers, step_ms=step_ms,
                          wait_ms=wait_ms, losses=losses,
                          step_ms_mean=mean, wait_ms_mean=wait,
                          compute_ms_mean=mean - wait,
                          images_per_s=b / (mean / 1e3))
        runs[name]["mfu"] = runs[name]["images_per_s"] * \
            RESNET_FLOPS_PER_IMAGE / PEAK_OPS_PER_S[torch.float32]
        log("  [%s] %s (num_workers=%d): loss by step %s; step ms %s; mean "
            "after %d warm-up steps %.2f ms = DataLoader wait %.2f + compute "
            "%.2f (%.1f images/s, MFU %.1f%% of 67 TFLOP/s f32)"
            % (card, name, workers, [round(v, 4) for v in losses],
               [round(v, 1) for v in step_ms], warm, mean, wait, mean - wait,
               runs[name]["images_per_s"], 100.0 * runs[name]["mfu"]))
    peak = torch.cuda.max_memory_allocated()
    train_launches = epi.bn_apply_relu_add.launches
    row = dict(runs=runs, max_memory_allocated=int(peak))
    losses = [v for r in runs.values() for v in r["losses"]]
    hyb = runs["hybridized"]["losses"]
    if not np.all(np.isfinite(losses)) or not hyb[-1] < hyb[0]:
        raise AssertionError("Gluon ResNet-50 training did not lower a "
                             "finite loss: %s" % losses)
    if train_launches:
        raise AssertionError("the training walks launched the epilogue %d "
                             "times" % train_launches)
    mod_ms = (module_row or {}).get("step_ms_within_epoch")
    log("  [%s] step ms: Gluon hybridized %.2f, imperative %.2f, hybridized "
        "with %d DataLoader workers %.2f; phase 7's Module step inside an "
        "epoch %s; the DataLoader wait %.2f ms with no workers, %.2f with "
        "%d; max_memory_allocated %.2f GB"
        % (card, runs["hybridized"]["step_ms_mean"],
           runs["imperative"]["step_ms_mean"], cfg["num_workers"],
           runs["hybridized_workers"]["step_ms_mean"],
           "%.2f" % mod_ms if mod_ms is not None else "not run",
           runs["hybridized"]["wait_ms_mean"],
           runs["hybridized_workers"]["wait_ms_mean"], cfg["num_workers"],
           peak / 1e9))
    row["module_step_ms_within_epoch"] = mod_ms
    for name, p in gluon_stripped(net).items():
        if name.endswith(("running_mean", "running_var")):
            t = p.data()._data
            init = 0.0 if name.endswith("running_mean") else 1.0
            if not bool(torch.isfinite(t).all()) or bool((t == init).all()):
                raise AssertionError("moving statistic %s is not finite or "
                                     "did not move" % name)
    row["reload"] = gluon_reload(mt, net)
    data = mt.nd.array(x[:b], ctx=mt.gpu(0))
    if profile:
        label = mt.nd.array(y[:b], ctx=mt.gpu(0))

        def step():
            with mt.autograd.record():
                loss = loss_fn(net(data), label)
            loss.backward()
            trainer.step(b)

        net.hybridize()
        row["profile"] = profile_device(step, "Gluon hybridized step")
        dev = row["profile"]["device_ms"]
        compute = runs["hybridized"]["compute_ms_mean"]
        row["idle_share_estimate"] = 1.0 - dev / compute
        log("  idle share of the hybridized step's compute (host-clock "
            "mean %.2f ms less the profiled %.2f ms of device time), an "
            "estimate: %.1f%%" % (compute, dev,
                                  100.0 * row["idle_share_estimate"]))
    net.hybridize()
    row.update(eval_forward_gate(
        epi, lambda: net(data)._data, lambda: net.fused_sites,
        "Gluon evaluation forward (hybridized)"))
    del net, trainer, data
    torch.cuda.empty_cache()
    row["narrow_step"] = gluon_step_vs_cpu(mt, seed)
    return row


def gluon_reload(mt, net):
    """``save_params``, then a fresh resnet50_v2's ``load_params`` on
    gpu(0): every parameter bit for bit."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gluon_")
    try:
        fname = os.path.join(tmp, "resnet50_v2.params")
        net.save_params(fname)
        fresh = mt.gluon.model_zoo.vision.resnet50_v2(
            classes=RESNET["num_classes"])
        fresh.load_params(fname, ctx=mt.gpu(0))
        live, got = gluon_stripped(net), gluon_stripped(fresh)
        if sorted(live) != sorted(got):
            raise AssertionError("the reloaded net names other parameters")
        differ = sum(not torch.equal(live[k].data()._data,
                                     got[k].data()._data) for k in live)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("  save_params -> a fresh net's load_params on gpu(0): %d "
        "parameters, %d not bit-identical" % (len(live), differ))
    if differ:
        raise AssertionError("%d reloaded parameters differ" % differ)
    return {"params": len(live), "differ": differ}


def _softmax64(o):
    o = o.astype(np.float64)
    e = np.exp(o - o.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def gluon_step_vs_cpu(mt, seed):
    """One SGD step (lr 0.1, no momentum) of the narrow ResNetV2 at
    resnet-8's size (B=32, 28x28) through autograd.record and
    Trainer.step, from the same weights: on gpu(0) hybridized and
    imperative, on cpu(), and in float64 on the CPU (the exact step).
    Each GPU step is held as phase 7 holds resnet-8: its probabilities
    within TRAIN_OUT_RTOL of the CPU's, its weights and moving statistics
    no farther from the float64 step than TRAIN_CPU_FACTOR times the CPU
    f32 step's. A hybridized control step with TF32 convolutions and
    GEMMs must fail a gate."""
    rng = np.random.RandomState(seed + 3)
    x = rng.rand(RESNET8_BATCH, *RESNET8["image_shape"]).astype(np.float32)
    y = rng.randint(0, GLUON_NARROW["classes"], RESNET8_BATCH).astype(
        np.float32)
    with mt.cpu():
        np.random.seed(seed + 3)
        net = gluon_narrow(mt)
        net.initialize(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                      magnitude=2))
        net(mt.nd.array(x[:1]))
        start = {k: p.data().asnumpy() for k, p in
                 gluon_stripped(net).items()}
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    got = {}
    for run, ctx, hybrid, tf32, dtype in (
            ("gpu_hybridized", mt.gpu(0), True, False, "float32"),
            ("gpu_imperative", mt.gpu(0), False, False, "float32"),
            ("gpu_tf32", mt.gpu(0), True, True, "float32"),
            ("cpu", mt.cpu(), True, False, "float32"),
            ("float64", mt.cpu(), True, False, "float64")):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            with ctx:
                net = gluon_narrow(mt)
                mt.convert.gluon_params_from_mxtpu(start, ctx, block=net)
                if dtype != "float32":
                    net.cast(dtype)
                net.hybridize(hybrid)
                trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                           {"learning_rate": RESNET8_LR})
                loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
                data = mt.nd.array(x, dtype=dtype)
                label = mt.nd.array(y, dtype=dtype)
                with mt.autograd.record():
                    out = net(data)
                    loss = loss_fn(out, label)
                loss.backward()
                trainer.step(RESNET8_BATCH)
                ps = gluon_stripped(net)
                got[run] = (
                    _softmax64(out.asnumpy()),
                    {k: p.data().asnumpy().astype(np.float64)
                     for k, p in ps.items() if p.grad_req != "null"},
                    {k: p.data().asnumpy().astype(np.float64)
                     for k, p in ps.items() if p.grad_req == "null"})
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
    _, exact_w, exact_a = got["float64"]
    return step_gate(got, exact_w, exact_a,
                     ("gpu_hybridized", "gpu_imperative"),
                     "narrow Gluon ResNetV2 SGD step (B=%d, lr %g)"
                     % (RESNET8_BATCH, RESNET8_LR))


def free_port():
    """A free TCP port on localhost, for a process group's rendezvous."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def kvstore_cases(mt, ctxs):
    """mxtpu's kvstore cases (tests/test_kvstore.py) on CUDA values over
    the contexts ``ctxs``, for "local" and "device": a pushed list (one
    value per context, cycled to 4) is summed; an updater runs on the
    store; set_optimizer's SGD with momentum. Gate: each pulled value
    bit for bit the same arithmetic on the host (the list added in
    order; the same update functions on cpu() tensors)."""
    rng = np.random.RandomState(3)
    shape = (1000, 257)
    vals = [rng.randn(*shape).astype(np.float32) for _ in range(4)]
    placed = [ctxs[i % len(ctxs)] for i in range(4)]
    want_sum = torch.from_numpy(vals[0])
    for v in vals[1:]:
        want_sum = want_sum + torch.from_numpy(v)
    host_kv = mt.kv.create("local")
    host_kv.set_optimizer(mt.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                           rescale_grad=0.25, wd=1e-4))
    w0 = rng.randn(*shape).astype(np.float32)
    host_kv.init(0, mt.nd.array(w0, ctx=mt.cpu()))
    for v in vals[:3]:
        host_kv.push(0, mt.nd.array(v, ctx=mt.cpu()))
    want_sgd = host_kv._store[0]._data
    out = {}
    for kind in ("local", "device"):
        kv = mt.kv.create(kind)
        kv.init(3, mt.nd.zeros(shape, ctx=ctxs[0]))
        kv.push(3, [mt.nd.array(v, ctx=c) for v, c in zip(vals, placed)])
        outs = [mt.nd.zeros(shape, ctx=c) for c in ctxs]
        kv.pull(3, out=outs)
        agg = all(torch.equal(o._data.cpu(), want_sum) for o in outs)
        def updater(key, recv, stored):
            stored += recv * 2

        kv.set_updater(updater)
        kv.push(3, [mt.nd.array(v, ctx=c) for v, c in zip(vals, placed)])
        kv.pull(3, out=outs)
        upd = all(torch.equal(o._data.cpu(), want_sum + want_sum * 2)
                  for o in outs)
        kv = mt.kv.create(kind)
        kv.set_optimizer(mt.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                          rescale_grad=0.25, wd=1e-4))
        kv.init(0, mt.nd.array(w0, ctx=ctxs[0]))
        for v in vals[:3]:
            kv.push(0, mt.nd.array(v, ctx=ctxs[0]))
        kv.pull(0, out=outs)
        sgd = all(torch.equal(o._data.cpu(), want_sgd) for o in outs)
        out[kind] = dict(aggregation=agg, updater=upd, sgd_momentum=sgd)
        log("  kvstore %s over %s: pushed list summed bit for bit %s; "
            "updater %s; SGD momentum on the store %s"
            % (kind, ctxs, agg, upd, sgd))
        if not (agg and upd and sgd):
            raise AssertionError("kvstore %s disagrees with the host: %s"
                                 % (kind, out[kind]))
    return out


class StepClock:
    """Host-clock ms of each ``fit`` step, each ending in a device sync
    of every card in use (a batch-end callback)."""

    def __init__(self, n_devices=1):
        self.n = n_devices
        self.stamps = []

    def __call__(self, param):
        for i in range(self.n):
            torch.cuda.synchronize(i)
        self.stamps.append(time.perf_counter())

    def ms(self, start):
        return [float(v) for v in np.diff([start] + self.stamps) * 1e3]


def fit_resnet(mt, contexts, x, y, batch, num_epoch, seed, kvstore,
               on_module=None, mesh=None, cards=None, snaps=None):
    """ResNet-50 v2 through Module.fit over ``contexts`` (with ``mesh``,
    over the mesh's devices: ``cards`` of them where the mesh is not a
    count) from Xavier weights drawn with the numpy ``seed`` (phase 7's
    configuration), ``on_module(mod)`` called before the fit, the
    parameters after the first step appended to ``snaps``: (module,
    step ms, cross-entropy by step)."""
    mod = mt.mod.Module(mt.models.get_resnet(**RESNET), context=contexts)
    if on_module is not None:
        on_module(mod)
    clock = StepClock(cards or max(len(contexts), mesh or 1))
    ce = []

    def record(param):
        clock(param)
        ce.append(dict(zip(*param.eval_metric.get()))["cross-entropy"])
        param.eval_metric.reset()
        if snaps is not None and len(ce) == 1:
            snaps.append(mod.get_params())

    np.random.seed(seed)
    for i in range(clock.n):
        torch.cuda.synchronize(i)
    start = time.perf_counter()
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=batch), num_epoch=num_epoch,
            eval_metric=["acc", "ce"], optimizer="sgd", kvstore=kvstore,
            optimizer_params={"learning_rate": RESNET_TRAIN["lr"],
                              "momentum": RESNET_TRAIN["momentum"],
                              "rescale_grad": 1.0 / batch},
            initializer=mt.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            batch_end_callback=record, metric_sync=1, mesh=mesh)
    return mod, clock.ms(start), ce


def scaled_dist(a, b):
    """max over arrays of |a - b| / max(1, |b|)."""
    return max(float((a[k]._data.double() - b[k]._data.double()).abs()
                     .max()) / max(1.0, float(b[k]._data.abs().max()))
               for k in b)


class DeterministicCudnn:
    """cuDNN's deterministic algorithms inside the block (two runs of one
    step then give the same bits), the flags restored after."""

    def __enter__(self):
        self.flags = (torch.backends.cudnn.deterministic,
                      torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = self.flags


def phase_data_parallel(mt, epi, seed, card, module_row=None):
    """Phase 9 on one card: the KVStore cases on CUDA values, then
    ResNet-50 v2 at phase 7's configuration trained for 4 steps through
    ``fit(kvstore="dist_sync")`` on a one-rank NCCL group (the kvstore
    path: every parameter pushed, all-reduced over NCCL, updated by the
    Updater on the store and pulled). With cuDNN deterministic it is held
    to the same 4 steps through the fused local path (without it two runs
    of one path already part: cuDNN's weight gradients add with atomics,
    and the trajectories separate); then it runs again with cuDNN as
    phase 7 runs it, timed, and the trained model's evaluation forward
    goes through the epilogue."""
    import torch.distributed as dist
    row = {"kvstore": kvstore_cases(mt, [mt.gpu(0)])}
    x, y = resnet_train_data(seed)
    b, steps = RESNET_TRAIN["batch"], DP_STEPS
    x, y = x[:2 * b], y[:2 * b]
    epochs = steps * b // len(x)
    push_ms = []

    def time_update(mod):  # the push/pull loop's host time
        update = mod.update

        def timed():
            t0 = time.perf_counter()
            update()
            push_ms.append((time.perf_counter() - t0) * 1e3)

        mod.update = timed

    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:%d"
                            % free_port(), world_size=1, rank=0)
    try:
        with DeterministicCudnn():
            fused, fused_ms, fused_ce = fit_resnet(
                mt, [mt.gpu(0)], x, y, b, epochs, seed, "local")
            if fused._fused is None:
                raise AssertionError("the local run did not take the fused "
                                     "step")
            want = fused.get_params()
            del fused
            mod, det_ms, det_ce = fit_resnet(mt, [mt.gpu(0)], x, y, b,
                                             epochs, seed, "dist_sync")
            got = mod.get_params()
            del mod
        torch.cuda.empty_cache()
        mod, ms, ce = fit_resnet(mt, [mt.gpu(0)], x, y, b, epochs, seed,
                                 "dist_sync", on_module=time_update)
        kv = mod._kvstore
        if kv is None or kv.type != "dist_sync" or kv.num_workers != 1 or \
                mod._fused is not None or not mod._update_on_kvstore:
            raise AssertionError("dist_sync did not take the kvstore path")
    finally:
        dist.destroy_process_group()
    dw, da = scaled_dist(got[0], want[0]), scaled_dist(got[1], want[1])
    same = all(torch.equal(g[k]._data, w[k]._data)
               for g, w in zip(got, want) for k in w)
    row.update(dist_sync_step_ms=ms, dist_sync_ce=ce,
               push_pull_host_ms=push_ms, deterministic_fused_ce=fused_ce,
               deterministic_dist_sync_ce=det_ce,
               deterministic_fused_step_ms=fused_ms,
               deterministic_dist_sync_step_ms=det_ms, weights_dist=dw,
               stats_dist=da, bit_identical=same, steps=steps, batch=b)
    inner = float(np.mean([v for i, v in enumerate(ms) if i % 2]))
    row["dist_sync_step_ms_within_epoch"] = inner
    mod_ms = (module_row or {}).get("step_ms_within_epoch")
    log("  with cuDNN deterministic, after %d steps: dist_sync vs the fused "
        "local path weights %.3e, moving statistics %.3e (max |a - b| / "
        "max(1, |b|)); bit-identical %s; cross-entropy fused %s, dist_sync "
        "%s" % (steps, dw, da, same, [round(v, 4) for v in fused_ce],
                [round(v, 4) for v in det_ce]))
    log("  [%s] ResNet-50 v2, B=%d, %d steps, fit(kvstore=\"dist_sync\") on "
        "a one-rank NCCL group: cross-entropy %s; step ms %s (steps inside "
        "an epoch %.2f); the update's push/pull loop, host ms a step %s; "
        "phase 7's step inside an epoch %s"
        % (card, b, steps, [round(v, 4) for v in ce],
           [round(v, 1) for v in ms], inner, [round(v, 1) for v in push_ms],
           "%.2f" % mod_ms if mod_ms is not None else "not run"))
    if not np.all(np.isfinite(ce)) or not ce[-1] < ce[0]:
        raise AssertionError("dist_sync training did not lower a finite "
                             "cross-entropy: %s" % ce)
    if not (dw <= 1e-4 and da <= 1e-4):
        raise AssertionError("dist_sync is %.3e / %.3e from the fused local "
                             "path (gate 1e-4)" % (dw, da))
    batch = mt.io.DataBatch([mt.nd.array(x[:b], ctx=mt.cpu())],
                            [mt.nd.array(y[:b], ctx=mt.cpu())])

    def forward():
        mod.forward(batch, is_train=False)
        return mod.get_outputs()[0]._data

    row.update(eval_forward_gate(
        epi, forward, lambda: mod._exec_group.execs[0].fused_sites,
        "dist_sync-trained model's evaluation forward"))
    del mod
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------- --multi-gpu
def kernels_on_device(att, epi, i):
    """Each kernel on cuda:i against its plain version there, with
    phases 3, 3b and 3c's gates: flash forward (LM shape at B=1, and an
    edge), flash backward (scaled error) and the epilogue (bit for bit,
    NaN positions equal); returns the launches made."""
    dev = torch.device("cuda", i)
    gen = torch.Generator(device=dev).manual_seed(i)
    before = (att.flash_attention.launches,
              att.flash_attention_backward.launches,
              epi.bn_apply_relu_add.launches)
    rows = []
    with torch.cuda.device(dev):
        for dtype in (torch.float32, torch.bfloat16):
            for b, h, t, s, d in ((1, 12, 1024, 1024, 64),
                                  (2, 3, 129, 65, 64)):
                q, k, v, do = (torch.randn(b, h, n, d, device=dev,
                                           generator=gen).to(dtype)
                               for n in (t, s, s, t))
                scale = att._scale(d, None)
                out, lse = att._flash_forward(q, k, v, True, scale,
                                              want_lse=True)
                ref, ref_lse = att.flash_attention_reference(
                    q, k, v, causal=True, return_lse=True)
                fwd = abs_err(out, ref)
                lse_err = abs_err(lse, ref_lse)
                grads = att.flash_attention_backward(q, k, v, out, do, lse,
                                                     causal=True)
                want = att.flash_attention_backward_reference(
                    q, k, v, out, do, lse, causal=True)
                bwd = max(rel_err(g, w) for g, w in zip(grads, want))
                ok = (fwd <= TOL[dtype] and lse_err <= LSE_TOL[dtype]
                      and bwd <= BWD_TOL[dtype]
                      and all(g.device == dev for g in grads))
                rows.append(dict(dtype=str(dtype).split(".")[-1],
                                 shape=(b, h, t, s, d), fwd_err=fwd,
                                 lse_err=lse_err, bwd_err=bwd, ok=ok))
        for (shape, axis) in EPILOGUE_CASES[2:4]:
            x, scale, shift, _ = epilogue_inputs(shape, axis, torch.float32,
                                                 False, gen)
            x = x.to(dev)
            x.view(-1)[::97] = float("nan")
            got = epi.bn_apply_relu_add(x, scale.to(dev), shift.to(dev),
                                        axis=axis)
            want = epi.bn_apply_relu_add_reference(x, scale.to(dev),
                                                   shift.to(dev), None, axis)
            err = bit_err(got, want)
            rows.append(dict(dtype="float32", shape=shape, epilogue_err=err,
                             ok=err == 0 and got.device == dev))
    torch.cuda.synchronize(dev)
    launches = [a - b for a, b in zip(
        (att.flash_attention.launches, att.flash_attention_backward.launches,
         epi.bn_apply_relu_add.launches), before)]
    bad = [r for r in rows if not r["ok"]]
    log("  cuda:%d: flash fwd/bwd %s; epilogue max err %s; launches "
        "(fwd, bwd, epilogue) %s"
        % (i, ["%s %s fwd %.1e lse %.1e bwd %.1e" % (
            r["dtype"], r["shape"], r["fwd_err"], r["lse_err"], r["bwd_err"])
            for r in rows if "fwd_err" in r],
           [r["epilogue_err"] for r in rows if "epilogue_err" in r],
           launches))
    if bad:
        raise AssertionError("kernels on cuda:%d disagree with their plain "
                             "versions: %s" % (i, bad))
    return dict(rows=rows, launches=launches)


class DeviceTally:
    """Wraps a function of the port (looked up by name on its module at
    each call) and counts its calls by the device of its first tensor
    argument; ``restore`` puts the function back."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.by_device = {}
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        dev = str(next(a for a in args if isinstance(a, torch.Tensor))
                  .device)
        self.by_device[dev] = self.by_device.get(dev, 0) + 1
        return self.fn(*args, **kw)

    def restore(self):
        setattr(self.module, self.name, self.fn)


class CollectiveClock:
    """Times a collective of ``module/fused.py`` (looked up by ``name``
    there, as the fused step calls it; or of ``ops/collective.py``, whose
    group collectives the tp/fsdp walk calls): host ms of each call and
    device ms between CUDA events recorded on each card's current stream
    around it (the largest). ``sum_replicas`` is the replicated step's
    gradient sum; ``reduce_scatter_replicas`` / ``all_gather_replicas``
    the sharded step's."""

    def __init__(self, fused, name="sum_replicas"):
        self.fused, self.name = fused, name
        self.fn = getattr(fused, name)
        self.host_ms, self.pending = [], []
        setattr(fused, name, self)

    def __call__(self, buffers, *rest):
        devs = [b.device for b in buffers]
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in devs]
        for (s, _), d in zip(ev, devs):
            s.record(torch.cuda.current_stream(d))
        t0 = time.perf_counter()
        out = self.fn(buffers, *rest)
        self.host_ms.append((time.perf_counter() - t0) * 1e3)
        for (_, e), d in zip(ev, devs):
            e.record(torch.cuda.current_stream(d))
        self.pending.append(ev)
        return out

    def device_ms(self):
        out = []
        for ev in self.pending:
            for _, e in ev:
                e.synchronize()
            out.append(max(s.elapsed_time(e) for s, e in ev))
        return out

    def restore(self):
        setattr(self.fused, self.name, self.fn)


def host_step_ms(mod, batch, n, n_devices):
    """Host-clock ms of ``n`` training steps on one batch, each started
    after a sync of every card: ``fwd``/``bwd``/``update`` until each call
    returns (the host's dispatch; a call may also wait on the card), then
    ``sync`` until every card is done, and ``step`` in all."""
    out = {k: [] for k in ("fwd", "bwd", "update", "sync", "step")}
    for _ in range(n):
        for i in range(n_devices):
            torch.cuda.synchronize(i)
        t = [time.perf_counter()]
        mod._forward(batch, True, coupled=mod._fused is not None)
        t.append(time.perf_counter())
        mod.backward()
        t.append(time.perf_counter())
        mod.update()
        t.append(time.perf_counter())
        for i in range(n_devices):
            torch.cuda.synchronize(i)
        t.append(time.perf_counter())
        for k, a, b in zip(("fwd", "bwd", "update", "sync"), t, t[1:]):
            out[k].append((b - a) * 1e3)
        out["step"].append((t[-1] - t[0]) * 1e3)
    return out


def device_busy_ms(step, n_devices):
    """``step()`` once to warm, then once under torch.profiler: the summed
    kernel time of each card (its busy time in the step)."""
    from torch.profiler import ProfilerActivity, profile as _prof
    step()
    for i in range(n_devices):
        torch.cuda.synchronize(i)
    with _prof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        step()
        for i in range(n_devices):
            torch.cuda.synchronize(i)
    busy = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            busy[e.device_index] = busy.get(e.device_index, 0.0) + \
                e.device_time_total / 1e3
    return {"cuda:%d" % k: v for k, v in sorted(busy.items())}


def multi_resnet(mt, epi, seed, card, n):
    """ResNet-50 v2 Module.fit over [gpu(0..n-1)], kvstore "device",
    B=256 in all (256/n a card), 8 steps: the fused path, BatchNorm over
    the whole batch, one NCCL sum a step. Timed beside one context at
    B=256/n (weak scaling) and at B=256 (strong scaling) in the same
    call."""
    from mxtpu_torch.module import fused as fused_mod
    from mxtpu_torch.ops import nn as nn_ops
    cfg = MULTI
    b, steps = cfg["batch"], cfg["steps"]
    x, y = resnet_train_data(seed)
    ctxs = [mt.gpu(i) for i in range(n)]
    for i in range(n):
        torch.cuda.reset_peak_memory_stats(i)
    clock = CollectiveClock(fused_mod)
    try:
        mod, ms, ce = fit_resnet(mt, ctxs, x, y, b, steps * b // len(x),
                                 seed, "device")
        sum_device = clock.device_ms()
        sum_host = list(clock.host_ms)
    finally:
        clock.restore()
    peaks = [torch.cuda.max_memory_allocated(i) for i in range(n)]
    if mod._fused is None:
        raise AssertionError("the %d-card fit did not take the fused step"
                             % n)
    log("  cross-entropy by step: %s" % [round(v, 4) for v in ce])
    if len(ce) != steps or not np.all(np.isfinite(ce)) or \
            not ce[-1] < ce[0]:
        raise AssertionError("%d-card training did not lower a finite "
                             "cross-entropy: %s" % (n, ce))
    execs = mod._exec_group.execs
    differ = replicas_differ(mod)
    log("  replicas bit-identical after %d steps: %s (%d params, %d "
        "statistics)" % (steps, not differ, len(mod._param_names),
                         len(mod._aux_names)))
    if differ:
        raise AssertionError("replicas differ in %s" % differ[:5])
    grad_mb = sum(f.numel() * f.element_size() for f in
                  mod._exec_group.flat_grads[0].values()) / 1e6
    batch = mt.io.DataBatch([mt.nd.array(x[:b], ctx=mt.cpu())],
                            [mt.nd.array(y[:b], ctx=mt.cpu())])
    split = host_step_ms(mod, batch, 4, n)
    busy = device_busy_ms(lambda: (mod.forward_backward(batch),
                                   mod.update()), n)
    inner = [v for i, v in enumerate(ms) if i % 2 and i > 1]
    tally = DeviceTally(nn_ops, "bn_apply_relu_add")

    def forward():
        mod.forward(batch, is_train=False)
        return mod.get_outputs()[0]._data

    try:
        gate = eval_forward_gate(epi, forward, lambda: sum(
            e.fused_sites for e in execs), "%d-card evaluation forward" % n,
            expect=RESNET_SITES * n)
    finally:
        tally.restore()
    per_dev = dict(tally.by_device)
    log("  epilogue launches of one evaluation forward by device: %s"
        % per_dev)
    if sorted(per_dev.values()) != [RESNET_SITES] * n:
        raise AssertionError("epilogue launches by device %s, want %d each"
                             % (per_dev, RESNET_SITES))
    del mod
    torch.cuda.empty_cache()
    # the same step on one card: weak (B/n) and strong (B) scaling
    single, one_split = {}, None
    for bb in (b // n, b):
        one, one_ms, _ = fit_resnet(mt, [mt.gpu(0)], x[:2 * bb], y[:2 * bb],
                                    bb, 2, seed, "local")
        single[bb] = one_ms
        if bb == b // n:  # one replica's host split, for the n-card one
            one_split = host_step_ms(one, mt.io.DataBatch(
                [mt.nd.array(x[:bb], ctx=mt.cpu())],
                [mt.nd.array(y[:bb], ctx=mt.cpu())]), 4, 1)
        del one
        torch.cuda.empty_cache()
    step = float(np.mean(inner))
    row = dict(cards=n, batch=b, steps=steps, ce=ce, step_ms=ms,
               step_ms_within_epoch=step, images_per_s=b / (step / 1e3),
               sum_device_ms=sum_device, sum_host_ms=sum_host,
               grad_mb_per_card=grad_mb,
               host_split_ms=split, device_busy_ms=busy,
               one_card_host_split_ms=one_split,
               max_memory_allocated=[int(p) for p in peaks],
               single_step_ms={str(k): v for k, v in single.items()},
               eval_launches_by_device=per_dev, **gate)
    row["images_per_s_per_chip"] = row["images_per_s"] / n
    one_small = float(np.mean(single[b // n][1::2][1:] or
                              single[b // n][1:]))
    one_big = float(np.mean(single[b][1::2][1:] or single[b][1:]))
    row["weak"] = dict(one_card_step_ms=one_small,
                       one_card_images_per_s=(b // n) / (one_small / 1e3),
                       efficiency=row["images_per_s_per_chip"]
                       / ((b // n) / (one_small / 1e3)))
    row["strong"] = dict(one_card_step_ms=one_big,
                         one_card_images_per_s=b / (one_big / 1e3),
                         speedup=one_big / step)
    log("  [%s] ResNet-50 v2 over %d cards, B=%d (%d a card): step ms %s; "
        "inside an epoch %.2f ms, %.1f images/s, %.1f images/s per chip; "
        "one card at B=%d %.2f ms (%.1f images/s): weak-scaling efficiency "
        "%.1f%%; one card at B=%d %.2f ms: speedup %.2fx"
        % (card, n, b, b // n, [round(v, 1) for v in ms], step,
           row["images_per_s"], row["images_per_s_per_chip"], b // n,
           one_small, row["weak"]["one_card_images_per_s"],
           100.0 * row["weak"]["efficiency"], b, one_big,
           row["strong"]["speedup"]))
    log("  gradient sum (one NCCL all-reduce of %.1f MB a card): device ms "
        "%s, host ms %s; peak memory by card %s GB"
        % (grad_mb, [round(v, 3) for v in sum_device],
           [round(v, 3) for v in sum_host],
           [round(p / 1e9, 2) for p in peaks]))
    log("  a step on the host clock, each part until its call returns: %s "
        "(one card at B=%d: %s); kernel time of one profiled step by card "
        "%s ms" % ({k: [round(v, 1) for v in vs] for k, vs in split.items()},
                   b // n, {k: [round(v, 1) for v in vs]
                            for k, vs in one_split.items()},
                   {k: round(v, 2) for k, v in busy.items()}))
    return row


def multi_lm(mt, att, seed, card, n):
    """The LM at phase 6's widths and depth over [gpu(0..n-1)], B=4 a
    card, Adam, 4 steps through Module.fit: tokens/s, and 12 flash
    forward and 12 backward launches a step on every card."""
    cfg = dict(LM)
    per, steps = MULTI["lm_batch"], MULTI["lm_steps"]
    x, y = lm_batch(seed, per * n, cfg["seq_len"], cfg["vocab_size"])
    mod = mt.mod.Module(mt.models.get_transformer_lm(**cfg),
                        context=[mt.gpu(i) for i in range(n)])
    np.random.seed(seed)
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mod.init_params(mt.init.Xavier())
    clock, ce = StepClock(n), []

    def record(param):
        clock(param)
        ce.append(param.eval_metric.get()[1])
        param.eval_metric.reset()

    fwd = DeviceTally(att, "_launch")
    bwd = DeviceTally(att, "_launch_bwd")
    try:
        start = time.perf_counter()
        mod.fit(RepeatBatch(mt, x, y, steps), num_epoch=1, eval_metric="ce",
                optimizer="adam", kvstore="device",
                optimizer_params={"learning_rate": TRAIN["lr"]},
                initializer=None, batch_end_callback=record, metric_sync=1)
        ms = clock.ms(start)
    finally:
        fwd.restore()
        bwd.restore()
    by_dev = {d: (fwd.by_device.get(d, 0) // steps,
                  bwd.by_device.get(d, 0) // steps)
              for d in sorted(set(fwd.by_device) | set(bwd.by_device))}
    want = cfg["num_layers"]
    tokens = per * n * cfg["seq_len"]
    mean = float(np.mean(ms[1:]))
    row = dict(cards=n, batch_per_card=per, steps=steps, ce=ce, step_ms=ms,
               step_ms_mean=mean, tokens_per_s=tokens / (mean / 1e3),
               launches_per_step_by_device=by_dev,
               fused=mod._fused is not None,
               fwd_launches=sum(fwd.by_device.values()),
               bwd_launches=sum(bwd.by_device.values()))
    log("  [%s] LM over %d cards, B=%d a card, Adam: cross-entropy %s; step "
        "ms %s (mean after the first %.2f, %.0f tokens/s); flash launches a "
        "step by device (fwd, bwd) %s" % (
            card, n, per, [round(v, 4) for v in ce],
            [round(v, 1) for v in ms], mean, row["tokens_per_s"], by_dev))
    if not row["fused"] or not np.all(np.isfinite(ce)) or \
            not ce[-1] < ce[0]:
        raise AssertionError("LM over %d cards: fused %s, cross-entropy %s"
                             % (n, row["fused"], ce))
    if len(by_dev) != n or any(v != (want, want) for v in by_dev.values()):
        raise AssertionError("flash launches a step by device %s, want %d "
                             "each" % (by_dev, want))
    del mod
    torch.cuda.empty_cache()
    return row


def multi_gluon(mt, seed, card, n):
    """Gluon's resnet50_v2, hybridized, over [gpu(0..n-1)]: split_and_load,
    autograd.record, Trainer(kvstore="device") (each parameter pushed from
    every card and pulled back), 4 steps of B=256: step ms and the
    Trainer's push/pull host ms."""
    cfg = MULTI
    b, steps = cfg["batch"], cfg["gluon_steps"]
    x, y = resnet_train_data(seed)
    ctxs = [mt.gpu(i) for i in range(n)]
    np.random.seed(seed)
    net = mt.gluon.model_zoo.vision.resnet50_v2(
        classes=RESNET["num_classes"])
    net.initialize(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=ctxs)
    net.hybridize()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": RESNET_TRAIN["lr"],
        "momentum": RESNET_TRAIN["momentum"]}, kvstore="device")
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    step_ms, push_ms, losses = [], [], []
    for i in range(steps):
        lo = (i * b) % len(x)
        data = mt.gluon.utils.split_and_load(
            mt.nd.array(x[lo:lo + b], ctx=mt.cpu()), ctxs)
        label = mt.gluon.utils.split_and_load(
            mt.nd.array(y[lo:lo + b], ctx=mt.cpu()), ctxs)
        for j in range(n):
            torch.cuda.synchronize(j)
        t0 = time.perf_counter()
        with mt.autograd.record():
            ls = [loss_fn(net(d), l) for d, l in zip(data, label)]
        mt.autograd.backward(ls)
        t1 = time.perf_counter()
        trainer.step(b)
        push_ms.append((time.perf_counter() - t1) * 1e3)
        for j in range(n):
            torch.cuda.synchronize(j)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(sum(float(l.mean().asscalar()) for l in ls) / n))
    first = {k: p.list_data() for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    differ = [k for k, ds in first.items()
              if any(not torch.equal(d._data.cpu(), ds[0]._data.cpu())
                     for d in ds[1:])]
    mean = float(np.mean(step_ms[1:]))
    log("  [%s] Gluon resnet50_v2 hybridized over %d cards, B=%d: loss %s; "
        "step ms %s (mean after the first %.2f, %.1f images/s); "
        "Trainer.step host ms (push/pull of %d parameters) %s; weights "
        "identical on every card %s"
        % (card, n, b, [round(v, 4) for v in losses],
           [round(v, 1) for v in step_ms], mean, b / (mean / 1e3),
           len(first), [round(v, 1) for v in push_ms], not differ))
    if not np.all(np.isfinite(losses)) or differ:
        raise AssertionError("Gluon over %d cards: losses %s, differing %s"
                             % (n, losses, differ[:5]))
    del net, trainer
    torch.cuda.empty_cache()
    return dict(cards=n, batch=b, steps=steps, losses=losses,
                step_ms=step_ms, step_ms_mean=mean,
                images_per_s=b / (mean / 1e3), trainer_step_host_ms=push_ms)


def dist_worker(seed, out_dir):
    """One rank of ``--dist-worker``: ResNet-50 v2 through
    ``fit(kvstore="dist_sync")`` on gpu(LOCAL_RANK), its 1/world of every
    B=256 batch; writes its step ms and digests of its weights and of its
    moving statistics."""
    import hashlib
    import mxtpu_torch as mt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    b, steps = MULTI["batch"], MULTI["dist_steps"]
    per = b // world
    x, y = resnet_train_data(seed)
    idx = np.concatenate([np.arange(i + rank * per, i + (rank + 1) * per)
                          for i in range(0, len(x), b)])
    mod, ms, ce = fit_resnet(mt, [mt.gpu(local)], x[idx], y[idx], per,
                             steps * b // len(x), seed, "dist_sync")
    kv = mod._kvstore
    digests = []
    for d in mod.get_params():
        h = hashlib.sha256()
        for k in sorted(d):
            h.update(d[k].asnumpy().tobytes())
        digests.append(h.hexdigest())
    row = dict(rank=rank, world=kv.num_workers, kv_rank=kv.rank,
               fused=mod._fused is not None, step_ms=ms, ce=ce,
               digest=digests[0], aux_digest=digests[1])
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(row, f)
    kv.barrier()
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def multi_dist(seed, card, n):
    """``dist_sync`` with n processes, one per card, NCCL: each runs
    ``chip_smoke.py --dist-worker``; their weights must be bit-identical
    (one digest). The moving statistics are each rank's own."""
    import tempfile
    out = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    port = free_port()
    procs = []
    try:
        for r in range(n):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-worker",
                 "--seed", str(seed), "--out", out], env=env))
        rcs = [p.wait(timeout=600) for p in procs]
        rows = []
        for r in range(n):
            with open(os.path.join(out, "rank%d.json" % r)) as f:
                rows.append(json.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(out, ignore_errors=True)
    digests = {r["digest"] for r in rows}
    aux = {r["aux_digest"] for r in rows}
    mean = [float(np.mean(r["step_ms"][1:])) for r in rows]
    log("  [%s] dist_sync over %d processes (NCCL), ResNet-50 v2, B=%d (%d "
        "a rank), %d steps: rcs %s; step ms by rank %s (means after the "
        "first %s); cross-entropy (rank 0) %s; weights bit-identical "
        "across ranks %s; moving statistics differ (each rank's BatchNorm "
        "on its own rows, as mxtpu's kvstore path) %s"
        % (card, n, MULTI["batch"], MULTI["batch"] // n,
           MULTI["dist_steps"], rcs,
           [[round(v, 1) for v in r["step_ms"]] for r in rows],
           [round(v, 2) for v in mean], [round(v, 4) for v in rows[0]["ce"]],
           len(digests) == 1, len(aux) == n))
    if any(rcs) or len(digests) != 1 or any(
            r["world"] != n or r["kv_rank"] != r["rank"] or r["fused"]
            for r in rows):
        raise AssertionError("dist_sync over %d processes: rcs %s, %d "
                             "digests, rows %s" % (n, rcs, len(digests),
                                                   rows))
    return dict(processes=n, step_ms=[r["step_ms"] for r in rows],
                step_ms_mean=mean, ce=rows[0]["ce"])


def replicas_differ(mod):
    """Names of the parameters and statistics whose replicas are not the
    same bits as the first."""
    execs = mod._exec_group.execs
    differ = []
    for name in mod._param_names:
        w0 = execs[0].arg_dict[name]._data.cpu()
        differ += [name for e in execs[1:]
                   if not torch.equal(e.arg_dict[name]._data.cpu(), w0)]
    for name in mod._aux_names:
        a0 = execs[0].aux_dict[name]._data.cpu()
        differ += [name for e in execs[1:]
                   if not torch.equal(e.aux_dict[name]._data.cpu(), a0)]
    return differ


class OrderedCollectives:
    """Inside the block, the fused step's collectives (``sum_replicas``,
    ``reduce_scatter_replicas``, ``all_gather_replicas`` as
    ``module/fused.py`` calls them) add the replicas in replica order on
    the first one's card and copy the result out: every element is
    summed in the same order on both the replicated and the sharded
    path, which NCCL's all-reduce and reduce-scatter do not promise (and
    a last-bit difference grows to ~1e-2 in 4 steps of this training, as
    a difference from cuDNN's atomics does)."""

    def __init__(self, fused):
        self.fused = fused

    @staticmethod
    def _total(bufs):
        total = bufs[0].clone()
        for b in bufs[1:]:
            total += b.to(total.device)
        return total

    def sum_replicas(self, bufs):
        total = self._total(bufs)
        for b in bufs:
            b.copy_(total)

    def reduce_scatter_replicas(self, ins, outs):
        rows = self._total(ins).view(len(ins), -1)
        for r, o in enumerate(outs):
            o.copy_(rows[r])

    def all_gather_replicas(self, ins, outs):
        for o in outs:
            for s, x in enumerate(ins):
                o.view(len(ins), -1)[s].copy_(x)

    NAMES = ("sum_replicas", "reduce_scatter_replicas",
             "all_gather_replicas")

    def __enter__(self):
        self.saved = {k: getattr(self.fused, k) for k in self.NAMES}
        for k in self.NAMES:
            setattr(self.fused, k, getattr(self, k))

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(self.fused, k, fn)


class CheckedCollectives:
    """Holds the first call of each of the fused step's collectives
    (``reduce_scatter_replicas``, ``all_gather_replicas``,
    ``sum_replicas`` as ``module/fused.py`` calls them: NCCL on the
    cards) to the host's arithmetic on the same buffers, computed in
    float64 on the first card: a sum within n * 2^-24 * sum |x| (+ the
    smallest normal f32) of the exact sum, elementwise, which bounds
    n - 1 f32 additions in any order; replica r of a reduce-scatter
    given the r-th block of the sum; the all-reduce's replicas the same
    bits; an all-gather's every block the bits of its source. ``worst``
    is the largest error over its bound, by collective."""

    NAMES = ("reduce_scatter_replicas", "all_gather_replicas",
             "sum_replicas")

    def __init__(self, fused):
        self.fused = fused
        self.saved = {k: getattr(fused, k) for k in self.NAMES}
        self.worst, self.elements = {}, {}
        for k in self.NAMES:
            setattr(fused, k, self._wrap(k))

    def _wrap(self, name):
        def call(*args):
            if name in self.worst:
                return self.saved[name](*args)
            ins, outs = args[0], args[-1]
            if name != "all_gather_replicas":
                dev0 = ins[0].device
                exact = sum(b.double().to(dev0) for b in ins)
                bound = sum(b.double().abs().to(dev0) for b in ins) * (
                    len(ins) * 2.0 ** -24) + torch.finfo(torch.float32).tiny
            self.saved[name](*args)
            n = len(ins)
            if name == "all_gather_replicas":
                same = all(torch.equal(o.view(n, -1)[s_],
                                       x.to(o.device).reshape(-1))
                           for o in outs for s_, x in enumerate(ins))
                worst = 0.0 if same else float("inf")
            else:
                blocks = [exact.view(n, -1)[r] if outs is not ins else exact
                          for r in range(n)]
                bounds = [bound.view(n, -1)[r] if outs is not ins else bound
                          for r in range(n)]
                worst = max(float(((o.double().to(exact.device)
                                    .reshape(w.shape) - w).abs()
                                   / b).max())
                            for o, w, b in zip(outs, blocks, bounds))
                if outs is ins and not all(torch.equal(o.to(dev0), outs[0])
                                           for o in outs[1:]):
                    worst = float("inf")
            self.worst[name] = worst
            self.elements[name] = sum(o.numel() for o in outs)
        return call

    def restore(self):
        for k, fn in self.saved.items():
            setattr(self.fused, k, fn)


def multi_mesh(mt, epi, seed, card, n, replicated=None):
    """ResNet-50 v2 through ``Module(context=gpu(0)).fit(mesh=n)``: the
    fused step over the mesh's n cards with cross-replica weight-update
    sharding (one reduce-scatter of the gradients, each card's SGD on its
    1/n of the sharded parameters' rows, one all-gather), B=256, 8 steps.
    Gates: the plan armed; after 4 steps with cuDNN deterministic and the
    collectives summing in replica order (``OrderedCollectives``), the
    weights and statistics within 1e-4 (of max(1, |w|)) of the replicated
    fused path over [gpu(0..n-1)] from the same weights and batches; then,
    on NCCL, the first step's reduce-scatter, all-gather and all-reduce
    held to the host's arithmetic (``CheckedCollectives``), one
    reduce-scatter and one all-gather a step; the replicas
    bit-identical; each card's optimizer-state bytes at most total/n plus
    the replicated states; the evaluation forward's 50 epilogue launches
    on each card."""
    from mxtpu_torch.module import fused as fused_mod
    from mxtpu_torch.ops import nn as nn_ops
    b, steps = MULTI["batch"], MULTI["steps"]
    x, y = resnet_train_data(seed)
    with DeterministicCudnn(), OrderedCollectives(fused_mod):
        rep, _, _ = fit_resnet(mt, [mt.gpu(i) for i in range(n)], x[:2 * b],
                               y[:2 * b], b, DP_STEPS * b // (2 * b), seed,
                               "device")
        want = rep.get_params()
        del rep
        torch.cuda.empty_cache()
        msh, _, _ = fit_resnet(mt, [mt.gpu(0)], x[:2 * b], y[:2 * b], b,
                               DP_STEPS * b // (2 * b), seed, "local",
                               mesh=n)
        got = msh.get_params()
        del msh
        torch.cuda.empty_cache()
    dw, da = scaled_dist(got[0], want[0]), scaled_dist(got[1], want[1])
    same = all(torch.equal(g[k]._data, w[k]._data)
               for g, w in zip(got, want) for k in w)
    log("  with cuDNN deterministic and the collectives in replica order, "
        "after %d steps: fit(mesh=%d) vs the replicated fused path over %d "
        "cards: weights %.3e, moving statistics %.3e (max |a - b| / max(1, "
        "|b|)); bit-identical %s" % (DP_STEPS, n, n, dw, da, same))
    if not (dw <= 1e-4 and da <= 1e-4):
        raise AssertionError("fit(mesh=%d) is %.3e / %.3e from the "
                             "replicated path (gate 1e-4)" % (n, dw, da))
    for i in range(n):
        torch.cuda.reset_peak_memory_stats(i)
    clocks = [CollectiveClock(fused_mod, k) for k in (
        "reduce_scatter_replicas", "all_gather_replicas", "sum_replicas")]
    checked = CheckedCollectives(fused_mod)
    try:
        mod, ms, ce = fit_resnet(mt, [mt.gpu(0)], x, y, b,
                                 steps * b // len(x), seed, "local",
                                 mesh=n)
        coll = {c.name: dict(device_ms=c.device_ms(), host_ms=c.host_ms)
                for c in clocks}
    finally:
        checked.restore()
        for c in clocks:
            c.restore()
    log("  the first step's collectives on NCCL against the host's "
        "arithmetic, largest error over its bound (elements): %s"
        % {k: "%.3f (%d)" % (v, checked.elements[k])
           for k, v in checked.worst.items()})
    if sorted(checked.worst) != sorted(CheckedCollectives.NAMES) or \
            max(checked.worst.values()) > 1.0:
        raise AssertionError("the sharded step's collectives on NCCL: "
                             "error over bound %s" % checked.worst)
    peaks = [torch.cuda.max_memory_allocated(i) for i in range(n)]
    fused = mod._fused
    if fused is None or fused._plan is None:
        raise AssertionError("fit(mesh=%d) did not arm the sharded step" % n)
    log("  cross-entropy by step: %s" % [round(v, 4) for v in ce])
    if len(ce) != steps or not np.all(np.isfinite(ce)) or \
            not ce[-1] < ce[0]:
        raise AssertionError("fit(mesh=%d) did not lower a finite "
                             "cross-entropy: %s" % (n, ce))
    calls = {k: len(v["host_ms"]) for k, v in coll.items()}
    if calls["reduce_scatter_replicas"] != steps or \
            calls["all_gather_replicas"] != steps:
        raise AssertionError("collective calls over %d steps: %s"
                             % (steps, calls))
    differ = replicas_differ(mod)
    sharded = set(fused.sharded_names)
    per_card = fused.opt_state_bytes()
    block = {k: sum(t.numel() * t.element_size() for t in
                    (s if isinstance(s, tuple) else (s,)) if t is not None)
             for k, s in fused.opt_state[0].items()}
    total = sum(v * (n if k in sharded else 1) for k, v in block.items())
    repl = sum(v for k, v in block.items() if k not in sharded)
    log("  replicas bit-identical after %d steps: %s; %d of %d parameters "
        "updated by rows; optimizer-state bytes by card %s (total %d, "
        "replicated %d, bound total/%d + replicated = %d)"
        % (steps, not differ, len(sharded), len(fused.trainable), per_card,
           total, repl, n, total // n + repl))
    if differ:
        raise AssertionError("replicas differ in %s" % differ[:5])
    if len(per_card) != n or max(per_card) > total // n + repl:
        raise AssertionError("optimizer-state bytes by card %s exceed "
                             "total/%d + replicated" % (per_card, n))
    batch = mt.io.DataBatch([mt.nd.array(x[:b], ctx=mt.cpu())],
                            [mt.nd.array(y[:b], ctx=mt.cpu())])
    # the host's split of a step, mesh and replicated in turns (the host
    # is what bounds both, and it drifts within a call)
    rep_mod, _, _ = fit_resnet(mt, [mt.gpu(i) for i in range(n)], x[:b],
                               y[:b], b, 1, seed, "device")
    turns = {"mesh": [], "replicated": []}
    for i in range(4):
        pair = [("mesh", mod), ("replicated", rep_mod)]
        for name, m in (pair if i % 2 == 0 else pair[::-1]):
            turns[name].append(host_step_ms(m, batch, 2, n))
    del rep_mod
    split, rep_split = ({k: [v for t in turns[name] for v in t[k]]
                         for k in turns[name][0]}
                        for name in ("mesh", "replicated"))
    execs = mod._exec_group.execs
    tally = DeviceTally(nn_ops, "bn_apply_relu_add")

    def forward():
        mod.forward(batch, is_train=False)
        return mod.get_outputs()[0]._data

    try:
        gate = eval_forward_gate(epi, forward, lambda: sum(
            e.fused_sites for e in execs), "fit(mesh=%d) evaluation "
            "forward" % n, expect=RESNET_SITES * n)
    finally:
        tally.restore()
    per_dev = dict(tally.by_device)
    log("  epilogue launches of one evaluation forward by device: %s"
        % per_dev)
    if sorted(per_dev.values()) != [RESNET_SITES] * n:
        raise AssertionError("epilogue launches by device %s, want %d each"
                             % (per_dev, RESNET_SITES))
    del mod
    torch.cuda.empty_cache()
    inner = float(np.mean([v for i, v in enumerate(ms) if i % 2 and i > 1]))
    row = dict(cards=n, batch=b, steps=steps, ce=ce, step_ms=ms,
               step_ms_within_epoch=inner,
               images_per_s_per_chip=b / (inner / 1e3) / n,
               det_weights_dist=dw, det_stats_dist=da, det_bit_identical=same,
               nccl_error_over_bound=checked.worst,
               collectives=coll, host_split_ms=split,
               replicated_host_split_ms=rep_split,
               opt_state_bytes_by_card=per_card, opt_state_bytes_total=total,
               opt_state_bytes_replicated=repl, sharded_params=len(sharded),
               max_memory_allocated=[int(p) for p in peaks],
               eval_launches_by_device=per_dev, **gate)
    rep = replicated or {}
    med = {k: (float(np.median(v["device_ms"])) if v["device_ms"] else None,
               float(np.median(v["host_ms"])) if v["host_ms"] else None)
           for k, v in coll.items()}
    log("  [%s] ResNet-50 v2, fit(mesh=%d) from gpu(0), B=%d: step ms %s; "
        "inside an epoch %.2f ms, %.1f images/s per chip (the replicated "
        "path over %d cards in this run: %s ms, %s images/s per chip)"
        % (card, n, b, [round(v, 1) for v in ms], inner,
           row["images_per_s_per_chip"], n,
           "%.2f" % rep["step_ms_within_epoch"] if rep else "not run",
           "%.1f" % rep["images_per_s_per_chip"] if rep else "not run"))
    log("  a step on the host clock, each part until its call returns, "
        "mesh and replicated in turns (8 steps each): mesh %s; replicated "
        "%s; medians mesh / replicated: step %.1f / %.1f, update %.1f / "
        "%.1f" % (
            {k: [round(v, 1) for v in vs] for k, vs in split.items()},
            {k: [round(v, 1) for v in vs] for k, vs in rep_split.items()},
            np.median(split["step"]), np.median(rep_split["step"]),
            np.median(split["update"]), np.median(rep_split["update"])))
    log("  collectives a step, median (device ms, host ms): %s; the "
        "replicated all-reduce %s; peak memory by card %s GB (replicated "
        "%s GB)" % (
            {k: tuple(round(v, 3) if v is not None else None for v in p)
             for k, p in med.items()},
            (round(float(np.median(rep["sum_device_ms"])), 3),
             round(float(np.median(rep["sum_host_ms"])), 3)) if rep
            else "not run",
            [round(p / 1e9, 2) for p in peaks],
            [round(p / 1e9, 2) for p in rep.get("max_memory_allocated", [])]
            or "not run"))
    return row


def host_ms(fn, n_devices, iters=5, warmup=2):
    """Median host-clock ms of ``fn()`` from a sync of every card to a
    sync of every card."""
    out = []
    for i in range(warmup + iters):
        for d in range(n_devices):
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        fn()
        for d in range(n_devices):
            torch.cuda.synchronize(d)
        if i >= warmup:
            out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def multi_seq(mt, att, seed, card, n):
    """Ring and Ulysses attention over a ('seq',) mesh of n cards at the
    LM's widths (H=12, D=64, B=1, causal), T=4096 and 16384, f32 and
    bf16, forward and backward through autograd. Each is held to the
    exact function of its inputs: the plain attention and its plain
    backward (``flash_attention_reference`` /
    ``flash_attention_backward_reference``) in float64 on gpu(0), on the
    inputs as given (bf16 values widened). f32: output within 2e-5,
    gradients within 2e-4 of max(1, |exact|) (the one-card kernel reads
    1.48e-4 at T=16384 on an H100; its gate of 1e-4 was set at T <=
    2048). bf16: output and gradients within 2e-2 of the largest exact
    value. ``FlashAttentionFunction`` on gpu(0) over the whole sequence
    is held to the same limits, and the distance from it is printed.
    Flash launches by card: the ring r+1 forward and r+1 backward on
    rank r, Ulysses one of each. Prints the ms of each beside the
    one-card run."""
    mesh = mt.parallel.make_mesh((n,), ("seq",),
                                 devices=[mt.gpu(i) for i in range(n)])
    dev0 = mt.gpu(0).torch_device
    gen = torch.Generator(device=dev0).manual_seed(seed)
    h, d = LM["num_heads"], LM["d_model"] // LM["num_heads"]
    limits = {torch.float32: (2e-5, 2e-4), torch.bfloat16: (2e-2, 2e-2)}
    rows = []
    for t in (4096, 16384):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(1, t, h, d, device=dev0,
                                       generator=gen).to(dtype)
                           for _ in range(4))
            scale = att._scale(d, None)
            q64, k64, v64, do64 = (a.transpose(1, 2).double().contiguous()
                                   for a in (q, k, v, do))
            o64, lse64 = att.flash_attention_reference(
                q64, k64, v64, causal=True, sm_scale=scale, return_lse=True)
            exact_g = [g.transpose(1, 2) for g in
                       att.flash_attention_backward_reference(
                           q64, k64, v64, o64, do64, lse64, causal=True,
                           sm_scale=scale)]
            exact = o64.transpose(1, 2)
            del q64, k64, v64, do64, lse64

            def errors(out, grads):
                """(output, gradient) distance from the exact values:
                f32 absolute and gradients scaled by max(1, |exact|);
                bf16 scaled by the largest exact value."""
                if dtype == torch.float32:
                    return abs_err(out, exact), max(
                        rel_err(g, w) for g, w in zip(grads, exact_g))
                return (abs_err(out, exact) / float(exact.abs().max()),
                        max(abs_err(g, w) / float(w.abs().max())
                            for g, w in zip(grads, exact_g)))

            def one(grad=True):
                xs = [a.transpose(1, 2).contiguous().requires_grad_(grad)
                      for a in (q, k, v)]
                out = att.FlashAttentionFunction.apply(*xs, True, scale)
                if not grad:
                    return out.transpose(1, 2), None
                gs = torch.autograd.grad(out, xs,
                                         do.transpose(1, 2).contiguous())
                return out.detach().transpose(1, 2), \
                    [g.transpose(1, 2) for g in gs]
            ref, ref_g = one()
            one_errs = errors(ref, ref_g)
            one_fwd = host_ms(lambda: one(False), 1)
            one_all = host_ms(one, 1)
            lim = limits[dtype]
            if not (one_errs[0] <= lim[0] and one_errs[1] <= lim[1]):
                raise AssertionError(
                    "FlashAttentionFunction T=%d %s: %.3e / %.3e from the "
                    "exact values (limits %g / %g)" % (
                        t, dtype, one_errs[0], one_errs[1], *lim))
            for name, fn in (("ring", mt.parallel.ring_attention),
                             ("ulysses", mt.parallel.ulysses_attention)):
                def run(grad=True):
                    xs = [a.detach().requires_grad_(grad) for a in (q, k, v)]
                    out = fn(*xs, mesh=mesh, causal=True)
                    if not grad:
                        return out, None
                    return out, torch.autograd.grad(out, xs, do)
                fwd = DeviceTally(att, "_launch")
                bwd = DeviceTally(att, "_launch_bwd")
                att.flash_attention.launches = 0  # count this path alone
                att.flash_attention_backward.launches = 0
                try:
                    out, grads = run()
                    for i in range(n):
                        torch.cuda.synchronize(i)
                finally:
                    fwd.restore()
                    bwd.restore()
                counted = (att.flash_attention.launches,
                           att.flash_attention_backward.launches)
                launches = {"cuda:%d" % i: (fwd.by_device.get("cuda:%d" % i,
                                                              0),
                                            bwd.by_device.get("cuda:%d" % i,
                                                              0))
                            for i in range(n)}
                want = {"cuda:%d" % r: (r + 1, r + 1) if name == "ring"
                        else (1, 1) for r in range(n)}
                fwd_err, grad_err = errors(out, grads)
                vs_one = (abs_err(out, ref), max(
                    rel_err(g, w) for g, w in zip(grads, ref_g)))
                ok = fwd_err <= lim[0] and grad_err <= lim[1]
                row = dict(path=name, T=t, dtype=str(dtype).split(".")[-1],
                           fwd_err=fwd_err, grad_err=grad_err, limits=lim,
                           fwd_err_one_card=one_errs[0],
                           grad_err_one_card=one_errs[1],
                           fwd_err_vs_one_card=vs_one[0],
                           grad_err_vs_one_card=vs_one[1],
                           launches_by_device=launches, launches=counted,
                           fwd_ms=host_ms(lambda: run(False), n),
                           fwd_bwd_ms=host_ms(run, n),
                           one_card_fwd_ms=one_fwd,
                           one_card_fwd_bwd_ms=one_all)
                rows.append(row)
                log("  [%s] %s T=%d (%d a card) %s: from the exact values "
                    "fwd %.2e, grad %.2e (limits %g / %g; the one-card "
                    "kernel's %.2e / %.2e; from the one-card kernel %.2e / "
                    "%.2e); flash launches (fwd, bwd) by card %s; ms fwd "
                    "%.3f, fwd+bwd %.3f; one card over T: fwd %.3f, "
                    "fwd+bwd %.3f" % (
                        card, name, t, t // n, row["dtype"], fwd_err,
                        grad_err, lim[0], lim[1], one_errs[0], one_errs[1],
                        vs_one[0], vs_one[1], launches, row["fwd_ms"],
                        row["fwd_bwd_ms"], one_fwd, one_all))
                if counted != tuple(sum(v[i] for v in launches.values())
                                    for i in range(2)):
                    raise AssertionError("%s: the wrappers counted %s, the "
                                         "launchers ran %s" % (
                                             name, counted, launches))
                if not ok or launches != want:
                    raise AssertionError(
                        "%s T=%d %s: errors %.3e / %.3e (limits %g / %g), "
                        "launches %s (want %s)" % (
                            name, t, row["dtype"], fwd_err, grad_err,
                            lim[0], lim[1], launches, want))
            del q, k, v, do, ref, ref_g, exact, exact_g, o64
            torch.cuda.empty_cache()
    return rows


def multi_parallel(mt, seed, card, n):
    """The other mesh functions on n cards, each held to the same
    function on one card: ``moe_apply_topk`` (top-2, 8 experts over the
    cards, output and gradients against the dense top-2 on gpu(0)),
    ``pipeline_apply`` (4 stages, output and gradients against the
    serial chain on gpu(0)) and ``DataParallelTrainer(shard_update=True)``
    (3 SGD steps against the trainer on gpu(0) alone from the same
    weights): rtol 1e-4 / atol 1e-5 (the trainer 2e-4 / 2e-5, mxtpu's
    test tolerance)."""
    dev0 = mt.gpu(0).torch_device
    rng = np.random.RandomState(seed)
    gpus = [mt.gpu(i) for i in range(n)]
    out = {}

    def close(a, b, rtol, atol):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        return float(((a - b).abs() - rtol * b.abs()).max()) <= atol

    def t(a, grad=False):
        return torch.tensor(a, device=dev0, requires_grad=grad)
    # moe
    tokens, dm, ne, k = 64, 32, 8, 2
    W = t(rng.randn(ne, dm, dm).astype("f4") * 0.3, True)
    gate = t(rng.randn(tokens, ne).astype("f4"), True)
    x = t(rng.randn(tokens, dm).astype("f4"), True)
    probe = t(rng.randn(tokens, dm).astype("f4"))
    mesh = mt.parallel.make_mesh((n,), ("expert",), devices=gpus)
    got, aux = mt.parallel.moe_apply_topk(
        lambda p, tk: torch.tanh(torch.einsum("ecd,edf->ecf", tk, p["w"])),
        {"w": W}, gate, x, k=k, mesh=mesh, capacity_factor=8.0)
    g_got = torch.autograd.grad((got * probe).sum() + 0.01 * aux,
                                (W, gate, x))
    probs = gate.softmax(-1)
    topv, topi = probs.topk(k)
    wts = topv / topv.sum(-1, keepdim=True)
    dense = sum(wts[:, j:j + 1] * torch.tanh(torch.einsum(
        "td,tdf->tf", x, W[topi[:, j]])) for j in range(k))
    aux_d = mt.parallel.load_balancing_loss(
        gate, torch.nn.functional.one_hot(topi[:, 0], ne))
    g_want = torch.autograd.grad((dense * probe).sum() + 0.01 * aux_d,
                                 (W, gate, x))
    out["moe_topk"] = ok = close(got, dense, 1e-4, 1e-5) and all(
        close(a, b, 1e-4, 1e-5) for a, b in zip(g_got, g_want))
    # pipeline
    Ws = t(rng.randn(n, dm, dm).astype("f4") * 0.3, True)
    xp = t(rng.randn(32, dm).astype("f4"), True)
    pmesh = mt.parallel.make_mesh((n,), ("pipe",), devices=gpus)
    got = mt.parallel.pipeline_apply(lambda p, a: torch.tanh(a @ p["w"]),
                                     {"w": Ws}, xp, mesh=pmesh,
                                     num_microbatches=4)
    g_got = torch.autograd.grad((got * probe[:32]).sum(), (Ws, xp))
    h = xp
    for s in range(n):
        h = torch.tanh(h @ Ws[s])
    g_want = torch.autograd.grad((h * probe[:32]).sum(), (Ws, xp))
    out["pipeline"] = close(got, h, 1e-4, 1e-5) and all(
        close(a, b, 1e-4, 1e-5) for a, b in zip(g_got, g_want))
    # DataParallelTrainer(shard_update=True) vs one card
    s = mt.sym
    hh = s.FullyConnected(s.Variable("data"), num_hidden=512, name="fc1")
    hh = s.FullyConnected(s.Activation(hh, act_type="relu"), num_hidden=4,
                          name="fc2")
    net = s.SoftmaxOutput(hh, name="softmax")
    X = rng.randn(64, 16).astype("f4")
    Y = rng.randint(0, 4, 64).astype("f4")
    params = {"learning_rate": 0.1, "momentum": 0.9,
              "rescale_grad": 1.0 / 64}
    trs, w0 = [], None
    for devs in (gpus, [mt.gpu(0)]):
        tr = mt.parallel.DataParallelTrainer(
            net, mesh=mt.parallel.make_mesh((len(devs),), devices=devs),
            optimizer_params=params, shard_update=True)
        tr.init({"data": (64, 16), "softmax_label": (64,)})
        if w0 is None:
            w0 = {k: v.clone() for k, v in tr.params.items()}
        else:
            tr._module.set_params({k: mt.nd.NDArray(v, mt.gpu(0))
                                   for k, v in w0.items()}, {})
        for _ in range(3):
            tr.step({"data": X, "softmax_label": Y})
        trs.append(tr)
    sharded = trs[0].fused.sharded_names
    out["dp_trainer"] = sharded == ["fc1_weight"] and all(
        close(trs[0].params[k], trs[1].params[k], 2e-4, 2e-5)
        for k in trs[1].params) and not replicas_differ(trs[0]._module)
    # DataParallelTrainer(shard_params=True) on a (2, 2) ('data', 'model')
    # mesh against shard_params=False: fc1 (512 x 128, 2^16 elements) by
    # rows over 'model', gathered on use
    hh = s.FullyConnected(s.Variable("data"), num_hidden=512, name="fc1")
    hh = s.FullyConnected(s.Activation(hh, act_type="relu"), num_hidden=4,
                          name="fc2")
    net2 = s.SoftmaxOutput(hh, name="softmax")
    X2 = rng.randn(64, 128).astype("f4")
    shard_trs, w2 = [], None
    for shard in (True, False):
        tr = mt.parallel.DataParallelTrainer(
            net2, mesh=mt.parallel.make_mesh((2, 2), devices=gpus[:4]),
            optimizer_params=params, shard_params=shard)
        tr.init({"data": (64, 128), "softmax_label": (64,)})
        if w2 is None:
            w2 = {k: v.clone() for k, v in tr.params.items()}
        else:
            tr._module.set_params({k: mt.nd.NDArray(v, mt.gpu(0))
                                   for k, v in w2.items()}, {})
        for _ in range(3):
            tr.step({"data": X2, "softmax_label": Y})
        shard_trs.append(tr)
    lay = shard_trs[0].fused._plan.replica_layout()
    halves = [tuple(e.arg_dict["fc1_weight"].shape)
              for e in shard_trs[0]._module._exec_group.execs]
    dist = max(float((shard_trs[0].params[k].double().cpu()
                      - shard_trs[1].params[k].double().cpu()).abs().max())
               / max(1.0, float(shard_trs[1].params[k].abs().max()))
               for k in w2)
    out["dp_shard_params"] = sorted(lay.specs) == ["fc1_weight"] and \
        halves == [(256, 128)] * 4 and dist <= 1e-5
    log("  [%s] over %d cards vs one card: %s (DataParallelTrainer updated "
        "%s by rows; with shard_params on a (2, 2) mesh fc1_weight %s a "
        "card, %.3e of max(1, |w|) from shard_params=False after 3 steps)"
        % (card, n, out, sharded, halves, dist))
    del shard_trs
    if not all(out.values()):
        raise AssertionError("mesh functions on %d cards disagree with one "
                             "card: %s" % (n, out))
    del trs
    torch.cuda.empty_cache()
    return out


# --multi-gpu mesh_tp: ResNet-50's convolution shapes (B, C, H=W, O, k,
# stride, pad) for Convolution's tp form against float64 on the cards
CONV_TP_CASES = ((64, 64, 56, 64, 3, 1, 1), (64, 256, 56, 128, 1, 2, 0),
                 (64, 512, 28, 128, 1, 1, 0), (64, 256, 14, 256, 3, 1, 1))


def conv_tp_on_cards(mt, seed, devices, tol=1e-4):
    """Convolution's tp form (``ops/nn.py`` ``_conv_tp``) over a
    ``data:2,tp:2`` layout of ``devices`` at ResNet-50's shapes: each
    replica its rows of the batch and its half of the weight's input
    channels; the outputs, dx (all-gathered over tp) and the weight's
    gradient blocks (summed over data) within ``tol`` of max(1, |exact|)
    of the float64 convolution of the whole batch on the first device."""
    from mxtpu_torch.ops import nn as nn_ops
    from mxtpu_torch.ops.registry import get_op
    from mxtpu_torch.parallel.mesh import Mesh, ReplicaLayout
    lay = ReplicaLayout(Mesh(devices, ("data", "tp"), (2, 2)),
                        {"w": (None, "tp")})
    op = get_op("Convolution")
    rng = np.random.RandomState(seed)
    dev0 = devices[0].torch_device
    worst = {}
    for b, c, hw, o, k, stride, pad in CONV_TP_CASES:
        a = op.parse_attrs({"kernel": (k, k), "stride": (stride, stride),
                            "pad": (pad, pad), "num_filter": o,
                            "no_bias": True})
        x = torch.tensor(rng.randn(b, c, hw, hw).astype("f4"))
        w = torch.tensor(rng.randn(o, c, k, k).astype("f4")
                         * np.float32(1.0 / np.sqrt(c * k * k)))
        x64 = x.double().to(dev0).requires_grad_()
        w64 = w.double().to(dev0).requires_grad_()
        y64 = torch.nn.functional.conv2d(x64, w64, stride=stride,
                                         padding=pad)
        head = torch.randn(y64.shape, dtype=torch.float64, device=dev0,
                           generator=torch.Generator(dev0).manual_seed(
                               seed))
        dx64, dw64 = torch.autograd.grad(y64, (x64, w64), head)
        y64 = y64.detach()
        half = b // 2
        xs, ws, heads, rows = [], [], [], []
        for r, ctx in enumerate(devices):
            d = lay.coords[r]["data"]
            rows.append(slice(d * half, (d + 1) * half))
            dev = ctx.torch_device
            xs.append(x[rows[-1]].to(dev).requires_grad_())
            ws.append(lay.piece("w", w, r).contiguous().to(dev)
                      .requires_grad_())
            heads.append(head[rows[-1]].float().to(dev))
        ys = [t[0] for t in nn_ops._conv_tp(a, list(zip(xs, ws)), {1: "w"},
                                            lay)]
        grads = torch.autograd.grad(ys, xs + ws, heads)
        dxs, dws = grads[:len(xs)], grads[len(xs):]

        def err(got, want):
            return float((got.detach().double().to(dev0) - want).abs()
                         .max()) / max(1.0, float(want.abs().max()))
        e = {"y": max(err(y, y64[s]) for y, s in zip(ys, rows)),
             "dx": max(err(g, dx64[s]) for g, s in zip(dxs, rows))}
        blocks = []
        for g in lay.groups(("data",)):
            total = sum(dws[r].double().to(dev0) for r in g)
            t = lay.coords[g[0]]["tp"]
            blocks.append(err(total, dw64[:, t * c // 2:(t + 1) * c // 2]))
        e["dw"] = max(blocks)
        worst["%dx%dx%d->%d k%d s%d" % (b, c, hw, o, k, stride)] = e
    log("  Convolution's tp form over data:2,tp:2 of %s against float64, "
        "error over max(1, |exact|) (gate %g): %s" % (
            [str(d) for d in devices], tol,
            {k: {n: "%.2e" % v for n, v in e.items()}
             for k, e in worst.items()}))
    if max(v for e in worst.values() for v in e.values()) > tol:
        raise AssertionError("Convolution's tp form against float64: %s"
                             % worst)
    return worst


# --multi-gpu mesh_tp: the LM's FullyConnected shapes (leading dims a
# replica, in, out, flatten) and its Embedding (vocab, dim, T) for the tp
# forms against float64 on the cards
TP_FC_CASES = (((4, 1024), 768, 3072, False), ((4, 1024), 3072, 768, False),
               ((4096,), 768, 50257, True))
TP_EMB_CASE = (50257, 768, 1024)


def fc_embedding_tp_on_cards(mt, seed, devices, tol=1e-4):
    """FullyConnected's and Embedding's tp forms (``ops/nn.py``
    ``_fc_tp``, ``_embedding_tp``) over a ``data:2,tp:2`` layout of
    ``devices`` at the LM's shapes: outputs, dx (all-gathered over tp) and
    the weight blocks' gradients (summed over data) within ``tol`` of
    max(1, |exact|) of float64 on the first device (``TP_FC_CASES``,
    ``TP_EMB_CASE``)."""
    from mxtpu_torch.ops import nn as nn_ops
    from mxtpu_torch.ops.registry import get_op
    from mxtpu_torch.parallel.mesh import Mesh, ReplicaLayout
    lay = ReplicaLayout(Mesh(devices, ("data", "tp"), (2, 2)),
                        {"w": (None, "tp")})
    rng = np.random.RandomState(seed)
    dev0 = devices[0].torch_device
    gen = torch.Generator(dev0).manual_seed(seed)

    def err(got, want):
        return float((got.detach().double().to(dev0) - want).abs()
                     .max()) / max(1.0, float(want.abs().max()))

    def per_replica(full, r, rows):
        d = lay.coords[r]["data"]
        return full[d * rows:(d + 1) * rows]

    def block_err(grads, exact, width):
        """The weight's gradient blocks summed over each data group
        against the exact gradient's columns of that tp index."""
        out = []
        for g in lay.groups(("data",)):
            t = lay.coords[g[0]]["tp"]
            total = sum(grads[r].double().to(dev0) for r in g)
            out.append(err(total, exact[:, t * width:(t + 1) * width]))
        return max(out)

    worst = {}
    fc = get_op("FullyConnected")
    for lead, d_in, d_out, flatten in TP_FC_CASES:
        a = fc.parse_attrs({"num_hidden": d_out, "flatten": flatten})
        rows = lead[0]
        x = torch.tensor(rng.randn(2 * rows, *lead[1:], d_in).astype("f4"))
        w = torch.tensor((rng.randn(d_out, d_in) / np.sqrt(d_in))
                         .astype("f4"))
        b = torch.tensor(rng.randn(d_out).astype("f4"))
        x64, w64, b64 = (t.double().to(dev0).requires_grad_()
                         for t in (x, w, b))
        y64 = torch.nn.functional.linear(x64, w64, b64)
        head = torch.randn(y64.shape, dtype=torch.float64, device=dev0,
                           generator=gen)
        dx64, dw64, db64 = torch.autograd.grad(y64, (x64, w64, b64), head)
        y64 = y64.detach()
        ins, heads = [], []
        for r, ctx in enumerate(devices):
            dev = ctx.torch_device
            ins.append((per_replica(x, r, rows).to(dev).requires_grad_(),
                        lay.piece("w", w, r).contiguous().to(dev)
                        .requires_grad_(), b.to(dev).requires_grad_()))
            heads.append(per_replica(head, r, rows).float().to(dev))
        ys = [t[0] for t in nn_ops._fc_tp(a, ins, {1: "w"}, lay)]
        grads = torch.autograd.grad(ys, [i[0] for i in ins]
                                    + [i[1] for i in ins], heads)
        n = len(devices)
        worst["fc %dx%d->%d" % (int(np.prod(lead)), d_in, d_out)] = {
            "y": max(err(y, per_replica(y64, r, rows))
                     for r, y in enumerate(ys)),
            "dx": max(err(g, per_replica(dx64, r, rows))
                      for r, g in enumerate(grads[:n])),
            "dw": block_err(grads[n:], dw64, d_in // 2)}
    vocab, dim, t = TP_EMB_CASE
    a = get_op("Embedding").parse_attrs({"input_dim": vocab,
                                         "output_dim": dim})
    ids = torch.tensor(rng.randint(0, vocab, (8, t)).astype("f4"))
    w = torch.tensor((rng.randn(vocab, dim) * 0.02).astype("f4"))
    w64 = w.double().to(dev0).requires_grad_()
    y64 = torch.nn.functional.embedding(ids.long().to(dev0), w64)
    head = torch.randn(y64.shape, dtype=torch.float64, device=dev0,
                       generator=gen)
    dw64, = torch.autograd.grad(y64, (w64,), head)
    y64 = y64.detach()
    ins, heads = [], []
    for r, ctx in enumerate(devices):
        dev = ctx.torch_device
        ins.append((per_replica(ids, r, 4).to(dev),
                    lay.piece("w", w, r).contiguous().to(dev)
                    .requires_grad_()))
        heads.append(per_replica(head, r, 4).float().to(dev))
    ys = [t[0] for t in nn_ops._embedding_tp(a, ins, {1: "w"}, lay)]
    grads = torch.autograd.grad(ys, [i[1] for i in ins], heads)
    worst["embedding %dx%d" % (vocab, dim)] = {
        "y": max(err(y, per_replica(y64, r, 4)) for r, y in enumerate(ys)),
        "dw": block_err(grads, dw64, dim // 2)}
    log("  FullyConnected's and Embedding's tp forms over data:2,tp:2 of "
        "%s against float64, error over max(1, |exact|) (gate %g): %s" % (
            [str(d) for d in devices], tol,
            {k: {n: "%.2e" % v for n, v in e.items()}
             for k, e in worst.items()}))
    if max(v for e in worst.values() for v in e.values()) > tol:
        raise AssertionError("the tp forms against float64: %s" % worst)
    return worst


def lm_mesh_fit(mt, contexts, sym, w0, x, y, mesh, n, steps=None):
    """The LM through ``Module(context=contexts).fit`` from the weights
    ``w0`` (numpy), SGD with momentum, ``steps`` (``MESH_TP["steps"]``)
    steps of one repeated batch; ``mesh``: a mesh spec, or False for the
    fused path over ``contexts``: (module, step ms, cross-entropy)."""
    mod = mt.mod.Module(sym, context=contexts)
    clock, ce = StepClock(n), []

    def record(param):
        clock(param)
        ce.append(param.eval_metric.get()[1])
        param.eval_metric.reset()

    args = {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in w0.items()}
    for i in range(n):
        torch.cuda.synchronize(i)
    start = time.perf_counter()
    mod.fit(RepeatBatch(mt, x, y, steps or MESH_TP["steps"]), num_epoch=1,
            eval_metric="ce", optimizer="sgd", kvstore="device",
            optimizer_params={"learning_rate": MESH_TP["lr"],
                              "momentum": MESH_TP["momentum"]},
            arg_params=args, initializer=None, batch_end_callback=record,
            metric_sync=1, mesh=mesh)
    return mod, clock.ms(start), ce


def lm_exact_gate(mt, sym, w0, seed, n):
    """One SGD step of the LM at full width and depth, B = 4, on gpu(0)
    and through ``fit(mesh=spec)`` for each of ``MESH_TP["meshes"]``,
    from ``w0``, against the exact step (the float64 gradient on the CPU,
    through the plain versions, as phase 6's ``train_step_vs_cpu``). f32
    is far from exact on this model (a LayerNorm over small embeddings
    multiplies the gradient, the sums over the tokens and classes
    cancel), so the gate is relative: each mesh's largest distance from
    the exact step within ``MESH_TP["exact_factor"]`` times the one-card
    step's own."""
    cfg = dict(LM)
    x, y = lm_batch(seed + 3, 4, cfg["seq_len"], cfg["vocab_size"])
    got = {}
    for name, mesh in (("one_card", False),) + tuple(
            (s_, s_) for s_ in MESH_TP["meshes"]):
        mod, _, _ = lm_mesh_fit(mt, [mt.gpu(0)], sym, w0, x, y, mesh, n,
                                steps=1)
        got[name] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        del mod
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g64 = _grads_f64(mt, sym, {k: mt.nd.array(v, ctx=mt.cpu())
                               for k, v in w0.items()}, x, y)
    exact = {k: w0[k].astype(np.float64) - MESH_TP["lr"] * g / len(x)
             for k, g in g64.items()}  # SGD's first step, rescale 1/B
    dist = {name: max(float(np.abs(w[k] - exact[k]).max()) for k in exact)
            for name, w in got.items()}
    ratio = {k: v / max(dist["one_card"], 1e-30) for k, v in dist.items()}
    log("  the LM's first SGD step (B=4, lr %g) against the exact "
        "(float64, %.1f s on the host) step: largest distance %s; ratio "
        "to the one-card step's %s (gate %g)" % (
            MESH_TP["lr"], time.perf_counter() - t0,
            {k: "%.3e" % v for k, v in dist.items()},
            {k: round(v, 3) for k, v in ratio.items()},
            MESH_TP["exact_factor"]))
    bad = {k: v for k, v in ratio.items() if v > MESH_TP["exact_factor"]}
    if bad:
        raise AssertionError("the LM's step on %s is farther from the "
                             "exact step than %g x the one-card step's: "
                             "%s" % (sorted(bad), MESH_TP["exact_factor"],
                                     dist))
    return dict(exact_dist=dist, ratio=ratio)


def held_to_replicated(label, runs, specs):
    """``runs``: {name: (weights after the first step, after the last)}
    for "replicated", "one_card" and each of ``specs``. Each spec's
    distance from the replicated fused path (max |w - w_rep| / max(1,
    |w_rep|)) after the first step and after the last must be within
    max(1e-4, 4x) the one-card path's own distance from it: the same
    function with its sums in another order, which the training's
    conditioning can grow far past 1e-4 in a few steps."""
    want = runs["replicated"]
    spread = [scaled_dist(a, b) for a, b in zip(runs["one_card"], want)]
    gate = [max(1e-4, 4 * v) for v in spread]
    dists = {s_: [scaled_dist(a, b) for a, b in zip(runs[s_], want)]
             for s_ in specs}
    log("  %s (from the same start, cuDNN deterministic, the fused "
        "step's collectives in replica order): distance from the "
        "replicated path after the first / the last step %s; the one-card "
        "path's %s; gates %s" % (
            label, {k: ["%.3e" % v for v in d] for k, d in dists.items()},
            ["%.3e" % v for v in spread], ["%.3e" % v for v in gate]))
    for k, d in dists.items():
        if any(v > g for v, g in zip(d, gate)):
            raise AssertionError("%s on %s is %s from the replicated path "
                                 "(gates %s)" % (label, k, d, gate))
    return dict(dists=dists, one_card=spread, gates=gate)


def mesh_bytes(mod, slack):
    """Each card's parameter and optimizer-state bytes beside their
    bounds: the replicated parameters' bytes plus each split one's over
    its split factor (its state's also over the data axis where it is
    updated by rows), plus ``slack``."""
    fused = mod._fused
    plan = fused._plan
    lay = plan.replica_layout() if plan is not None else None
    rows = set(fused.sharded_names)
    n_data = lay.sizes.get("data", 1) if lay is not None else 1
    bound_p = bound_s = 0
    for k, shape in mod._exec_group.param_shapes.items():
        full = int(np.prod(shape)) * 4
        split = int(np.prod([lay.sizes[a] for a in lay.split_axes(k)])) \
            if lay is not None else 1
        bound_p += full // split
        if k in fused.trainable:
            bound_s += full // split // (n_data if k in rows else 1)
    params = [sum(e.arg_dict[k]._data.numel() * e.arg_dict[k]._data
                  .element_size() for k in mod._param_names)
              for e in mod._exec_group.execs]
    return dict(param_bytes=params, state_bytes=fused.opt_state_bytes(),
                param_bound=bound_p + slack, state_bound=bound_s + slack)


def mesh_tp(mt, att, epi, seed, card, n):
    """The tp and fsdp meshes at full width (see the module docstring):
    the LM on each of ``MESH_TP["meshes"]`` against the replicated fused
    path, then ResNet-50 v2 under ``MESH_TP["resnet_mesh"]``."""
    from mxtpu_torch.module import fused as fused_mod
    from mxtpu_torch.ops import collective as coll
    from mxtpu_torch.ops import nn as nn_ops
    cfg = dict(LM)
    b, steps = MESH_TP["batch"], MESH_TP["steps"]
    gpus = [mt.gpu(i) for i in range(n)]
    sym = mt.models.get_transformer_lm(**cfg)
    w0 = {k[4:]: v for k, v in lm_params(sym, seed).items()}
    x, y = lm_batch(seed, b, cfg["seq_len"], cfg["vocab_size"])
    # the FullyConnected weights: 6 a layer and lm_head
    n_fc = sum(1 for k in w0 if k.endswith("_weight")
               and k != "tok_emb_weight")
    out = {"gate": {}, "runs": {}}
    # the gates: the tp forms of the LM's ops against float64 at its
    # shapes, then the first step against the exact (float64) step
    out["tp_forms"] = fc_embedding_tp_on_cards(mt, seed, gpus)
    out["gate"] = lm_exact_gate(mt, sym, w0, seed, n)
    # the runs: NCCL, each collective's first call held to the host
    names = ("all_reduce_groups", "all_gather_groups",
             "reduce_scatter_groups")
    fused_names = ("sum_replicas", "reduce_scatter_replicas",
                   "all_gather_replicas")
    finals = {}
    for spec in MESH_TP["meshes"] + (False,):
        label = spec or "replicated"
        clocks = [CollectiveClock(coll, k) for k in names] + \
            [CollectiveClock(fused_mod, k) for k in fused_names]
        checks = [CheckedCollectives(fused_mod)]
        if spec:
            checks.append(CheckedCollectives(coll))
        fwd = DeviceTally(att, "_launch")
        bwd = DeviceTally(att, "_launch_bwd")
        coll.calls.clear()
        att.flash_attention.launches = 0  # count the main path alone
        att.flash_attention_backward.launches = 0
        for i in range(n):
            torch.cuda.reset_peak_memory_stats(i)
        try:
            mod, ms, ce = lm_mesh_fit(mt, [mt.gpu(0)] if spec else gpus,
                                      sym, w0, x, y, spec, n)
            launches = (att.flash_attention.launches,
                        att.flash_attention_backward.launches)
            coll_ms = {c.name: sum(c.device_ms()) / steps for c in clocks}
            coll_calls = {c.name: len(c.host_ms) // steps for c in clocks}
        finally:
            for c in checks:
                c.restore()
            for c in clocks:
                c.restore()
            fwd.restore()
            bwd.restore()
        peaks = [torch.cuda.max_memory_allocated(i) for i in range(n)]
        by_dev = {d: (fwd.by_device.get(d, 0) // steps,
                      bwd.by_device.get(d, 0) // steps)
                  for d in sorted(set(fwd.by_device) | set(bwd.by_device))}
        worst = {}
        for c in checks:
            worst.update({"%s.%s" % (c.fused.__name__.split(".")[-1], k): v
                          for k, v in c.worst.items()})
        calls = {"%s/%s" % k: v // steps for k, v in coll.calls.items()}
        mem = mesh_bytes(mod, MESH_TP["slack_bytes"])
        finals[label] = mod.get_params()[0]
        mean = float(np.mean(ms[1:]))
        tokens = b * cfg["seq_len"]
        row = dict(mesh=label, step_ms=ms, step_ms_mean=mean, ce=ce,
                   tokens_per_s_per_chip=tokens / (mean / 1e3) / n,
                   collectives_device_ms_per_step=coll_ms,
                   collective_calls_per_step=dict(coll_calls, **calls),
                   nccl_error_over_bound=worst,
                   launches_per_step_by_device=by_dev, launches=launches,
                   max_memory_allocated=[int(p) for p in peaks], **mem)
        if spec:
            lay = mod._fused._plan.replica_layout()
            row["split_params"] = len(lay.specs)
            row["split_elems"] = int(sum(np.prod(
                mod._exec_group.param_shapes[k]) for k in lay.specs))
        out["runs"][label] = row
        log("  [%s] LM, %s, B=%d, SGD: cross-entropy %s; step ms %s (mean "
            "after the first %.2f), %.0f tokens/s per chip; group "
            "collectives a step %s, their device ms a step %s; first calls "
            "on NCCL over the host's bound %s; flash launches a step by "
            "device (fwd, bwd) %s; bytes by card: parameters %s (bound "
            "%d), optimizer state %s (bound %d); peak memory %s GB" % (
                card, label, b, [round(v, 4) for v in ce],
                [round(v, 1) for v in ms], mean,
                row["tokens_per_s_per_chip"], calls,
                {k: round(v, 3) for k, v in coll_ms.items()},
                {k: round(v, 3) for k, v in worst.items()}, by_dev,
                mem["param_bytes"], mem["param_bound"], mem["state_bytes"],
                mem["state_bound"], [round(p / 1e9, 2) for p in peaks]))
        want_l = cfg["num_layers"]
        if len(ce) != steps or not np.all(np.isfinite(ce)) or \
                not ce[-1] < ce[0]:
            raise AssertionError("LM on %s: cross-entropy %s" % (label, ce))
        if len(by_dev) != n or any(v != (want_l, want_l)
                                   for v in by_dev.values()) or \
                launches != (want_l * steps * n,) * 2:
            raise AssertionError("LM on %s: flash launches a step by "
                                 "device %s, counts %s" % (
                                     label, by_dev, launches))
        if worst and max(worst.values()) > 1.0:
            raise AssertionError("LM on %s: collectives on NCCL over the "
                                 "host's bound %s" % (label, worst))
        if max(mem["param_bytes"]) > mem["param_bound"] or \
                max(mem["state_bytes"]) > mem["state_bound"]:
            raise AssertionError("LM on %s: bytes by card over the bound "
                                 "%s" % (label, mem))
        if spec == "data:2,tp:2" and (
                calls.get("all_reduce/tp") != n_fc
                or "collective.sum_replicas" not in worst):
            raise AssertionError("LM on %s: %s tp all-reduces a step, "
                                 "want one a FullyConnected (%d); checked "
                                 "%s" % (label, calls.get("all_reduce/tp"),
                                         n_fc, sorted(worst)))
        if spec == "data:2,fsdp:2" and (
                calls.get("all_gather/fsdp") != n_fc - 1
                or calls.get("reduce_scatter/fsdp") != n_fc - 1):
            raise AssertionError("LM on %s: fsdp collectives a step %s, "
                                 "want %d each (lm_head's 50,257 rows do "
                                 "not split)" % (label, calls, n_fc - 1))
        del mod
        torch.cuda.empty_cache()
    rep_row = out["runs"]["replicated"]
    for spec in MESH_TP["meshes"]:
        out["runs"][spec]["dist_from_replicated"] = scaled_dist(
            finals[spec], finals["replicated"])
    log("  tokens/s per chip: %s; after %d steps on NCCL each mesh's "
        "weights are %s from the replicated path's (max |w - w_rep| / "
        "max(1, |w_rep|); not gated: the sums' order, grown by the "
        "training)" % (
            {k: round(v["tokens_per_s_per_chip"])
             for k, v in out["runs"].items()}, steps,
            {k: "%.3e" % out["runs"][k]["dist_from_replicated"]
             for k in MESH_TP["meshes"]}))
    del finals
    # ResNet-50 v2 under the tp mesh: Convolution's tp form, first each
    # of its shapes against float64, then the net
    out["conv_tp"] = conv_tp_on_cards(mt, seed, gpus)
    spec = MESH_TP["resnet_mesh"]
    rb = MULTI["batch"]
    xr, yr = resnet_train_data(seed)
    runs, stats = {}, {}
    with DeterministicCudnn(), OrderedCollectives(fused_mod):
        for name, ctxs, mesh in (("replicated", gpus, False),
                                 ("one_card", [mt.gpu(0)], False),
                                 (spec, [mt.gpu(0)], spec)):
            snaps = []
            mod, ms, ce = fit_resnet(
                mt, ctxs, xr[:2 * rb], yr[:2 * rb], rb,
                DP_STEPS * rb // (2 * rb), seed,
                "device" if mesh is False and len(ctxs) > 1 else "local",
                mesh=mesh, cards=n, snaps=snaps)
            got = mod.get_params()
            runs[name] = (snaps[0][0], got[0])
            stats[name] = (snaps[0][1], got[1])
            if mesh is False:
                del mod
                torch.cuda.empty_cache()
    lay = mod._fused._plan.replica_layout()
    convs = sum(1 for k, e in lay.specs.items() if "conv" in k
                and e[1:2] == (("tp",),))
    label = "ResNet-50 v2 under %s (B=%d, %d convolutions in the tp " \
        "form), %d SGD steps" % (spec, rb, convs, DP_STEPS)
    gate_w = held_to_replicated(label + ", weights", runs, (spec,))
    gate_a = held_to_replicated(label + ", moving statistics", stats,
                                (spec,))
    log("  step ms %s" % [round(v, 1) for v in ms])
    if convs == 0 or not np.all(np.isfinite(ce)):
        raise AssertionError("ResNet-50 under %s: %d tp convolutions, "
                             "cross-entropy %s" % (spec, convs, ce))
    dw, da = gate_w["dists"][spec][-1], gate_a["dists"][spec][-1]
    batch = mt.io.DataBatch([mt.nd.array(xr[:rb], ctx=mt.cpu())],
                            [mt.nd.array(yr[:rb], ctx=mt.cpu())])
    execs = mod._exec_group.execs
    tally = DeviceTally(nn_ops, "bn_apply_relu_add")

    def forward():
        mod.forward(batch, is_train=False)
        return mod.get_outputs()[0]._data

    try:
        gate = eval_forward_gate(epi, forward, lambda: sum(
            e.fused_sites for e in execs), "ResNet-50 under %s evaluation "
            "forward" % spec, expect=RESNET_SITES * n)
    finally:
        tally.restore()
    per_dev = dict(tally.by_device)
    log("  epilogue launches of one evaluation forward by device: %s"
        % per_dev)
    if sorted(per_dev.values()) != [RESNET_SITES] * n:
        raise AssertionError("epilogue launches by device %s, want %d each"
                             % (per_dev, RESNET_SITES))
    out["resnet"] = dict(mesh=spec, weights_dist=dw, stats_dist=da,
                         weights_gate=gate_w, stats_gate=gate_a,
                         tp_convolutions=convs, step_ms=ms, ce=ce,
                         eval_launches_by_device=per_dev, **gate)
    out["replicated_tokens_per_s_per_chip"] = \
        rep_row["tokens_per_s_per_chip"]
    del mod
    torch.cuda.empty_cache()
    return out


def multi_gpu(args, card):
    """``--multi-gpu``: the data-parallel paths over 4 cards (see the
    module docstring). Raises below 4 devices."""
    import mxtpu_torch as mt
    from mxtpu_torch.ops import attention as att
    from mxtpu_torch.ops import epilogue as epi
    n = torch.cuda.device_count()
    if n < MULTI["gpus"]:
        raise SystemExit("chip_smoke --multi-gpu: %d CUDA device(s), needs "
                         "%d" % (n, MULTI["gpus"]))
    n = MULTI["gpus"]
    names = [torch.cuda.get_device_name(i) for i in range(n)]
    log("[multi_gpu] %d cards: %s" % (n, names))
    t0 = time.perf_counter()
    built = mt.build.build()  # once, before any worker process starts
    log("[build] %s in %.1f s wall" % ({k: round(v, 1) for k, v in
                                        built.items()},
                                       time.perf_counter() - t0))
    res = {"card": card, "cards": n, "names": names}
    phases = [p for p in args.multi_phases.split(",") if p]
    unknown = sorted(set(phases) - set(MULTI_PHASES))
    if unknown:
        raise SystemExit("chip_smoke: unknown multi phases %s" % unknown)
    if "kvstore" in phases:
        log("[multi_gpu kvstore]")
        res["kvstore"] = kvstore_cases(mt, [mt.gpu(i) for i in range(n)])
        res["kvstore"]["resnet_push_pull"] = kvstore_resnet_ms(mt, n, card)
    if "kernels" in phases:
        log("[multi_gpu kernels]")
        res["kernels_by_device"] = {i: kernels_on_device(att, epi, i)
                                    for i in range(1, n)}
    if "resnet" in phases:
        log("[multi_gpu resnet]")
        res["resnet"] = multi_resnet(mt, epi, args.seed, card, n)
    if "mesh" in phases:
        log("[multi_gpu mesh]")
        res["mesh"] = multi_mesh(mt, epi, args.seed, card, n,
                                 res.get("resnet"))
    if "lm" in phases:
        log("[multi_gpu lm]")
        res["lm"] = multi_lm(mt, att, args.seed, card, n)
    if "dist_sync" in phases:
        log("[multi_gpu dist_sync]")
        res["dist_sync"] = multi_dist(args.seed, card, n)
    if "gluon" in phases:
        log("[multi_gpu gluon]")
        res["gluon"] = multi_gluon(mt, args.seed, card, n)
    if "seq" in phases:
        log("[multi_gpu seq]")
        res["seq"] = multi_seq(mt, att, args.seed, card, n)
    if "parallel" in phases:
        log("[multi_gpu parallel]")
        res["parallel"] = multi_parallel(mt, args.seed, card, n)
    if "group2ctx" in phases:
        log("[multi_gpu group2ctx]")
        res["group2ctx"] = multi_group2ctx(mt, args.seed, card)
    if "mesh_tp" in phases:
        log("[multi_gpu mesh_tp]")
        res["mesh_tp"] = mesh_tp(mt, att, epi, args.seed, card, n)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1, default=str)
    if phases != list(MULTI_PHASES):
        log("chip_smoke: multi phases %s only; no summary line, no device "
            "line" % phases)
        return 1
    r = res["resnet"]
    log(json.dumps({"multi_gpu": {
        "cards": n, "resnet_images_per_s": r["images_per_s"],
        "resnet_images_per_s_per_chip": r["images_per_s_per_chip"],
        "weak_efficiency": r["weak"]["efficiency"],
        "strong_speedup": r["strong"]["speedup"],
        "grad_sum_device_ms": float(np.median(r["sum_device_ms"])),
        "lm_tokens_per_s": res["lm"]["tokens_per_s"],
        "dist_sync_step_ms": res["dist_sync"]["step_ms_mean"],
        "gluon_step_ms": res["gluon"]["step_ms_mean"],
        "mesh_step_ms": res["mesh"]["step_ms_within_epoch"],
        "mesh_images_per_s_per_chip": res["mesh"]["images_per_s_per_chip"],
        "ring_fwd_bwd_ms": {"%s/%d/%s" % (r["path"], r["T"], r["dtype"]):
                            r["fwd_bwd_ms"] for r in res["seq"]},
        "group2ctx_step_ms": float(np.median(
            res["group2ctx"]["split_step_ms"])),
        "mesh_tp_tokens_per_s_per_chip": {
            k: v["tokens_per_s_per_chip"]
            for k, v in res["mesh_tp"]["runs"].items()},
        "mesh_tp_resnet_step_ms": res["mesh_tp"]["resnet"]["step_ms"]}}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kvstore_resnet_ms(mt, n, card):
    """KVStore "device" over n cards with ResNet-50's parameter set (161
    arrays, one per card each): host and synced ms of one push of every
    gradient list and one pull of every weight list."""
    sym = mt.models.get_resnet(**RESNET)
    shapes, _, _ = sym.infer_shape(data=(1,) + RESNET["image_shape"])
    params = [(k, s) for k, s in zip(sym.list_arguments(), shapes)
              if k not in ("data", "softmax_label")]
    kv = mt.kv.create("device")
    grads, weights = {}, {}
    for k, s in params:
        kv.init(k, mt.nd.zeros(s, ctx=mt.gpu(0)))
        grads[k] = [mt.nd.ones(s, ctx=mt.gpu(i)) for i in range(n)]
        weights[k] = [mt.nd.zeros(s, ctx=mt.gpu(i)) for i in range(n)]
    host, synced = [], []
    for _ in range(MULTI["kv_iters"]):
        for i in range(n):
            torch.cuda.synchronize(i)
        t0 = time.perf_counter()
        for k, _ in params:
            kv.push(k, grads[k])
            kv.pull(k, out=weights[k])
        t1 = time.perf_counter()
        for i in range(n):
            torch.cuda.synchronize(i)
        host.append((t1 - t0) * 1e3)
        synced.append((time.perf_counter() - t0) * 1e3)
    ok = all(float(w._data.min()) == n == float(w._data.max())
             for ws in weights.values() for w in ws)
    numel = sum(int(np.prod(s)) for _, s in params)
    log("  [%s] push+pull of ResNet-50's %d parameters (%.1f M f32) over %d "
        "cards: host ms %s, synced ms %s; every pulled value == %d: %s"
        % (card, len(params), numel / 1e6, n, [round(v, 1) for v in host],
           [round(v, 1) for v in synced], n, ok))
    if not ok:
        raise AssertionError("kvstore push/pull of ResNet-50's parameters "
                             "gave a wrong sum")
    return dict(params=len(params), elements=numel, host_ms=host,
                synced_ms=synced)


def batch_breakdown(mt, sym_json, params, x, profile, label):
    """Where one largest-bucket batch's time goes on a gpu Predictor:
    input copy, forward (to a device sync) and the answer's device->host
    copy, by host clock; with ``profile`` also device time by kernel."""
    pred = mt.Predictor(sym_json, params, ctx=mt.gpu(0),
                        input_shapes={"data": x.shape})
    pred.forward(data=x)
    pred.get_outputs()
    reps = 3
    t_in = t_fwd = t_out = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.set_input("data", x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred._executor.forward(is_train=False)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pred.get_outputs()
        t3 = time.perf_counter()
        t_in += t1 - t0
        t_fwd += t2 - t1
        t_out += t3 - t2
    row = {"input_ms": t_in / reps * 1e3, "forward_ms": t_fwd / reps * 1e3,
           "to_host_ms": t_out / reps * 1e3}
    log("  %s bucket-%d batch on a gpu Predictor (mean of %d): input copy "
        "%.2f ms, forward %.2f ms, device->host %.2f ms"
        % (label, x.shape[0], reps, row["input_ms"], row["forward_ms"],
           row["to_host_ms"]))
    if profile:
        from torch.profiler import ProfilerActivity, profile as _prof
        with _prof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            pred._executor.forward(is_train=False)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_time_total", 0) > 0
                  and e.device_type.name == "CUDA"]
        total = sum(e.device_time_total for e in events)
        row["device_ms"] = total / 1e3
        row["by_kernel_ms"] = {e.key: e.device_time_total / 1e3
                               for e in events}
        log("  profiled forward: %.2f ms of device time in %d kernels"
            % (total / 1e3, len(events)))
        for e in sorted(events, key=lambda e: -e.device_time_total)[:10]:
            log("    %8.3f ms %5.1f%%  x%-4d %s"
                % (e.device_time_total / 1e3,
                   100.0 * e.device_time_total / max(total, 1e-9),
                   e.count, e.key[:90]))
    del pred
    torch.cuda.empty_cache()
    return row



# ---------------------------------------------------------------- phase 10
def rnn_sentences(seed, n, vocab, lo, hi):
    """``n`` seeded sentences of ``lo``..``hi`` ids drawn uniformly, each a
    run of the learnable pattern of examples/rnn/lstm_bucketing.py:28-37
    (next id = id + 1, over ids 2..vocab-1; 0 pads)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        start = rng.randint(2, vocab - 1)
        out.append([(start + i) % (vocab - 2) + 2
                    for i in range(rng.randint(lo, hi + 1))])
    return out


def rnn_sym_gen(mt, fused, cfg=None, dtype=None):
    """examples/rnn/lstm_bucketing.py's sym_gen: Embedding, a stacked
    ``LSTMCell.unroll(merge_outputs=True)`` (or one ``FusedRNNCell``, the
    ``--fused`` variant), Reshape, FullyConnected, SoftmaxOutput. With
    ``dtype`` the initial states are zeros of that type (the float64
    reference step; by default float32, as the cells make them)."""
    cfg = cfg or RNN_LM
    h = cfg["num_hidden"]

    def sym_gen(seq_len):
        data = mt.sym.Variable("data")
        label = mt.sym.Variable("softmax_label")
        embed = mt.sym.Embedding(data=data, input_dim=cfg["vocab"],
                                 output_dim=cfg["num_embed"], name="embed")
        if fused:
            stack = mt.rnn.FusedRNNCell(h, num_layers=cfg["num_layers"],
                                        mode="lstm", prefix="lstm_")
        else:
            stack = mt.rnn.SequentialRNNCell()
            for i in range(cfg["num_layers"]):
                stack.add(mt.rnn.LSTMCell(num_hidden=h,
                                          prefix="lstm_l%d_" % i))
        stack.reset()
        begin = None if dtype is None else stack.begin_state(dtype=dtype)
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True,
                                  begin_state=begin)
        pred = mt.sym.Reshape(outputs, shape=(-1, h))
        pred = mt.sym.FullyConnected(data=pred, num_hidden=cfg["vocab"],
                                     name="pred")
        label = mt.sym.Reshape(label, shape=(-1,))
        pred = mt.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def lstm_flops(t, n, i, h, layers, directions=1):
    """Multiply-add flops of an LSTM's forward: per layer, direction and
    step the (N, I_l + H) x (I_l + H, 4H) gate product; the elementwise
    gate arithmetic is left out (< 1 %)."""
    total = 0
    for layer in range(layers):
        il = i if layer == 0 else h * directions
        total += directions * t * 2 * n * (il + h) * 4 * h
    return total


def rnn_op_bound_ms(t, n, i, h, layers, backward):
    """Least time of the RNN op at the card's f32 peak (no TF32): the
    forward's flops, three times that with the backward (the data and
    the weight gradients are one product each more); or the bytes of its
    inputs and outputs read and written once at HBM rate, if larger."""
    flops = lstm_flops(t, n, i, h, layers) * (3 if backward else 1)
    params = 4 * h * (i + h + 2) + (layers - 1) * 4 * h * (2 * h + 2)
    nbytes = 4 * (t * n * i + params + t * n * h + 4 * layers * n * h) * \
        (2 if backward else 1)
    ops_ms = flops / PEAK_OPS_PER_S[torch.float32] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms \
        else "bytes"


def rnn_route_case(rnn, registry, attrs, arrays):
    """One RNN op case on the card: the op (cuDNN's route on a CUDA tensor,
    the loop with the clip) and the plain loop (``rnn._loop_rnn`` on the
    same tensors), forward and the gradients of data, parameters and
    states under the same heads; returns max |op - loop| / max(1, max
    |loop|) over everything."""
    dev = arrays[0].device
    op = registry.get_op("RNN")
    a = op.parse_attrs(attrs)
    t, n, i = arrays[0].shape
    h, layers = int(a.state_size), int(a.num_layers)
    d = 2 if a.bidirectional else 1
    clip = rnn._clip_of(a)
    res = []
    for route in ("op", "loop"):
        leaves = [x.clone().requires_grad_() for x in arrays]
        before = dict(rnn.ROUTES)
        if route == "op":
            outs = list(op.apply(a, leaves))
            want = "cudnn" if dev.type == "cuda" and clip is None \
                else "loop"
            if rnn.ROUTES[want] != before[want] + 1:
                raise AssertionError("RNN %s took the wrong route: %s -> %s"
                                     % (attrs, before, rnn.ROUTES))
        else:
            full = (layers * d, n, h)
            cell = leaves[3].expand(full) if a.mode == "lstm" else None
            outs = rnn._loop_rnn(a, None, leaves[0], rnn._unpack(
                leaves[1], layers, i, h, a.mode, d),
                leaves[2].expand(full), cell, clip)
            outs = [outs[0]] + ([o for o in outs[1:] if o is not None]
                                if a.state_outputs else [])
        gen = torch.Generator(device=dev).manual_seed(7)
        heads = [torch.randn(o.shape, device=dev, generator=gen)
                 for o in outs]
        grads = torch.autograd.grad(outs, leaves, heads)
        res.append([o.detach() for o in outs] + list(grads))
    err = 0.0
    for got, want in zip(*res):
        err = max(err, rel_err(got, want))
    return err


def rnn_op_checks(mt, seed, card):
    """Phase 10's first part: the RNN op's cuDNN route against the plain
    loop on the card at the LM's shape and at the edges, then both
    routes' times at the LM's shape, beside the bound and nn.LSTM."""
    from mxtpu_torch.ops import registry, rnn
    cfg = RNN_LM
    rng = np.random.RandomState(seed + 10)
    dev = mt.gpu(0).torch_device

    def case(mode, bi, layers, t, n, i, h, state_batch, so=True, clip=None):
        d = 2 if bi else 1
        size = rnn.rnn_param_size(layers, i, h, mode, bi)
        arrays = [rng.randn(t, n, i), rng.randn(size) / np.sqrt(h),
                  rng.randn(layers * d, state_batch, h) * 0.5]
        if mode == "lstm":
            arrays.append(rng.randn(layers * d, state_batch, h) * 0.5)
        attrs = {"state_size": h, "num_layers": layers, "mode": mode,
                 "bidirectional": bi, "state_outputs": so}
        if clip is not None:
            attrs.update(lstm_state_clip_min=clip[0],
                         lstm_state_clip_max=clip[1])
        return attrs, [torch.tensor(x, dtype=torch.float32, device=dev)
                       for x in arrays]

    lm = (cfg["buckets"][-1], cfg["batch"], cfg["num_embed"],
          cfg["num_hidden"], cfg["num_layers"])
    cases = [("lm lstm T=%d N=%d I=%d H=%d L=%d" % lm,
              case("lstm", False, lm[4], lm[0], lm[1], lm[2], lm[3],
                   lm[1]))]
    for mode in ("rnn_relu", "rnn_tanh", "lstm", "gru"):
        cases.append(("%s L=2 T=17 N=8" % mode,
                      case(mode, False, 2, 17, 8, 24, 32, 8)))
        cases.append(("%s bidirectional L=2" % mode,
                      case(mode, True, 2, 11, 4, 24, 32, 4)))
    cases += [("lstm T=1", case("lstm", False, 2, 1, 8, 24, 32, 8)),
              ("gru N=1, batch-1 state", case("gru", True, 1, 9, 1, 24, 32,
                                               1)),
              ("lstm N=5, batch-1 state", case("lstm", True, 2, 9, 5, 24, 32,
                                                1)),
              ("lstm no state_outputs", case("lstm", False, 2, 9, 4, 24, 32,
                                              4, so=False)),
              ("lstm clip route (the loop)",
               case("lstm", True, 2, 9, 4, 24, 32, 4, clip=(-0.3, 0.3)))]
    errs = {}
    for name, (attrs, xs) in cases:
        errs[name] = rnn_route_case(rnn, registry, attrs, xs)
        log("  RNN op %s: cuDNN vs loop on the card, outputs and "
            "gradients, max err / max(1, |loop|) %.3e" % (name, errs[name]))
    worst = max(errs.values())
    if not worst <= RNN_OP_TOL:
        raise AssertionError("RNN op: the cuDNN route is %.3e from the loop "
                             "(gate %g): %s" % (worst, RNN_OP_TOL, errs))

    # times at the LM's shape, forward and forward + backward
    attrs, xs = cases[0][1]
    op = registry.get_op("RNN")
    a = op.parse_attrs(attrs)
    t, n, i = xs[0].shape
    h, layers = lm[3], lm[4]
    leaves = [x.clone().requires_grad_() for x in xs]

    def cudnn_fwd():
        with torch.no_grad():
            op.apply(a, xs)

    def cudnn_fb():
        outs = op.apply(a, leaves)
        torch.autograd.grad(outs, leaves, [torch.ones_like(o) for o in outs])

    full = (layers, n, h)

    def loop_fwd():
        with torch.no_grad():
            rnn._loop_rnn(a, None, xs[0], rnn._unpack(
                xs[1], layers, i, h, "lstm", 1), xs[2], xs[3], None)

    def loop_fb():
        outs = rnn._loop_rnn(a, None, leaves[0], rnn._unpack(
            leaves[1], layers, i, h, "lstm", 1), leaves[2].expand(full),
            leaves[3].expand(full), None)
        outs = [o for o in outs if o is not None]
        torch.autograd.grad(outs, leaves, [torch.ones_like(o) for o in outs])

    # nn.LSTM over the same weights, flattened into cuDNN's own buffer
    # (the library yardstick; the port never calls it)
    lib = torch.nn.LSTM(i, h, num_layers=layers).to(dev)
    with torch.no_grad():
        views = [w for per in rnn._unpack(xs[1], layers, i, h, "lstm", 1)
                 for wts in per for w in wts]
        for p, v in zip(lib._flat_weights, views):
            p.copy_(v)
    lib.flatten_parameters()
    lib_x = xs[0].clone().requires_grad_()

    def lib_fwd():
        with torch.no_grad():
            lib(xs[0], (xs[2], xs[3]))

    def lib_fb():
        out, (hn, cn) = lib(lib_x, (xs[2], xs[3]))
        torch.autograd.grad([out, hn, cn], [lib_x] + list(lib.parameters()),
                            [torch.ones_like(out), torch.ones_like(hn),
                             torch.ones_like(cn)])

    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cudnn_fwd()
        torch.cuda.synchronize()
    copies = any("contiguous chunk" in str(w.message) for w in caught)
    flat_bytes = xs[1].numel() * 4
    times = {}
    for name, fn, iters in (("cudnn_fwd", cudnn_fwd, 20),
                            ("cudnn_fwd_bwd", cudnn_fb, 10),
                            ("loop_fwd", loop_fwd, 3),
                            ("loop_fwd_bwd", loop_fb, 3),
                            ("library_fwd", lib_fwd, 20),
                            ("library_fwd_bwd", lib_fb, 10)):
        times[name] = cuda_ms(fn, iters)
    bound_f, by_f = rnn_op_bound_ms(t, n, i, h, layers, False)
    bound_fb, by_fb = rnn_op_bound_ms(t, n, i, h, layers, True)
    log("  [%s] RNN op at the LM's shape (T=%d N=%d I=H=%d L=%d, f32, "
        "TF32 off): forward cuDNN route %.4f ms, loop %.4f, nn.LSTM %.4f, "
        "bound %.4f (%s, %.2f GFLOP at 67 TFLOP/s); forward + backward "
        "cuDNN route %.4f ms, loop %.4f, nn.LSTM %.4f, bound %.4f (%s)"
        % (card, t, n, h, layers, times["cudnn_fwd"], times["loop_fwd"],
           times["library_fwd"], bound_f, by_f,
           lstm_flops(t, n, i, h, layers) / 1e9, times["cudnn_fwd_bwd"],
           times["loop_fwd_bwd"], times["library_fwd_bwd"], bound_fb,
           by_fb))
    log("  the flat vector's views %s cuDNN's weight buffer (torch %s); "
        "the vector is %.2f MB, one copy at HBM rate %.4f ms"
        % ("are not" if copies else "are",
           "warned" if copies else "did not warn", flat_bytes / 1e6,
           2 * flat_bytes / HBM_BYTES_PER_S * 1e3))
    return {"errors": errs, "worst_err": worst, "ms": times,
            "bound_ms": {"fwd": bound_f, "fwd_bwd": bound_fb},
            "bound_by": {"fwd": by_f, "fwd_bwd": by_fb},
            "weights_copied_per_call": copies}


def rnn_batch(mt, sentences, key, batch):
    """A bucket-``key`` DataBatch of the first ``batch`` sentences that
    fit it, padded with 0, labels the next ids, as BucketSentenceIter
    makes them."""
    rows = [s for s in sentences if len(s) <= key][:batch]
    x = np.zeros((batch, key), np.float32)
    for r, s in enumerate(rows):
        x[r, :len(s)] = s
    y = np.zeros_like(x)
    y[:, :-1] = x[:, 1:]
    return mt.io.DataBatch(
        [mt.nd.array(x, ctx=mt.cpu())], [mt.nd.array(y, ctx=mt.cpu())],
        pad=0, bucket_key=key,
        provide_data=[mt.io.DataDesc("data", x.shape)],
        provide_label=[mt.io.DataDesc("softmax_label", y.shape)])


def rnn_grad_gate(got, exact, label):
    """Each gradient's max |got - exact| over the largest |exact| of that
    parameter, and the loss's relative error; (worst, by name)."""
    by = {k: float(np.abs(got[k] - exact[k]).max()) /
          max(float(np.abs(exact[k]).max()), 1e-30) for k in exact}
    worst = max(by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1])[:4]
    log("  %s: worst gradient error / its largest |exact| %.3e (%s)"
        % (label, worst, ", ".join("%s %.2e" % kv for kv in top)))
    return worst, by


def rnn_first_step_gate(mt, mod, sym, batch, card, label):
    """The first step of ``mod`` (bound on gpu(0), initialized) at the
    largest bucket: its loss and every gradient against the same step in
    float64 on cpu() (the executor with float64 arrays) from the same
    weights; then the same step with TF32 in cuBLAS and cuDNN, which must
    fail the gate."""
    weights = mod.get_params()[0]
    x, y = batch.data[0].asnumpy(), batch.label[0].asnumpy()
    outs, g64 = bind_step(mt, sym, mt.cpu(), torch.float64, weights,
                          {"data": x, "softmax_label": y})
    probs64 = outs[0]
    lab = y.reshape(-1).astype(np.int64)
    loss64 = float(-np.log(probs64[np.arange(lab.size), lab]).mean())
    res = {}
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    for run, tf32 in (("gpu", False), ("gpu_tf32", True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            mod.forward_backward(batch)
            torch.cuda.synchronize()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
        m = mod._curr_module
        ex = m._exec_group.execs[0]
        got = {k: ex.grad_dict[k].asnumpy().astype(np.float64) for k in g64}
        probs = m.get_outputs()[0].asnumpy().astype(np.float64)
        loss = float(-np.log(probs[np.arange(lab.size), lab]).mean())
        worst, by = rnn_grad_gate(got, g64, "%s %s first step at T=%d"
                                  % (label, run, x.shape[1]))
        loss_err = abs(loss - loss64) / abs(loss64)
        res[run] = {"worst_grad_err": worst, "grad_err": by,
                    "loss": loss, "loss_err": loss_err,
                    "ok": worst <= RNN_GRAD_TOL and loss_err <= RNN_GRAD_TOL}
        log("  %s %s: loss %.6f vs float64 %.6f (rel %.3e); gate %g: %s"
            % (label, run, loss, loss64, loss_err, RNN_GRAD_TOL,
               "pass" if res[run]["ok"] else "fail"))
    if not res["gpu"]["ok"]:
        raise AssertionError("%s: the card's first step is off float64: %s"
                             % (label, res["gpu"]))
    if res["gpu_tf32"]["ok"]:
        raise AssertionError("%s: the TF32 control step passed the float64 "
                             "gate: the gate cannot tell f32 from TF32"
                             % label)
    res["loss64"] = loss64
    return res


def profiled(step):
    """``step()`` once to warm, then once under torch.profiler, every
    card synchronized: the profiler."""
    from torch.profiler import ProfilerActivity, profile as _prof
    step()
    torch.cuda.synchronize()
    with _prof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        step()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    return prof


def step_kernels(step):
    """(kernel launches, summed kernel ms) of one profiled ``step()`` by
    device index."""
    prof = profiled(step)
    by = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            n, ms = by.get(e.device_index, (0, 0.0))
            by[e.device_index] = (n + 1, ms + e.device_time_total / 1e3)
    return by


def rnn_variant(mt, seed, card, fused, sentences):
    """Config 4 trained through BucketingModule.fit on gpu(0): the first
    step's float64 gate, 8 steps on one batch (CE must fall), then
    ``fit`` over the seeded corpus; per-bucket step ms, launches and busy
    share; shared storage across the buckets."""
    import random
    cfg = RNN_LM
    label = "fused" if fused else "unfused"
    sym_gen = rnn_sym_gen(mt, fused)
    key = max(cfg["buckets"])
    big = rnn_batch(mt, [s for s in sentences if len(s) > key - 10], key,
                    cfg["batch"])

    def fresh():
        mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=key,
                                     context=mt.gpu(0))
        mod.bind(big.provide_data, big.provide_label)
        np.random.seed(seed)
        mod.init_params(mt.init.Xavier(factor_type="in", magnitude=2.34))
        mod.init_optimizer(optimizer="sgd", optimizer_params=RNN_OPT)
        return mod

    mod = fresh()
    w0 = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    gate = rnn_first_step_gate(mt, mod, rnn_sym_gen(
        mt, fused, dtype="float64")(key)[0], big, card, label)
    ce = []
    lab = big.label[0].asnumpy().reshape(-1).astype(np.int64)
    for _ in range(RNN_TRAIN["fall_steps"]):
        mod.forward_backward(big)
        mod.update()
        p = mod.get_outputs()[0].asnumpy()
        ce.append(float(-np.log(np.maximum(p[np.arange(lab.size), lab],
                                           1e-30)).mean()))
    log("  %s: CE over %d steps of one bucket-%d batch: %s"
        % (label, len(ce), key, [round(v, 4) for v in ce]))
    if not np.all(np.isfinite(ce)) or not ce[-1] < ce[0]:
        raise AssertionError("%s: CE did not fall: %s" % (label, ce))
    del mod

    # fit over the corpus
    random.seed(seed)
    np.random.seed(seed)
    it = mt.rnn.BucketSentenceIter(sentences, cfg["batch"],
                                   buckets=list(cfg["buckets"]),
                                   invalid_label=0)
    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=key,
                                 context=mt.gpu(0))
    metric = mt.metric.Perplexity(ignore_label=0)
    ppl, stamps, steps = [], [], []

    def epoch_end(epoch, symbol, arg, aux):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        ppl.append(metric.get()[1])

    def batch_end(param):
        steps.append(param.nbatch)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=RNN_TRAIN["epochs"], eval_metric=metric,
            optimizer="sgd", optimizer_params=RNN_OPT,
            arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                        for k, v in w0.items()},
            initializer=mt.init.Xavier(factor_type="in", magnitude=2.34),
            epoch_end_callback=epoch_end, batch_end_callback=batch_end)
    peak = torch.cuda.max_memory_allocated()
    epoch_s = [float(v) for v in np.diff([t0] + stamps)]
    n_batches = len(steps) // RNN_TRAIN["epochs"]
    words = sum(len(s) for s in sentences if len(s) <= key)
    log("  %s fit: %d epochs of %d batches; train perplexity by epoch %s; "
        "epoch s %s (the Perplexity metric copies each step's %d x %d "
        "probabilities to the host); peak memory %.2f GB"
        % (label, RNN_TRAIN["epochs"], n_batches,
           [round(v, 2) for v in ppl], [round(v, 2) for v in epoch_s],
           cfg["batch"] * key, cfg["vocab"], peak / 1e9))
    if not np.all(np.isfinite(ppl)):
        raise AssertionError("%s: perplexity not finite: %s" % (label, ppl))
    # every bucket runs over the default bucket's tensors
    buckets = mod.buckets
    ex0 = buckets[key]._exec_group.execs[0]
    for k, m in buckets.items():
        ex = m._exec_group.execs[0]
        for n in buckets[key]._param_names:
            if ex.arg_dict[n]._data.data_ptr() != \
                    ex0.arg_dict[n]._data.data_ptr() or \
                    ex.grad_dict[n]._data.data_ptr() != \
                    ex0.grad_dict[n]._data.data_ptr():
                raise AssertionError("%s: bucket %d does not share %s"
                                     % (label, k, n))
        if m._fused is None or m._fused.opt_state is not \
                buckets[key]._fused.opt_state:
            raise AssertionError("%s: bucket %d has its own optimizer "
                                 "state" % (label, k))
    log("  %s: all %d buckets share one set of parameters, gradients and "
        "optimizer state" % (label, len(buckets)))

    # each bucket's step on the host clock to a sync, its launches and
    # device time under the profiler
    per_bucket = {}
    for k in cfg["buckets"]:
        b = rnn_batch(mt, sentences, k, cfg["batch"])

        def step():
            mod.forward_backward(b)
            mod.update()

        ms = []
        for i in range(RNN_TRAIN["timed_steps"] + 1):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            if i:
                ms.append((time.perf_counter() - t1) * 1e3)
        launches, dev_ms = step_kernels(step).get(0, (0, 0.0))
        med = float(np.median(ms))
        per_bucket[k] = {"step_ms": med, "step_ms_all": ms,
                         "launches": launches, "device_ms": dev_ms,
                         "busy_share": dev_ms / med,
                         "words_per_s": cfg["batch"] * k / (med / 1e3)}
        log("  [%s] %s bucket %d: step %.2f ms (median of %d), %.0f words/s, "
            "%d kernel launches, %.2f ms of device time (busy %.1f %%)"
            % (card, label, k, med, len(ms), per_bucket[k]["words_per_s"],
               launches, dev_ms, 100 * dev_ms / med))
    total_ms = sum(per_bucket[k]["step_ms"] for k in cfg["buckets"])
    mean_words = cfg["batch"] * sum(cfg["buckets"]) / (total_ms / 1e3)
    return {"first_step": gate, "ce_fall": ce, "perplexity": ppl,
            "epoch_s": epoch_s, "batches_per_epoch": n_batches,
            "corpus_words": words, "peak_memory": int(peak),
            "buckets": per_bucket, "words_per_s_over_buckets": mean_words}


def gluon_rnn_lm(mt, cfg):
    net = mt.gluon.nn.Sequential(prefix="lm_")
    with net.name_scope():
        net.add(mt.gluon.nn.Embedding(cfg["vocab"], cfg["num_embed"]))
        net.add(mt.gluon.rnn.LSTM(cfg["num_hidden"],
                                  num_layers=cfg["num_layers"],
                                  layout="NTC", input_size=cfg["num_embed"]))
        net.add(mt.gluon.nn.Dense(cfg["vocab"], flatten=False,
                                  in_units=cfg["num_hidden"]))
    return net


def rnn_gluon(mt, seed, card):
    """Gluon's rnn.LSTM(200, num_layers=2) between an Embedding and a
    Dense(10000): the first step's gradients on gpu(0) against the same
    net in float64 on cpu(); then SGD Trainer.steps imperative and with
    the Embedding and Dense hybridized, timed."""
    cfg = RNN_LM
    b, t = cfg["batch"], RNN_GLUON["seq_len"]
    rng = np.random.RandomState(seed + 3)
    ids = rng.randint(2, cfg["vocab"], (b, t + 1)).astype(np.float32)
    nets = {}
    for name, ctx in (("gpu", mt.gpu(0)), ("cpu64", mt.cpu())):
        net = gluon_rnn_lm(mt, cfg)
        np.random.seed(seed)
        net.collect_params().initialize(mt.init.Xavier(), ctx=ctx)
        nets[name] = net
    src = {k[len(nets["gpu"].prefix):]: p.data().asnumpy()
           for k, p in nets["gpu"].collect_params().items()}
    mt.convert.gluon_params_from_mxtpu(src, mt.cpu(), nets["cpu64"])
    nets["cpu64"].cast("float64")
    grads = {}
    for name, net in nets.items():
        ctx = mt.gpu(0) if name == "gpu" else mt.cpu()
        dt = "float64" if name == "cpu64" else "float32"
        x = mt.nd.array(ids[:, :-1], ctx=ctx, dtype=dt)
        y = mt.nd.array(ids[:, 1:], ctx=ctx, dtype=dt)
        loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        grads[name] = {k[len(net.prefix):]: p.grad().asnumpy().astype(
            np.float64) for k, p in net.collect_params().items()}
    worst, by = rnn_grad_gate(grads["gpu"], grads["cpu64"],
                              "Gluon LSTM LM first step (B=%d, T=%d)"
                              % (b, t))
    if not worst <= RNN_GRAD_TOL:
        raise AssertionError("Gluon LSTM LM: the card's first step is %.3e "
                             "off float64 (gate %g)" % (worst, RNN_GRAD_TOL))
    net = nets["gpu"]
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": RNN_GLUON["lr"],
                                "momentum": RNN_OPT["momentum"]})
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    x = mt.nd.array(ids[:, :-1], ctx=mt.gpu(0))
    y = mt.nd.array(ids[:, 1:], ctx=mt.gpu(0))
    runs = {}
    for mode in ("imperative", "hybridized"):
        if mode == "hybridized":
            net.hybridize()
        ms, losses = [], []
        for i in range(RNN_GLUON["steps"] + 1):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with mt.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(b)
            torch.cuda.synchronize()
            if i:
                ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(loss.mean().asnumpy()))
        runs[mode] = {"step_ms": ms, "step_ms_median": float(np.median(ms)),
                      "loss": losses}
        log("  [%s] Gluon LSTM LM %s: step ms %s (median %.2f), loss %s"
            % (card, mode, [round(v, 2) for v in ms],
               runs[mode]["step_ms_median"], [round(v, 4) for v in losses]))
    allloss = runs["imperative"]["loss"] + runs["hybridized"]["loss"]
    if not np.all(np.isfinite(allloss)) or not allloss[-1] < allloss[0]:
        raise AssertionError("Gluon LSTM LM: loss did not fall: %s"
                             % allloss)
    return {"first_step_err": worst, "first_step_by": by, "runs": runs}


def phase_rnn(mt, seed, card):
    """Phase 10: the RNN op on cuDNN against the loop; BASELINE config 4
    (the LSTM bucketing LM) trained through BucketingModule.fit, unfused
    and --fused; Gluon's rnn.LSTM."""
    from mxtpu_torch.ops import rnn
    cfg = RNN_LM
    res = {"op": rnn_op_checks(mt, seed, card)}
    sentences = rnn_sentences(seed, RNN_TRAIN["sentences"], cfg["vocab"],
                              *RNN_TRAIN["lengths"])
    counts = np.bincount([int(np.searchsorted(cfg["buckets"], len(s)))
                          for s in sentences], minlength=len(cfg["buckets"]))
    log("  corpus: %d seeded sentences, %d-%d ids, %d words; sentences by "
        "bucket %s" % (len(sentences), RNN_TRAIN["lengths"][0],
                       RNN_TRAIN["lengths"][1],
                       sum(len(s) for s in sentences),
                       dict(zip(cfg["buckets"], counts.tolist()))))
    for fused in (False, True):
        before = dict(rnn.ROUTES)
        name = "fused" if fused else "unfused"
        res[name] = rnn_variant(mt, seed, card, fused, sentences)
        res[name]["routes"] = {k: rnn.ROUTES[k] - before[k]
                               for k in rnn.ROUTES}
        if fused != (res[name]["routes"]["cudnn"] > 0):
            raise AssertionError("%s: RNN routes %s" % (name,
                                                        res[name]["routes"]))
    res["gluon"] = rnn_gluon(mt, seed, card)
    torch.cuda.empty_cache()
    return res


def mp_lstm_symbol(mt, cfg):
    """examples/rnn/model_parallel_lstm.py's build_symbol: the embedding
    and the first unrolled LSTM in ctx group 'embed_rnn1', the second LSTM
    and the head in 'rnn2_head'."""
    h, vocab, t = cfg["hidden"], cfg["vocab"], cfg["seq_len"]
    with mt.AttrScope(ctx_group="embed_rnn1"):
        data = mt.sym.Variable("data")
        label = mt.sym.Variable("softmax_label")
        embed = mt.sym.Embedding(data, input_dim=vocab, output_dim=h,
                                 name="embed")
        cell1 = mt.rnn.LSTMCell(num_hidden=h, prefix="lstm1_")
        out1, _ = cell1.unroll(t, inputs=embed, merge_outputs=True,
                               layout="NTC")
    with mt.AttrScope(ctx_group="rnn2_head"):
        cell2 = mt.rnn.LSTMCell(num_hidden=h, prefix="lstm2_")
        out2, _ = cell2.unroll(t, inputs=out1, merge_outputs=True,
                               layout="NTC")
        flat = mt.sym.Reshape(out2, shape=(-1, h))
        fc = mt.sym.FullyConnected(flat, num_hidden=vocab, name="fc")
        lbl = mt.sym.Reshape(label, shape=(-1,))
        return mt.sym.SoftmaxOutput(fc, lbl, name="softmax",
                                    normalization="batch")


def multi_group2ctx(mt, seed, card):
    """``--multi-gpu``'s group2ctx phase: the model-parallel LSTM at
    config 4's widths with 'embed_rnn1' on gpu(0) and 'rnn2_head' on
    gpu(1) (``simple_bind(group2ctx=...)``: each variable on its group's
    card), a few SGD steps through the Executor, against the same net on
    gpu(0) alone from the same weights and batches. Gates: outputs and
    weights within MP_LSTM["tol"] (printed: bit-identical or not); under
    the profiler both cards run kernels in the split step, one card in
    the other."""
    cfg = MP_LSTM
    b, t = cfg["batch"], cfg["seq_len"]
    net = mp_lstm_symbol(mt, cfg)
    shapes = dict(zip(net.list_arguments(), net.infer_shape(
        data=(b, t), softmax_label=(b, t))[0]))
    params = [n for n in shapes if n not in ("data", "softmax_label")]
    np.random.seed(seed + 4)
    w0 = {}
    for n in params:
        w0[n] = np.zeros(shapes[n], np.float32)
        if n.endswith("weight"):
            mt.init.Xavier()._init_weight(n, w0[n])
    rng = np.random.RandomState(seed + 5)
    tokens = rng.randint(0, cfg["vocab"], (cfg["steps"], b, t + 1)).astype(
        np.float32)
    reqs = {n: ("write" if n in w0 else "null") for n in shapes}
    runs = {}
    for name, g2c in (("split", {"embed_rnn1": mt.gpu(0),
                                 "rnn2_head": mt.gpu(1)}),
                      ("one_card", None)):
        exe = net.simple_bind(mt.gpu(0), grad_req=reqs, group2ctx=g2c,
                              data=(b, t), softmax_label=(b, t))
        for n, v in w0.items():
            exe.arg_dict[n][:] = v

        def step(batch):
            exe.arg_dict["data"][:] = batch[:, :-1]
            exe.arg_dict["softmax_label"][:] = batch[:, 1:]
            out = exe.forward(is_train=True)[0]
            exe.backward()
            with torch.no_grad():
                for n in w0:
                    exe.arg_dict[n]._data.sub_(
                        cfg["lr"] * exe.grad_dict[n]._data)
            return out

        outs, ms = [], []
        for batch in tokens:
            for i in range(2):
                torch.cuda.synchronize(i)
            t1 = time.perf_counter()
            out = step(batch)
            for i in range(2):
                torch.cuda.synchronize(i)
            ms.append((time.perf_counter() - t1) * 1e3)
            outs.append(out.asnumpy())
        weights = {n: exe.arg_dict[n].asnumpy() for n in w0}
        places = sorted({str(exe.arg_dict[n].context) for n in w0})
        kernels = step_kernels(lambda: step(tokens[0]))
        runs[name] = {"outs": outs, "weights": weights, "step_ms": ms,
                      "copies": exe.cross_device_copies,
                      "kernels_by_device": kernels, "places": places,
                      "out_device": str(out.context)}
        log("  [%s] model-parallel LSTM %s: step ms %s; cross-device copies "
            "a forward %d (each carried back once by the backward); "
            "parameters on %s; kernels by device %s"
            % (card, name, [round(v, 2) for v in ms],
               exe.cross_device_copies, places,
               {k: (v[0], round(v[1], 3)) for k, v in kernels.items()}))
        del exe
    split, one = runs["split"], runs["one_card"]
    out_err = max(float(np.abs(a - b_).max())
                  for a, b_ in zip(split["outs"], one["outs"]))
    w_err = max(float(np.abs(split["weights"][n] - one["weights"][n]).max())
                for n in w0)
    same = out_err == 0.0 and w_err == 0.0
    log("  split vs one card over %d steps: outputs max abs diff %.3e, "
        "weights %.3e (%s)" % (cfg["steps"], out_err, w_err,
                               "bit-identical" if same else
                               "not bit-identical"))
    if not (out_err <= cfg["tol"] and w_err <= cfg["tol"]):
        raise AssertionError("group2ctx: the split net is %.3e / %.3e from "
                             "one card (gate %g)" % (out_err, w_err,
                                                     cfg["tol"]))
    busy = split["kernels_by_device"]
    if not (busy.get(0, (0,))[0] > 0 and busy.get(1, (0,))[0] > 0):
        raise AssertionError("group2ctx: kernels by device %s: each group "
                             "must run on its own card" % busy)
    if set(one["kernels_by_device"]) != {0}:
        raise AssertionError("group2ctx: the one-card net ran kernels on %s"
                             % one["kernels_by_device"])
    if split["places"] != ["gpu(0)", "gpu(1)"] or split["copies"] < 1:
        raise AssertionError("group2ctx: placement %s, %d copies"
                             % (split["places"], split["copies"]))
    return {"out_err": out_err, "weight_err": w_err, "bit_identical": same,
            "split_step_ms": split["step_ms"],
            "one_card_step_ms": one["step_ms"],
            "copies_per_forward": split["copies"],
            "kernels_by_device": {
                k: {str(d): list(v) for d, v in r["kernels_by_device"].items()}
                for k, r in runs.items()}}


# ---------------------------------------------------------------- phase 11
def ssd_heads_symbol(mt, cfg):
    """The train symbol's heads, Group([loc_preds, cls_preds, anchors]),
    built from the model's own pieces (the same parameter names)."""
    ssd = mt.models.ssd
    data = mt.sym.Variable("data")
    layers = ssd._build_features(data, cfg["num_scales"],
                                 network=cfg["network"])
    sizes, ratios = ssd.default_spec(cfg["num_scales"])
    return mt.sym.Group(list(ssd._multibox_layer(
        layers, cfg["num_classes"], sizes, ratios)))


def ssd_targets_symbol(mt, cfg):
    """The train symbol's loss heads (cls_prob, loc_loss) with the three
    targets as variables (``loc_target``, ``loc_target_mask``,
    ``cls_target``) in place of MultiBoxTarget: the graph a float64 step
    runs on a float32 run's targets."""
    ssd = mt.models.ssd
    data = mt.sym.Variable("data")
    layers = ssd._build_features(data, cfg["num_scales"],
                                 network=cfg["network"])
    sizes, ratios = ssd.default_spec(cfg["num_scales"])
    loc_preds, cls_preds, _ = ssd._multibox_layer(
        layers, cfg["num_classes"], sizes, ratios)
    loc_t, loc_m, cls_t = [mt.sym.Variable(n) for n in (
        "loc_target", "loc_target_mask", "cls_target")]
    cls_prob = mt.sym.SoftmaxOutput(cls_preds, cls_t, ignore_label=-1,
                                    use_ignore=True, multi_output=True,
                                    normalization="valid", name="cls_prob")
    loc_loss = mt.sym.MakeLoss(
        mt.sym.smooth_l1(loc_m * (loc_preds - loc_t), scalar=1.0,
                         name="loc_loss_"),
        grad_scale=1.0, normalization="valid", name="loc_loss")
    return mt.sym.Group([cls_prob, loc_loss])


def ssd_targets(mt, heads, label):
    """MultiBoxTarget as get_symbol_train configures it, on the heads
    (loc_preds, cls_preds, anchors) and ``label``: (loc_target,
    loc_target_mask, cls_target) tensors."""
    _, _, outs = mt.ops.registry.invoke(
        "_contrib_MultiBoxTarget", [heads[2], label, heads[1]],
        dict(overlap_threshold=0.5, ignore_label=-1,
             negative_mining_ratio=3.0, minimum_negative_samples=0,
             negative_mining_thresh=0.5, variances=(0.1, 0.1, 0.2, 0.2)))
    return outs


def bind_step(mt, sym, ctx, dtype, weights, inputs, grad=True):
    """``sym`` bound on ``ctx`` in ``dtype`` with ``weights`` (NDArrays)
    and ``inputs`` (name -> tensor or numpy array), one training forward
    and backward (every head's gradient ones, which a loss head ignores;
    an inference forward without ``grad``): (outputs, {parameter:
    gradient}) as float64 numpy, or the output tensors without ``grad``.
    Phase 10's and 11's float64 steps run through it."""
    dev = ctx.torch_device

    def arr(v):
        t = v._data if hasattr(v, "_data") else (
            torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
        return mt.nd.NDArray(t.to(dev, dtype, copy=True).contiguous(), ctx)

    args = {n: arr(v) for n, v in weights.items()}
    args.update({n: arr(v) for n, v in inputs.items()})
    if not grad:
        exe = sym.bind(ctx, args, grad_req="null")
        return [o._data for o in exe.forward(is_train=False)]
    grads = {n: mt.nd.NDArray(torch.zeros_like(args[n]._data), ctx)
             for n in weights}
    exe = sym.bind(ctx, args, args_grad=grads)
    outs = exe.forward(is_train=True)
    exe.backward()
    torch.cuda.synchronize()
    return ([o.asnumpy().astype(np.float64) for o in outs],
            {n: g._data.double().cpu().numpy() for n, g in grads.items()})


def ssd_grad_err(got, exact, label):
    """Each parameter's max |got - exact| over its largest |exact|, the
    denominator floored at 1e-6 of the largest gradient of any parameter
    (a layer whose exact gradient is ~0 is held to the net's scale);
    (worst, by name)."""
    floor = 1e-6 * max(float(np.abs(g).max()) for g in exact.values())
    by = {k: float(np.abs(got[k] - exact[k]).max()) /
          max(float(np.abs(exact[k]).max()), floor) for k in exact}
    worst = max(by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1])[:4]
    log("  %s: worst gradient error / its largest |exact| %.3e (%s)"
        % (label, worst, ", ".join("%s %.2e" % kv for kv in top)))
    return worst, by


def ssd_first_step_gate(mt, contrib, ssd_data, weights, seed, card):
    """The full-width train symbol's first step at B=2 on gpu(0) in f32
    against the same step in float64 on the card. The targets first: the
    f32 run's cls_target equals MultiBoxTarget on its own heads; the
    anchors whose float64 target differs are counted beside the
    hard-negative margin and the largest drift of the hardness scores
    between the runs (a difference with the margin above the drift
    fails: it cannot come from a near-tie); the float64 step then takes
    the f32 run's three targets as inputs (``ssd_targets_symbol``). Every
    gradient within SSD_GRAD_TOL of the float64 one (``ssd_grad_err``),
    cls_prob and loc_loss within SSD_GRAD_TOL relative; a step with TF32
    in cuBLAS and cuDNN must fail. The same step in f32 on cpu() is
    printed beside, as f32's own distance from float64."""
    cfg = SSD
    b = SSD_TRAIN["f64_batch"]
    x, lab = ssd_data.make_batch(np.random.RandomState(seed + 11), b,
                                 (3, cfg["data_shape"], cfg["data_shape"]),
                                 cfg["num_classes"])
    gpu = mt.gpu(0)
    train = mt.models.ssd.get_symbol_train(
        num_classes=cfg["num_classes"], num_scales=cfg["num_scales"],
        network=cfg["network"])
    heads_sym = ssd_heads_symbol(mt, cfg)
    heads = bind_step(mt, heads_sym, gpu, torch.float32, weights,
                     {"data": x}, grad=False)
    label = torch.from_numpy(lab).to(heads[0].device)
    t32 = ssd_targets(mt, heads, label)
    margin = ssd_data.mining_margin(heads[2], label, heads[1], t32[2])
    heads64 = bind_step(mt, heads_sym, gpu, torch.float64, weights,
                       {"data": x}, grad=False)
    t64 = ssd_targets(mt, heads64, label.double())
    differ = int((t64[2].float() != t32[2]).sum())
    # how far the two runs' hardness scores part: a negative can swap
    # across the cut only where the margin is within it
    drift = float((torch.amax(heads64[1][:, 1:], dim=1)
                   - torch.amax(heads[1][:, 1:], dim=1).double()).abs().max())
    log("  [%s] first step targets at B=%d: %d positives, %d kept "
        "negatives; hard-negative margin %.3e against the float64 run's "
        "largest hardness drift %.3e; anchors whose float64 cls_target "
        "differs: %d (the float64 step takes the f32 targets)"
        % (card, b, int((t32[2] > 0).sum()), int((t32[2] == 0).sum()),
           margin, drift, differ))
    if differ and margin > drift:
        raise AssertionError("ssd: %d float64 targets differ with no "
                             "hard negative within reach of the cut "
                             "(margin %g, drift %g)"
                             % (differ, margin, drift))
    targets = {"loc_target": t32[0], "loc_target_mask": t32[1],
               "cls_target": t32[2]}
    exact_out, exact = bind_step(mt, ssd_targets_symbol(mt, cfg), gpu,
                                torch.float64, weights,
                                dict(targets, data=x))
    res = {"margin": margin, "hardness_drift": drift,
           "f64_target_differs": differ}
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    # the card's step through the train symbol; the same step on cpu() in
    # f32 (printed: f32's own distance from float64); the TF32 control.
    # The last two take the f32 targets: their own heads would pick other
    # negatives at a near-tie
    held = ssd_targets_symbol(mt, cfg)
    for run, tf32, sym, ctx, inputs in (
            ("gpu", False, train, gpu, {"data": x, "label": lab}),
            ("cpu", False, held, mt.cpu(), dict(targets, data=x)),
            ("gpu_tf32", True, held, gpu, dict(targets, data=x))):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            outs, got = bind_step(mt, sym, ctx, torch.float32, weights,
                                 inputs)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
        if run == "gpu" and not np.array_equal(outs[2],
                                               t32[2].cpu().numpy()):
            raise AssertionError("ssd: the step's cls_target is not "
                                 "MultiBoxTarget's on its heads")
        worst, by = ssd_grad_err(got, exact, "ssd %s first step" % run)
        l2 = max(float(np.linalg.norm(got[k] - exact[k])) /
                 max(float(np.linalg.norm(exact[k])), 1e-30) for k in exact)
        out_err = max(float(np.abs(outs[i] - exact_out[i]).max()) /
                      max(float(np.abs(exact_out[i]).max()), 1e-30)
                      for i in (0, 1))
        res[run] = {"worst_grad_err": worst, "grad_err": by,
                    "worst_l2_err": l2, "out_err": out_err,
                    "ok": worst <= SSD_GRAD_TOL and out_err <= SSD_GRAD_TOL}
        if run == "cpu":
            res[run]["ok"] = None  # printed, not gated
        log("  ssd %s: worst per-parameter L2 error %.3e; cls_prob and "
            "loc_loss vs float64 %.3e; gate %g: %s"
            % (run, l2, out_err, SSD_GRAD_TOL,
               {True: "pass", False: "fail", None: "not gated"}[
                   res[run]["ok"]]))
    if not res["gpu"]["ok"]:
        raise AssertionError("ssd: the card's first step is off float64: "
                             "%s" % {k: v for k, v in res["gpu"].items()
                                     if k != "grad_err"})
    if res["gpu_tf32"]["ok"]:
        raise AssertionError("ssd: the TF32 control step passed the float64 "
                             "gate: the gate cannot tell f32 from TF32")
    return res


def nms_ops(boxes, scores, cls, keep, force):
    """Operations the sweep needs on these candidates: an IoU
    (NMS_IOU_OPS) for each kept i and each later j it may clear (same
    class, or any under force_suppress, and alive at the start), summed
    over the batch one image at a time (K x K temporaries)."""
    k = scores.shape[1]
    later = torch.ones(k, k, dtype=torch.bool, device=scores.device).triu(1)
    pairs = 0
    for c, kp, s in zip(cls, keep, scores):
        same = (c.unsqueeze(1) == c.unsqueeze(0)) | bool(force)
        pairs += int((same & later & kp.unsqueeze(1)
                      & (s > float("-inf")).unsqueeze(0)).sum())
    return NMS_IOU_OPS * pairs


def nms_timed(contrib, cands, plain_batch, card, label):
    """CUDA-event times of the suppression kernel on ``cands`` (boxes,
    scores, class ids of B images) and of its plain version on the first
    ``plain_batch`` of them, beside bound_ms: the larger of its bytes (24
    in and 1 out a candidate) at HBM_BYTES_PER_S and its operations,
    ``nms_ops``, at the f32 peak."""
    boxes, scores, cls = cands
    B, K = scores.shape
    keep = contrib.nms_keep(boxes, scores, cls, 0.5, False)
    ms = cuda_ms(lambda: contrib.nms_keep(boxes, scores, cls, 0.5, False),
                 50 if K <= 1000 else 10)
    part = [x[:plain_batch] for x in cands]
    plain_ms = cuda_ms(lambda: contrib.nms_keep_reference(*part, 0.5, False),
                       3 if K <= 1000 else 1, warmup=1)
    nbytes = boxes.numel() * 4 + scores.numel() * 4 + cls.numel() * 4 + \
        keep.numel()
    ops = nms_ops(boxes, scores, cls, keep, False)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    # device ms of each of the two launches, from one profiled call; None
    # where the profiler saw neither (so it reads in `--phases ssd`, but
    # not after the earlier phases' profiler sessions of the default run)
    split = {name: 0.0 for name in NMS_LAUNCHES}
    for e in profiled(lambda: contrib.nms_keep(boxes, scores, cls, 0.5,
                                               False)).events():
        for name in NMS_LAUNCHES:
            if e.device_type.name == "CUDA" and name in e.name:
                split[name] += e.device_time_total / 1e3
    if not any(split.values()):
        split = None
    row = {"B": B, "K": K, "live": int((scores > float("-inf")).sum()),
           "kept": int(keep.sum()), "ms": ms, "plain_ms": plain_ms,
           "plain_B": plain_batch, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes, "operations": ops, "max_abs_err": 0.0,
           "library_ms": None, "launch_ms": split,
           "scratch_bytes": contrib.nms_plan(B, K)["scratch_bytes"]}
    log("  [%s] multibox_nms at B=%d, K=%d (%s; %d live, %d kept): kernel "
        "%.4f ms (profiled: %s), plain %.3f ms at B=%d, bound %.6f ms (%s: "
        "%d bytes, %d operations), scratch %d bytes; no PyTorch call "
        "computes it"
        % (card, B, K, label, row["live"], row["kept"], ms,
           "matrix %.4f, sweep %.4f" % tuple(split[n] for n in NMS_LAUNCHES)
           if split else "no launch traced", plain_ms, plain_batch,
           row["bound_ms"], row["bound_by"], nbytes, ops,
           row["scratch_bytes"]))
    return row


def ssd_nms_checks(mt, contrib, ssd_data, weights, seed, card):
    """The suppression kernel against its plain version on the card, bit
    for bit: on the candidates decoded from the full-width net's outputs
    at B=32 (K = nms_topk = 400 of 7,486 anchors), on every set of
    ``ssd_data.nms_sets`` at B=32 (one class overlapping, IoUs at the
    threshold, -inf tails, force_suppress, NaN boxes, K = 37, 1,376 and
    1, dead scores between live ones), and at nms_topk -1 (all 7,486
    candidates) at B=4; then ``nms_timed`` at K=400 (kernel and plain at
    B=32) and at K=7,486 (kernel at B=32, plain at B=4). Returns the
    K=400 row with the K=7,486 row under "all_anchors"."""
    cfg = SSD
    B = cfg["batch"]
    x, _ = ssd_data.make_batch(np.random.RandomState(seed + 7), B,
                               (3, cfg["data_shape"], cfg["data_shape"]),
                               cfg["num_classes"])
    loc_preds, cls_preds, anchors = bind_step(
        mt, ssd_heads_symbol(mt, cfg), mt.gpu(0), torch.float32, weights,
        {"data": x}, grad=False)
    op = mt.ops.registry.get_op("_contrib_MultiBoxDetection")
    cands = {}
    for topk in (cfg["nms_topk"], -1):
        a = op.parse_attrs(dict(nms_threshold=0.5, force_suppress=False,
                                variances=(0.1, 0.1, 0.2, 0.2),
                                nms_topk=topk))
        cands[topk] = contrib.detection_candidates(
            a, torch.softmax(cls_preds, dim=1), loc_preds, anchors)
    small = SSD_ALL_ANCHORS_BATCH
    sets = [("decoded", *cands[cfg["nms_topk"]], 0.5, False),
            ("decoded_all", *[v[:small] for v in cands[-1]], 0.5, False)] + [
        (n, *[torch.from_numpy(v).to(anchors.device) for v in (b_, s_, c_)],
         t, f)
        for n, b_, s_, c_, t, f in ssd_data.nms_sets(batch=B, seed=seed)]
    checked = {}
    for name, boxes, scores, cls, thresh, force in sets:
        got = contrib.nms_keep(boxes, scores, cls, thresh, force)
        want = contrib.nms_keep_reference(boxes, scores, cls, thresh, force)
        torch.cuda.synchronize()
        wrong = int((got != want).sum())
        checked[name] = {"B": int(boxes.shape[0]), "K": int(boxes.shape[1]),
                         "kept": int(want.sum()), "differ": wrong}
        if wrong:
            raise AssertionError("multibox_nms %s: %d keep entries differ "
                                 "from the plain version" % (name, wrong))
        del got, want
    log("  multibox_nms == plain bit for bit on %s"
        % ", ".join("%s (B=%d, K=%d, %d kept)" % (n, c["B"], c["K"],
                                                   c["kept"])
                    for n, c in checked.items()))
    row = nms_timed(contrib, cands[cfg["nms_topk"]], B, card,
                    "nms_topk %d" % cfg["nms_topk"])
    row["all_anchors"] = nms_timed(contrib, cands[-1], small, card,
                                   "nms_topk -1")
    row["sets"] = checked
    torch.cuda.empty_cache()
    return row


def ssd_gate_twin(mt, ssd_data, card):
    """tests/test_examples_gate.py::test_ssd_gate on gpu(0) through the
    port, from the port's own Xavier draws at SSD_GATE_SEEDS (numpy's
    stream: mxtpu's draw at its seed 2 is another net): each seed's
    trained CrossEntropy < 1.2 and checkpoint reloaded bit for bit, and
    the mean mAP over the seeds above max(the mean untrained mAP, 0.05).
    Each seed's figures are printed: the gate's mAP swings with the
    initial net in both packages."""
    import tempfile
    runs = []
    tmp = tempfile.mkdtemp(prefix="ssd_gate_")
    try:
        for s in SSD_GATE_SEEDS:
            t0 = time.perf_counter()
            out = ssd_data.gate_twin(mt, mt.gpu(0),
                                     os.path.join(tmp, "s%d" % s), seed=s)
            out["seconds"] = time.perf_counter() - t0
            out = {k: (float(v) if isinstance(v, np.floating) else v)
                   for k, v in out.items()}
            runs.append(out)
            log("  [%s] gate twin seed %d: CrossEntropy %.4f, SmoothL1 %.4f, "
                "mAP untrained %.4f -> trained %.4f, reload bit-exact %s "
                "(%.1f s)" % (card, s, out["cross_entropy"],
                              out["smooth_l1"], out["map_untrained"],
                              out["map_trained"], out["reload_bit_exact"],
                              out["seconds"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mean_t = float(np.mean([r["map_trained"] for r in runs]))
    mean_u = float(np.mean([r["map_untrained"] for r in runs]))
    log("  gate twin: mean mAP over seeds %s: untrained %.4f, trained %.4f "
        "(gate > %.4f)" % (list(SSD_GATE_SEEDS), mean_u, mean_t,
                           max(mean_u, 0.05)))
    for s, r in zip(SSD_GATE_SEEDS, runs):
        if not r["cross_entropy"] < 1.2 or not r["reload_bit_exact"]:
            raise AssertionError("ssd gate twin seed %d: %s" % (s, r))
    if not mean_t > max(mean_u, 0.05):
        raise AssertionError("ssd gate twin: mean mAP %.4f not above %.4f"
                             % (mean_t, max(mean_u, 0.05)))
    return {"seeds": list(SSD_GATE_SEEDS), "runs": runs,
            "map_trained_mean": mean_t, "map_untrained_mean": mean_u}


def ssd_multibox_ms(mt, step):
    """One step under torch.profiler with the MultiBoxTarget and
    MultiBoxDetection ops inside record_function ranges: (kernel
    launches, device ms of the step, {op: device ms of its kernels})."""
    names = {"_contrib_MultiBoxTarget": "ssd::MultiBoxTarget",
             "_contrib_MultiBoxDetection": "ssd::MultiBoxDetection"}
    ops = {n: mt.ops.registry.get_op(n) for n in names}
    saved = {n: op.fn for n, op in ops.items()}

    def ranged(fn, label):
        def run(*args):
            with torch.profiler.record_function(label):
                return fn(*args)
        return run

    try:
        for n, op in ops.items():
            op.fn = ranged(saved[n], names[n])
        prof = profiled(step)
    finally:
        for n, op in ops.items():
            op.fn = saved[n]
    launches, dev_ms = 0, 0.0
    for e in prof.events():
        if e.device_type.name == "CUDA":
            launches += 1
            dev_ms += e.device_time_total / 1e3
    by_op = {}
    for e in prof.key_averages():
        if e.key in names.values():
            by_op[e.key.split("::")[1]] = e.device_time_total / 1e3
    return launches, dev_ms, by_op


def ssd_training(mt, contrib, ssd_data, weights, seed, card):
    """Config 5 through Module.fit on gpu(0): vgg16_reduced at 300x300, 20
    classes, 6 scales, B=32, SGD (examples/ssd/train.py:96-100's momentum
    0.9 and wd 5e-4 at lr 1e-3) from the Xavier weights, f32 with TF32
    off, MultiBoxMetric, one seeded synthetic batch 8 times (CE, from each
    step's outputs, must fall); then steps timed on the host clock to a
    sync at B=32 and at B=8 (mxtpu's example default), images/s and the
    share of the f32 peak at SSD_FLOPS_PER_IMAGE, one profiled step
    (launches, device-busy share, MultiBoxTarget and MultiBoxDetection's
    device and host ms), the metric's host copy, peak memory. The
    suppression kernel must launch once a step, counted from zero."""
    cfg = SSD
    shape = (3, cfg["data_shape"], cfg["data_shape"])
    out = {}
    for b in (cfg["batch"], cfg["small_batch"]):
        x, lab = ssd_data.make_batch(np.random.RandomState(seed + b), b,
                                     shape, cfg["num_classes"])
        it = RepeatBatch(mt, x, lab, SSD_TRAIN["fall_steps"],
                         label_name="label")
        mod = mt.mod.Module(mt.models.ssd.get_symbol_train(
            num_classes=cfg["num_classes"], num_scales=cfg["num_scales"],
            network=cfg["network"]), label_names=("label",),
            context=mt.gpu(0))
        metric = ssd_data.MultiBoxMetric()
        ce, stamps = [], []

        def batch_end(param):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            m = ssd_data.MultiBoxMetric()
            m.update(None, param.locals["self"].get_outputs()[:3])
            ce.append(float(m.get()[1][0]))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        contrib.nms_keep.launches = 0
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=1, eval_metric=metric, optimizer="sgd",
                optimizer_params=SSD_OPT,
                arg_params=weights,
                batch_end_callback=batch_end)
        fit_launches = contrib.nms_keep.launches
        fit_ms = [float(v) * 1e3 for v in np.diff([t0] + stamps)]
        peak = torch.cuda.max_memory_allocated()
        batch = it._batch

        def step():
            mod.forward_backward(batch)
            mod.update()

        ms = []
        for i in range(SSD_TRAIN["timed_steps"] + 1):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            if i:
                ms.append((time.perf_counter() - t1) * 1e3)
        timed_launches = contrib.nms_keep.launches - fit_launches
        launches, dev_ms, by_op = ssd_multibox_ms(mt, step)
        outs = mod.get_outputs()[:3]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ssd_data.MultiBoxMetric().update(None, outs)
        metric_ms = (time.perf_counter() - t1) * 1e3
        med = float(np.median(ms))
        r = {"batch": b, "ce": ce, "fit_step_ms": fit_ms, "step_ms": med,
             "step_ms_all": ms, "images_per_s": b / (med / 1e3),
             "peak_share": SSD_FLOPS_PER_IMAGE * b / (med / 1e3)
             / PEAK_OPS_PER_S[torch.float32],
             "launches": launches, "device_ms": dev_ms,
             "busy_share": dev_ms / med, "multibox_ms": by_op,
             "metric_host_ms": metric_ms, "peak_memory": int(peak),
             "nms_launches": fit_launches + timed_launches,
             "steps": len(stamps) + len(ms) + 1,
             "train_metric": dict(metric.get_name_value())}
        out[b] = r
        log("  [%s] B=%d: CE over %d steps %s; fit steps ms %s"
            % (card, b, len(ce), [round(v, 4) for v in ce],
               [round(v, 1) for v in fit_ms]))
        log("  [%s] B=%d: step %.2f ms (median of %d), %.1f images/s, %.1f "
            "%% of 67 TFLOP/s at %.0f GFLOP an image; %d kernel launches, "
            "%.2f ms of device time (busy %.1f %%); device ms of "
            "MultiBoxTarget %.3f and MultiBoxDetection %.3f; "
            "MultiBoxMetric's host copy and numpy %.2f ms; peak memory "
            "%.2f GB" % (card, b, med, len(ms), r["images_per_s"],
                         100 * r["peak_share"], SSD_FLOPS_PER_IMAGE / 1e9,
                         launches, dev_ms, 100 * dev_ms / med,
                         by_op.get("MultiBoxTarget", float("nan")),
                         by_op.get("MultiBoxDetection", float("nan")),
                         metric_ms, peak / 1e9))
        if not np.all(np.isfinite(ce)) or not ce[-1] < ce[0]:
            raise AssertionError("ssd B=%d: CE did not fall: %s" % (b, ce))
        if fit_launches != SSD_TRAIN["fall_steps"] or \
                timed_launches != len(ms) + 1:
            raise AssertionError(
                "ssd B=%d: multibox_nms launched %d times in %d fit steps "
                "and %d in %d timed ones: once a step expected"
                % (b, fit_launches, SSD_TRAIN["fall_steps"], timed_launches,
                   len(ms) + 1))
        if b == cfg["batch"]:
            trained = mod.get_params()[0]
        del mod
        torch.cuda.empty_cache()
    return out, trained


def ssd_eval(mt, contrib, ssd_data, params, seed, card, batch_size=None,
             nms_topk=None, num_batches=SSD_EVAL, it=None):
    """get_symbol at B=32 (or ``batch_size``) and nms_topk 400 (or
    ``nms_topk``) through Module.forward(is_train=False) on gpu(0) with
    the trained weights over ``num_batches`` batches of held-out synthetic
    images (or every batch of the iterator ``it``): the detections on the
    kernel route equal the plain route's (the sweep's plain version on the
    card) bit for bit, one kernel launch a batch; MApMetric's host ms."""
    cfg = SSD
    batch_size = batch_size or cfg["batch"]
    nms_topk = nms_topk or cfg["nms_topk"]
    shape = (3, cfg["data_shape"], cfg["data_shape"])
    if it is None:
        it = ssd_data.SynthDetIter(batch_size, shape, cfg["num_classes"],
                                   num_batches=num_batches, seed=seed + 77)
    batches = list(it)
    mod = mt.mod.Module(mt.models.ssd.get_symbol(
        num_classes=cfg["num_classes"], num_scales=cfg["num_scales"],
        network=cfg["network"], nms_topk=nms_topk), label_names=("label",),
        context=mt.gpu(0))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             for_training=False)
    mod.set_params(params, {}, allow_missing=True)
    kernel = contrib.nms_keep
    metric = ssd_data.MApMetric()
    dets, fwd_ms, map_ms = [], [], []
    kernel.launches = 0
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward(batch, is_train=False)
        outs = mod.get_outputs()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metric.update(batch.label, outs)
        map_ms.append((time.perf_counter() - t1) * 1e3)
        fwd_ms.append((t1 - t0) * 1e3)
        dets.append(outs[0]._data.clone())
    launches = kernel.launches

    def plain(boxes, scores, cls, thresh, force=False):
        return contrib.nms_keep_reference(boxes, scores, cls, thresh, force)

    contrib.nms_keep = plain
    try:
        for batch, det in zip(batches, dets):
            mod.forward(batch, is_train=False)
            ref = mod.get_outputs()[0]._data
            if not torch.equal(det, ref):
                raise AssertionError(
                    "ssd eval: the kernel route's detections differ from "
                    "the plain route's in %d entries"
                    % int((det != ref).sum()))
    finally:
        contrib.nms_keep = kernel
    valid = float((dets[0][..., 0] >= 0).sum(dim=1).float().mean())
    log("  [%s] eval B=%d, nms_topk %d: %d batches, forward %.2f ms "
        "(median), detections == the plain route's bit for bit, %.1f kept "
        "an image; MApMetric host %.2f ms a batch; mAP %.4f; multibox_nms "
        "launches %d"
        % (card, batch_size, nms_topk, len(batches),
           float(np.median(fwd_ms)), valid, float(np.median(map_ms)),
           metric.get()[1], launches))
    if launches != len(batches):
        raise AssertionError("ssd eval: multibox_nms launched %d times in %d "
                             "batches" % (launches, len(batches)))
    return {"launches": launches, "forward_ms": fwd_ms, "map_host_ms": map_ms,
            "map": metric.get()[1], "kept_per_image": valid}


def phase_ssd(mt, seed, card):
    """Phase 11: BASELINE config 5, the SSD detector (see the module
    docstring)."""
    from mxtpu_torch.models import ssd_data
    from mxtpu_torch.ops import contrib
    cfg = SSD
    mod = mt.mod.Module(mt.models.ssd.get_symbol_train(
        num_classes=cfg["num_classes"], num_scales=cfg["num_scales"],
        network=cfg["network"]), label_names=("label",), context=mt.cpu())
    mod.bind(data_shapes=[("data", (1, 3, cfg["data_shape"],
                                    cfg["data_shape"]))],
             label_shapes=[("label", (1, 8, 5))])
    np.random.seed(seed)
    mod.init_params(mt.init.Xavier())
    weights = mod.get_params()[0]
    n_params = sum(int(v.size) for v in weights.values())
    log("  vgg16_reduced SSD at %dx%d, %d classes, %d scales: %.2f M "
        "parameters (Xavier, numpy seed %d)"
        % (cfg["data_shape"], cfg["data_shape"], cfg["num_classes"],
           cfg["num_scales"], n_params / 1e6, seed))
    del mod
    res = {"parameters": n_params}
    res["nms"] = ssd_nms_checks(mt, contrib, ssd_data, weights, seed, card)
    res["first_step"] = ssd_first_step_gate(mt, contrib, ssd_data, weights,
                                            seed, card)
    res["training"], trained = ssd_training(mt, contrib, ssd_data, weights,
                                            seed, card)
    res["eval"] = ssd_eval(mt, contrib, ssd_data, trained, seed, card)
    # the op's default nms_topk: every anchor a candidate
    res["eval_all_anchors"] = ssd_eval(
        mt, contrib, ssd_data, trained, seed, card,
        batch_size=SSD_ALL_ANCHORS_BATCH, nms_topk=-1, num_batches=1)
    res["gate_twin"] = ssd_gate_twin(mt, ssd_data, card)
    res["launches"] = {"ssd_training":
                       res["training"][cfg["batch"]]["nms_launches"]
                       + res["training"][cfg["small_batch"]]["nms_launches"],
                       "ssd_eval": res["eval"]["launches"],
                       "ssd_eval_all_anchors":
                       res["eval_all_anchors"]["launches"]}
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- phase 12
def wide_turns(att, parent, q, k, v, out, g, lse, scale, iters):
    """Another tree's wide pair (``parent``: ParentKernels) and this tree's
    on the same causal inputs: the largest difference of their forwards'
    outputs and of their gradients (scaled as rel_err), then each pair
    timed in turns (parent, this, this, parent), the forward over
    ``iters[0]`` calls a time and the backward over ``iters[1]``. Logged;
    returns the row."""
    pf, pb = (parent.kernels[n] for n in (att.WIDE_KERNEL,
                                          att.WIDE_BWD_KERNEL))
    tf, tb = (att._kernel(n) for n in (att.WIDE_KERNEL, att.WIDE_BWD_KERNEL))
    args = (q, k, v, out, g, lse, True, scale)
    diff = abs_err(att._launch(pf, q, k, v, True, scale), out)
    bwd_diff = max(rel_err(a, w) for a, w in zip(
        att._launch_bwd(pb, *args), att._launch_bwd(tb, *args)))
    p_ms, t_ms = in_turns(lambda: att._launch(pf, q, k, v, True, scale),
                          lambda: att._launch(tf, q, k, v, True, scale),
                          iters[0])
    pb_ms, tb_ms = in_turns(lambda: att._launch_bwd(pb, *args),
                            lambda: att._launch_bwd(tb, *args), iters[1])
    log("    in turns with %s (parent, this, this, parent): forward %.4f, "
        "%.4f, %.4f, %.4f ms (parent/this %.2f), max abs diff %.3e; "
        "backward %.4f, %.4f, %.4f, %.4f ms (parent/this %.2f), scaled diff "
        "%.3e" % (parent.csrc, p_ms[0], t_ms[0], t_ms[1], p_ms[1],
                  sum(p_ms) / sum(t_ms), diff, pb_ms[0], tb_ms[0], tb_ms[1],
                  pb_ms[1], sum(pb_ms) / sum(tb_ms), bwd_diff))
    return dict(parent=parent.csrc, parent_ms=p_ms, this_ms=t_ms,
                max_abs_diff=diff, bwd_parent_ms=pb_ms, bwd_this_ms=tb_ms,
                bwd_scaled_diff=bwd_diff)


def flash_wide(mt, att, gen, parents=()):
    """The wide pair (``csrc/flash_attn_wide.cu``, head dims above 128,
    unpadded) against the plain versions on the card: at D in WIDE_DIMS,
    causal and not, T < S and T > S with S and T not multiples of the
    64-row and 32-key tiles, NaN stored past every tensor's end, float32
    and bfloat16: the forward within TOL, its lse within LSE_TOL, the
    backward within BWD_TOL of max(1, |plain|) and a second call
    bit-identical. Then CUDA-event times at WIDE_TIMED (causal) of the
    forward and the backward beside the plain versions, SDPA's forward and
    backward (the library yardsticks), the bounds as phases 3 and 3c count
    them and the pair's route figure (wide_route_flops at the type's
    tensor-core peak, its column blocks as wide_tiling reports them); the
    same at B=1 (the blocks against the SMs); with ``parents``, each other
    tree's wide pair and this tree's in turns (wide_turns). Last, the forward and the backward at
    D in WIDE_WIDER at WIDE_TIMED's B, H and T, held to the plain versions
    and timed beside their bounds and route figures, which count the
    column blocks' recompute of the scores, and at D <= 512 (where the
    earlier CUDA-core pair stopped) in turns with each parent's. Returns {"worst": ...,
    "timed": [rows], "wider": [rows]}."""
    F = torch.nn.functional
    cases = [(b, h, t, s, d, causal) for d in WIDE_DIMS
             for causal in (False, True)
             for b, h, t, s in ((2, 3, 200, 333), (1, 2, 333, 129))]
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for b, h, t, s, d, causal in cases:
            q, k, v, g = bwd_inputs(b, h, t, s, d, dtype, gen, nan_tail=64)
            got, got_lse = att._flash_cuda(q, k, v, causal, d ** -0.5,
                                           want_lse=True)
            want, lse = att.flash_attention_reference(q, k, v, causal=causal,
                                                      return_lse=True)
            fin = torch.isfinite(lse)
            lse_err = (got_lse[fin] - lse[fin]).abs().max().item() \
                if bool(fin.any()) else 0.0
            grads = att.flash_attention_backward(q, k, v, want, g, lse,
                                                 causal=causal)
            again = att.flash_attention_backward(q, k, v, want, g, lse,
                                                 causal=causal)
            ref = att.flash_attention_backward_reference(
                q, k, v, want, g, lse, causal=causal)
            torch.cuda.synchronize()
            err, bwd = abs_err(got, want), max(rel_err(a, w) for a, w in
                                               zip(grads, ref))
            same = all(torch.equal(a, r) for a, r in zip(grads, again))
            log("  flash wide %-8s B=%d H=%d T=%d S=%d D=%d causal=%d  "
                "fwd err %.3e, lse err %.3e, bwd scaled err %.3e, repeat %s"
                % (name, b, h, t, s, d, causal, err, lse_err, bwd,
                   "bit-identical" if same else "DIFFERS"))
            if not err <= TOL[dtype] or not lse_err <= LSE_TOL[dtype] or \
                    not torch.equal(torch.isfinite(got_lse), fin) or \
                    not bwd <= BWD_TOL[dtype] or not same:
                raise AssertionError(
                    "wide flash kernels disagree with their plain versions "
                    "at %s: fwd %r, lse %r, bwd %r, repeat %s"
                    % ((b, h, t, s, d, causal, name), err, lse_err, bwd,
                       same))
            w = worst.setdefault(name, {"fwd": 0.0, "bwd": 0.0})
            w["fwd"], w["bwd"] = max(w["fwd"], err), max(w["bwd"], bwd)
    timed = []
    b, h, t, d = WIDE_TIMED
    scale = d ** -0.5
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, k, v, g = (torch.randn(b, h, t, d, device="cuda", generator=gen)
                      .to(dtype) for _ in range(4))
        out, lse = att._flash_cuda(q, k, v, True, scale, want_lse=True)
        want = att.flash_attention_reference(q, k, v, causal=True)
        grads = att.flash_attention_backward(q, k, v, out, g, lse,
                                             causal=True)
        ref = att.flash_attention_backward_reference(q, k, v, out, g, lse,
                                                     causal=True)
        err = abs_err(out, want)
        bwd_err = max(abs_err(a, r) for a, r in zip(grads, ref))
        bwd_scaled = max(rel_err(a, r) for a, r in zip(grads, ref))
        del want, grads, ref
        row = dict(dtype=name, B=b, H=h, T=t, D=d, max_abs_err=err,
                   bwd_max_abs_err=bwd_err, bwd_scaled_err=bwd_scaled)
        row["ms"] = cuda_ms(lambda: att.flash_attention(q, k, v,
                                                        causal=True), 10)
        row["plain_ms"] = cuda_ms(lambda: att.flash_attention_reference(
            q, k, v, causal=True), 3)
        row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 10)
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            b, h, t, t, d, True, dtype)
        tiling = wide_tiling(mt, d, dtype)
        row["route_ms"] = _tensor_core_ms(
            wide_route_flops(b, h, t, t, d, True, tiling["blocks"]), dtype)
        row["bwd_ms"] = cuda_ms(lambda: att.flash_attention_backward(
            q, k, v, out, g, lse, causal=True), 5)
        row["bwd_plain_ms"] = cuda_ms(
            lambda: att.flash_attention_backward_reference(
                q, k, v, out, g, lse, causal=True), 2)
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        row["bwd_library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            o_lib, (qs, ks, vs), g, retain_graph=True), 5)
        del o_lib, qs, ks, vs
        row["bwd_bound_ms"], row["bwd_bound_by"] = backward_bound_ms(
            b, h, t, t, d, True, dtype)
        row["bwd_route_ms"] = _tensor_core_ms(wide_route_flops(
            b, h, t, t, d, True, wide_tiling(mt, d, dtype, True)["blocks"],
            backward=True), dtype)
        log("  flash wide %s causal B=%d H=%d T=S=%d D=%d: forward %.4f ms "
            "(plain %.4f, sdpa %.4f, bound %.4f %s, route %.4f: %.1f%% of "
            "the bound), err %.3e; backward %.4f ms (plain %.4f, sdpa bwd "
            "%.4f, bound %.4f %s, route %.4f: %.1f%% of the bound), scaled "
            "err %.3e" % (name, b, h, t, d, row["ms"], row["plain_ms"],
                          row["library_ms"], row["bound_ms"], row["bound_by"],
                          row["route_ms"], 100.0 * row["bound_ms"] / row["ms"],
                          err, row["bwd_ms"], row["bwd_plain_ms"],
                          row["bwd_library_ms"], row["bwd_bound_ms"],
                          row["bwd_bound_by"], row["bwd_route_ms"],
                          100.0 * row["bwd_bound_ms"] / row["bwd_ms"],
                          bwd_scaled))
        if not err <= TOL[dtype] or not bwd_scaled <= BWD_TOL[dtype]:
            raise AssertionError("wide flash disagrees at the timed shape: "
                                 "%r, %r (%s)" % (err, bwd_scaled, name))
        # B = 1: the forward's blocks against the SMs, one a SM
        q1, k1, v1, g1 = (x[:1].contiguous() for x in (q, k, v, g))
        o1, l1 = att._flash_cuda(q1, k1, v1, True, scale, want_lse=True)
        row["B1"] = dict(
            blocks=h * -(-t // tiling["rows"]) * tiling["blocks"], sms=sms,
            ms=cuda_ms(lambda: att.flash_attention(q1, k1, v1, causal=True),
                       10),
            bwd_ms=cuda_ms(lambda: att.flash_attention_backward(
                q1, k1, v1, o1, g1, l1, causal=True), 5))
        log("    B=1: %d blocks on %d SMs; forward %.4f ms, backward %.4f ms"
            % (row["B1"]["blocks"], sms, row["B1"]["ms"],
               row["B1"]["bwd_ms"]))
        row["turns"] = [
            wide_turns(att, parent, q, k, v, out, g, lse, scale, (10, 5))
            for parent in parents if att.WIDE_KERNEL in parent.kernels]
        del q, k, v, g, out, lse, q1, k1, v1, g1, o1, l1
        timed.append(row)
    wider = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for d2 in WIDE_WIDER:
            q, k, v, g = (torch.randn(b, h, t, d2, device="cuda",
                                      generator=gen).to(dtype)
                          for _ in range(4))
            out, lse = att._flash_cuda(q, k, v, True, d2 ** -0.5,
                                       want_lse=True)
            err = abs_err(out, att.flash_attention_reference(q, k, v,
                                                             causal=True))
            bwd = max(rel_err(a, r) for a, r in zip(
                att.flash_attention_backward(q, k, v, out, g, lse,
                                             causal=True),
                att.flash_attention_backward_reference(q, k, v, out, g, lse,
                                                       causal=True)))
            blocks = wide_tiling(mt, d2, dtype)["blocks"]
            bwd_blocks = wide_tiling(mt, d2, dtype, True)["blocks"]
            row = dict(dtype=name, B=b, H=h, T=t, D=d2, max_abs_err=err,
                       bwd_scaled_err=bwd, column_blocks=blocks)
            row["ms"] = cuda_ms(lambda: att.flash_attention(q, k, v,
                                                            causal=True), 5)
            row["bwd_ms"] = cuda_ms(lambda: att.flash_attention_backward(
                q, k, v, out, g, lse, causal=True), 3)
            row["bound_ms"], row["bound_by"] = attention_bound_ms(
                b, h, t, t, d2, True, dtype)
            row["bwd_bound_ms"], row["bwd_bound_by"] = backward_bound_ms(
                b, h, t, t, d2, True, dtype)
            row["route_ms"] = _tensor_core_ms(
                wide_route_flops(b, h, t, t, d2, True, blocks), dtype)
            row["bwd_route_ms"] = _tensor_core_ms(wide_route_flops(
                b, h, t, t, d2, True, bwd_blocks, backward=True), dtype)
            log("  flash wide %s causal B=%d H=%d T=S=%d D=%d (%d column "
                "blocks): forward %.4f ms (bound %.4f %s, route %.4f: %.2fx "
                "the forward's products), err %.3e; backward %.4f ms (bound "
                "%.4f %s, route %.4f: %.2fx the 5 products), scaled err %.3e"
                % (name, b, h, t, d2, row["column_blocks"], row["ms"],
                   row["bound_ms"], row["bound_by"], row["route_ms"],
                   wide_route_flops(b, h, t, t, d2, True, blocks)
                   / attention_flops(b, h, t, t, d2, True), err,
                   row["bwd_ms"], row["bwd_bound_ms"], row["bwd_bound_by"],
                   row["bwd_route_ms"],
                   wide_route_flops(b, h, t, t, d2, True, bwd_blocks,
                                    backward=True)
                   / backward_flops(b, h, t, t, d2, True), bwd))
            if not err <= TOL[dtype] or not bwd <= BWD_TOL[dtype]:
                raise AssertionError("wide flash disagrees at D=%d: %r, %r "
                                     "(%s)" % (d2, err, bwd, name))
            row["turns"] = [
                wide_turns(att, parent, q, k, v, out, g, lse, d2 ** -0.5,
                           (5, 3))
                for parent in parents
                if att.WIDE_KERNEL in parent.kernels and d2 <= 512]
            del q, k, v, g, out, lse
            wider.append(row)
    return {"worst": worst, "timed": timed, "wider": wider}


def mc_hinge_grad(scores, labels):
    """examples/module/python_loss.py's Crammer-Singer multiclass hinge
    subgradient, in numpy."""
    scores = scores.asnumpy()
    labels = labels.asnumpy().astype(np.int64)
    n, _ = scores.shape
    grad = np.zeros_like(scores)
    for i in range(n):
        margin = 1.0 + scores[i] - scores[i, labels[i]]
        margin[labels[i]] = 0.0
        worst = margin.argmax()
        if margin[worst] > 0:
            grad[i, labels[i]] -= 1.0
            grad[i, worst] += 1.0
    return grad / n


def python_loss_data(n, rng, classes=5, dim=32):
    """examples/module/python_loss.py's ``synth``: noisy binary
    prototypes, one a class."""
    protos = (rng.rand(classes, dim) > 0.5).astype("f4")
    y = rng.randint(0, classes, n)
    x = protos[y] + rng.randn(n, dim).astype("f4") * 0.25
    return x, y.astype("f4")


def python_loss_twin(mt, ctx, epochs=8, batch_size=32, num_examples=1024,
                     seed=4, arg_params=None):
    """The port's twin of examples/module/python_loss.py (which imports
    mxtpu): ``SequentialModule(Module(MLP) on ctx, PythonLossModule(
    grad_func=mc_hinge_grad))`` fit with SGD lr 0.5, momentum 0.9, Xavier
    (or ``arg_params``), on the example's data from ``seed``. Returns the
    validation accuracy."""
    np.random.seed(seed)
    x, y = python_loss_data(num_examples, np.random.RandomState(seed))
    nval = num_examples // 4
    train = mt.io.NDArrayIter(x[:-nval], y[:-nval], batch_size, shuffle=True,
                              label_name="softmax_label")
    val = mt.io.NDArrayIter(x[-nval:], y[-nval:], batch_size,
                            label_name="softmax_label")
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=64,
                                name="fc1")
    net = mt.sym.Activation(net, act_type="relu")
    net = mt.sym.FullyConnected(net, num_hidden=5, name="fc2")
    quiet = logging.getLogger("chip_smoke.python_loss")
    quiet.setLevel(logging.WARNING)
    mod = mt.mod.SequentialModule(logger=quiet)
    mod.add(mt.mod.Module(net, context=ctx, label_names=(), logger=quiet),
            auto_wiring=True)
    mod.add(mt.mod.PythonLossModule(grad_func=mc_hinge_grad, logger=quiet),
            take_labels=True, auto_wiring=True)
    mod.fit(train, eval_data=val, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
            eval_metric="acc", initializer=mt.initializer.Xavier(),
            arg_params=arg_params)
    val.reset()
    return mod.score(val, mt.metric.Accuracy())[0][1]


def _quiet_logger():
    log_ = logging.getLogger("chip_smoke.surface")
    log_.setLevel(logging.WARNING)
    return log_


def surface_resnet(mt, epi, seed, card):
    """ResNet-50 v2 at 224x224 (seeded weights and statistics) over
    SURFACE["images"] seeded images in an NDArrayIter at B=
    SURFACE["batch"]: ``Module.predict`` against the concatenation of
    ``iter_predict``'s outputs (bit for bit) and against the same
    Module's unfused walk (within 1e-5), the epilogue launched at its 50
    sites a batch, images/s; then the feature extractor
    (``get_internals`` of the flatten output in a new Module over the
    same params) against what a Monitor with that pattern and a
    whole-array stat captures in the full net's forward."""
    sym = mt.models.get_resnet(**RESNET)
    params = resnet_params(sym, seed)
    args, auxs = mt.model.split_params(
        {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params.items()}, "")
    n, b = SURFACE["images"], SURFACE["batch"]
    rng = np.random.default_rng(seed + 12)
    x = rng.standard_normal((n,) + RESNET["image_shape"], dtype=np.float32)
    y = rng.integers(0, RESNET["num_classes"], n).astype(np.float32)
    it = mt.io.NDArrayIter(x, y, batch_size=b)
    quiet = _quiet_logger()
    mod = mt.mod.Module(sym, context=mt.gpu(0), logger=quiet)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             for_training=False)
    mod.set_params(args, auxs)
    mod.predict(it, num_batch=1)  # cuDNN's first calls
    torch.cuda.synchronize()
    epi.bn_apply_relu_add.launches = 0  # count the main path alone
    t0 = time.perf_counter()
    pred = mod.predict(it)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = epi.bn_apply_relu_add.launches
    batches = -(-n // b)
    parts = [outs[0]._data.clone() for outs, _, _ in mod.iter_predict(it)]
    same = torch.equal(pred._data, torch.cat(parts))
    # the same Module's unfused walk (what a sampled Monitor batch runs)
    ex = mod._exec_group.execs[0]
    unfused = []
    it.reset()
    for batch in it:
        mod._exec_group.load_batch(batch)
        raw = {k: a._data for k, a in ex.arg_dict.items()}
        aux = {k: a._data for k, a in ex.aux_dict.items()}
        with torch.inference_mode():
            outs, _ = ex._run(False, fuse=False)(raw, aux, ex._device)
        unfused.append(outs[0][:b - (batch.pad or 0)].clone())
    unfused_err = float((pred._data - torch.cat(unfused)).abs().max())
    rows = pred._data.double().sum(dim=1)
    log("  [%s] ResNet-50 v2 predict: %d images at B=%d in %.3f s, %.1f "
        "images/s; epilogue launches %d (%d a batch); predict == "
        "iter_predict: %s; fused vs unfused walk max abs err %.3e; rows sum "
        "to 1 +- %.2e" % (card, n, b, secs, n / secs, launches,
                          launches // batches, same, unfused_err,
                          float((rows - 1).abs().max())))
    if pred.shape != (n, RESNET["num_classes"]) or not same:
        raise AssertionError("predict %s differs from iter_predict's "
                             "batches" % (pred.shape,))
    if launches != RESNET_SITES * batches:
        raise AssertionError("predict launched the epilogue %d times, not "
                             "%d x %d" % (launches, RESNET_SITES, batches))
    if not unfused_err <= 1e-5 or not bool(torch.isfinite(pred._data).all()):
        raise AssertionError("fused predict vs the unfused walk: %g"
                             % unfused_err)

    feat = sym.get_children()[0].get_children()[0]  # fc1's data
    feat_name = feat.list_outputs()[0]
    fmod = mt.mod.Module(feat, label_names=None, context=mt.gpu(0),
                         logger=quiet)
    fmod.bind(data_shapes=[("data", (b,) + RESNET["image_shape"])],
              for_training=False)
    fmod.set_params(args, auxs, allow_extra=True)
    captured = []
    mon = mt.monitor.Monitor(
        1, stat_func=lambda arr: captured.append(arr._data.clone()) or 0.0,
        pattern=feat_name + "$")
    mod.install_monitor(mon)  # the full net
    batch = mt.io.DataBatch([mt.nd.array(x[:b], ctx=mt.cpu())],
                            [mt.nd.array(y[:b], ctx=mt.cpu())])
    fmod.forward(batch, is_train=False)  # the extractor, unsampled: fused
    fused_feat = fmod.get_outputs()[0]._data.clone()
    mon.install(fmod._exec_group.execs[0])  # the extractor, sampled too
    mon.tic()
    mod.forward(batch, is_train=False)
    fmod.forward(batch, is_train=False)
    sampled_feat = fmod.get_outputs()[0]._data.clone()
    n_stats = len(mon.toc())
    torch.cuda.synchronize()
    bitwise = len(captured) >= 1 and torch.equal(captured[0], sampled_feat)
    fused_err = rel_err(fused_feat, captured[0])
    log("  feature extractor %s %s: == the Monitor's capture in the full "
        "net's sampled forward, bit for bit: %s; the extractor's own fused "
        "forward vs that capture, error / max(1, |x|) %.3e (%d stats)"
        % (feat_name, tuple(sampled_feat.shape), bitwise, fused_err,
           n_stats))
    if not bitwise or not fused_err <= 1e-5:
        raise AssertionError("feature extractor differs from the Monitor's "
                             "capture: bitwise %s, fused %g"
                             % (bitwise, fused_err))
    return dict(images_per_s=n / secs, predict_s=secs, launches=launches,
                batches=batches, unfused_err=unfused_err,
                feature=feat_name, feature_fused_err=fused_err)


def _resnet_trunk_head(mt):
    """(full ResNet-50 v2, its trunk up to the flatten, a head of fc1 and
    SoftmaxOutput over the flatten's features)."""
    sym = mt.models.get_resnet(**RESNET)
    trunk = sym.get_children()[0].get_children()[0]
    head = mt.sym.FullyConnected(mt.sym.Variable("data"),
                                 num_hidden=RESNET["num_classes"],
                                 name="fc1")
    return sym, trunk, mt.sym.SoftmaxOutput(head, name="softmax")


def _train_modules(mt, mod, args, auxs, b):
    mod.bind(data_shapes=[("data", (b,) + RESNET["image_shape"])],
             label_shapes=[("softmax_label", (b,))])
    mod.init_params(arg_params=args, aux_params=auxs, allow_missing=False,
                    allow_extra=True)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": SURFACE["lr"], "momentum": SURFACE["momentum"]})


def surface_sequential(mt, seed, card):
    """ResNet-50 v2's trunk (up to the flatten) and a fc1+SoftmaxOutput
    head as a SequentialModule (the head binds with inputs_need_grad, so
    its input gradient is the trunk's head gradient), SURFACE["seq_steps"]
    SGD steps at B=SURFACE["seq_batch"] with TF32 off and cuDNN
    deterministic, against the single Module from the same weights: every
    weight and statistic within 1e-5 of max(1, |w|)."""
    sym, trunk, head = _resnet_trunk_head(mt)
    params = resnet_params(sym, seed)
    args, auxs = mt.model.split_params(
        {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params.items()}, "")
    b = SURFACE["seq_batch"]
    rng = np.random.default_rng(seed + 13)
    batches = [mt.io.DataBatch(
        [mt.nd.array(rng.standard_normal((b,) + RESNET["image_shape"],
                                         dtype=np.float32), ctx=mt.cpu())],
        [mt.nd.array(rng.integers(0, RESNET["num_classes"], b)
                     .astype(np.float32), ctx=mt.cpu())])
        for _ in range(SURFACE["seq_steps"])]
    quiet = _quiet_logger()
    single = mt.mod.Module(sym, context=mt.gpu(0), logger=quiet)
    seq = mt.mod.SequentialModule(logger=quiet)
    seq.add(mt.mod.Module(trunk, label_names=None, context=mt.gpu(0),
                          logger=quiet))
    seq.add(mt.mod.Module(head, context=mt.gpu(0), logger=quiet),
            take_labels=True, auto_wiring=True)
    ms = {}
    with DeterministicCudnn():
        for name, mod in (("single", single), ("sequential", seq)):
            _train_modules(mt, mod, args, auxs, b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for batch in batches:
                mod.forward_backward(batch)
                mod.update()
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3 / len(batches)
    got, want = seq.get_params(), single.get_params()
    dist = max(scaled_dist(got[0], want[0]), scaled_dist(got[1], want[1]))
    moved = scaled_dist(want[0], args)
    log("  [%s] SequentialModule(trunk, fc1+softmax) vs the single Module, "
        "%d SGD steps at B=%d: weights and statistics within %.3e of "
        "max(1, |w|) (the steps moved them %.3e); step ms %.2f vs %.2f"
        % (card, len(batches), b, dist, moved, ms["sequential"],
           ms["single"]))
    if not dist <= 1e-5 or not moved > 1e-4:
        raise AssertionError("SequentialModule differs from the single "
                             "Module: %g (moved %g)" % (dist, moved))
    return dict(max_scaled_diff=dist, moved=moved, step_ms=ms)


def surface_monitor_step(mt, seed, card):
    """One ResNet-50 v2 SGD step at B=SURFACE["seq_batch"] with a Monitor
    (interval 1, every tensor, the mean absolute value as a stat of its
    own: the per-op path; the default stat takes the device adapter,
    phase 22) installed, against the
    same step unmonitored (the fused update), cuDNN deterministic: as
    many stats as the graph's visible op outputs plus its outputs, the
    loss and the weights bit for bit; each step's ms printed."""
    sym = mt.models.get_resnet(**RESNET)
    params = resnet_params(sym, seed)
    args, auxs = mt.model.split_params(
        {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params.items()}, "")
    b = SURFACE["seq_batch"]
    rng = np.random.default_rng(seed + 14)
    batch = mt.io.DataBatch(
        [mt.nd.array(rng.standard_normal((b,) + RESNET["image_shape"],
                                         dtype=np.float32), ctx=mt.cpu())],
        [mt.nd.array(rng.integers(0, RESNET["num_classes"], b)
                     .astype(np.float32), ctx=mt.cpu())])
    internals = sym.get_internals().list_outputs()
    n_vars = len(sym.list_inputs())
    expect = len(internals) - n_vars + len(sym.list_outputs())
    res = {}
    with DeterministicCudnn():
        for monitored in (False, True):
            mod = mt.mod.Module(sym, context=mt.gpu(0),
                                logger=_quiet_logger())
            _train_modules(mt, mod, args, auxs, b)
            mon = None
            if monitored:
                mon = mt.monitor.Monitor(
                    1, stat_func=lambda x: abs(x.asnumpy()).mean())
                mod.install_monitor(mon)
                mon.tic()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.forward_backward(batch)
            mod.update()
            stats = mon.toc() if mon else []
            torch.cuda.synchronize()
            res[monitored] = dict(
                ms=(time.perf_counter() - t0) * 1e3, stats=len(stats),
                fused=mod._fused is not None,
                out=mod.get_outputs()[0]._data.clone(),
                params=mod.get_params())
    plain, mon_ = res[False], res[True]
    same_out = torch.equal(plain["out"], mon_["out"])
    same_w = all(torch.equal(mon_["params"][i][k]._data,
                             plain["params"][i][k]._data)
                 for i in (0, 1) for k in plain["params"][i])
    log("  [%s] install_monitor on a ResNet-50 step at B=%d: %d stats (%d "
        "visible op outputs + %d graph output); outputs bit for bit %s, "
        "weights and statistics bit for bit %s; fused step armed: "
        "unmonitored %s, monitored %s; step ms monitored %.1f vs "
        "unmonitored %.1f" % (card, b, mon_["stats"],
                              expect - len(sym.list_outputs()),
                              len(sym.list_outputs()), same_out, same_w,
                              plain["fused"], mon_["fused"], mon_["ms"],
                              plain["ms"]))
    if mon_["stats"] != expect or not same_out or not same_w or \
            mon_["fused"] or not plain["fused"]:
        raise AssertionError("monitored step: %d stats (want %d), outputs "
                             "%s, weights %s" % (mon_["stats"], expect,
                                                 same_out, same_w))
    return dict(stats=mon_["stats"], monitored_ms=mon_["ms"],
                unmonitored_ms=plain["ms"])


def _flash_counts(att):
    return (att.flash_attention.launches, att.flash_attention.wide_launches,
            att.flash_attention_backward.launches,
            att.flash_attention_backward.wide_launches)


def _zero_flash_counts(att):
    att.flash_attention.launches = att.flash_attention.wide_launches = 0
    att.flash_attention_backward.launches = 0
    att.flash_attention_backward.wide_launches = 0


def surface_lm(mt, att, seed, card):
    """The LM at GPT-2-small widths (phase 4's) through the Predictor:
    ``forward_batch`` at buckets 1 and 4 (3 rows padded), ``reshaped`` to
    4 rows over the same weight tensors (equal to forward_batch's rows
    bit for bit), ``partial_forward`` stepped node by node to the end
    (equal to ``forward`` bit for bit), and a Predictor from
    ``load_checkpoint_predictor`` over a checkpoint the port wrote (its
    ``.params`` bytes) equal to the dict-built one; 12 flash launches a
    forward."""
    import tempfile
    sym = mt.models.get_transformer_lm(**LM)
    sym_json = sym.tojson()
    params = lm_params(sym, seed)
    t = LM["seq_len"]
    rng = np.random.default_rng(seed + 15)
    x4 = rng.integers(0, LM["vocab_size"], (4, t)).astype(np.float32)
    _zero_flash_counts(att)
    pred = mt.Predictor(sym_json, params, ctx=mt.gpu(0),
                        input_shapes={"data": (1, t)}, bucket_sizes=BUCKETS)
    t0 = time.perf_counter()
    one = pred.forward_batch({"data": x4[:1]})[0]
    three = pred.forward_batch({"data": x4[:3]})[0]
    batch_s = time.perf_counter() - t0
    wide = pred.reshaped({"data": (4, t)})
    shares = all(wide._arg_params[k]._data is pred._arg_params[k]._data
                 for k in pred._arg_params)
    wide.forward(data=np.concatenate([x4[:3], np.zeros((1, t), "f4")]))
    rows = wide.get_outputs()[0][:3 * t]
    reshaped_same = np.array_equal(rows, three)
    row0_err = float(np.abs(three[:t] - one).max())
    pred.reshape({"data": (1, t)})
    pred.forward(data=x4[:1])
    full = pred.get_outputs()[0]
    steps, left = 0, pred.num_steps
    while left:
        steps += 1
        left = pred.partial_forward(steps)
    partial_same = np.array_equal(pred.get_outputs()[0], full)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "lm")
        arg_params, _ = mt.model.split_params(
            {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params.items()}, "")
        mt.model.save_checkpoint(prefix, 0, sym, arg_params, {})
        loaded = mt.predict.load_checkpoint_predictor(
            prefix, 0, {"data": (1, t)}, ctx=mt.gpu(0))
    loaded.forward(data=x4[:1])
    loaded_same = np.array_equal(loaded.get_outputs()[0], full)
    torch.cuda.synchronize()
    counts = _flash_counts(att)
    forwards = 2 + 1 + 1 + 1 + 1  # buckets 1, 4; reshaped; forward;
    #                               partial_forward; the loaded Predictor
    sums = np.abs(three.sum(axis=1, dtype=np.float64) - 1).max()
    log("  [%s] LM Predictor: forward_batch at buckets 1 and 4 in %.2f s "
        "(row 0 at bucket 4 vs bucket 1 max abs err %.3e; rows sum to 1 +- "
        "%.1e); reshaped to 4 rows shares the weights %s and equals "
        "forward_batch's rows bit for bit %s; partial_forward over %d nodes "
        "== forward bit for bit %s; load_checkpoint_predictor (.params "
        "bytes) == the dict-built Predictor bit for bit %s; flash launches "
        "%d (%d layers x %d forwards)"
        % (card, batch_s, row0_err, sums, shares, reshaped_same,
           pred.num_steps, partial_same, loaded_same, counts[0],
           LM["num_layers"], forwards))
    if not (shares and reshaped_same and partial_same and loaded_same) or \
            counts != (LM["num_layers"] * forwards, 0, 0, 0) or \
            not row0_err <= 1e-4 or not sums <= 1e-4:
        raise AssertionError("LM Predictor paths disagree: %s, %s, %s, %s, "
                             "launches %s, row0 %g"
                             % (shares, reshaped_same, partial_same,
                                loaded_same, counts, row0_err))
    return dict(flash_launches=counts[0], forwards=forwards,
                num_steps=pred.num_steps, row0_err=row0_err)


class WideSwap:
    """Within ``with WideSwap(att, kernels):`` the wrappers launch the wide
    pair bound in ``kernels`` ({launcher: binding}: another tree's,
    ``ParentKernels.kernels``) in place of this tree's, so that a model
    path can be timed with either pair."""

    def __init__(self, att, kernels):
        self.att, self.kernels = att, kernels
        self.names = (att.WIDE_KERNEL, att.WIDE_BWD_KERNEL)

    def __enter__(self):
        self.saved = {n: self.att._kernel(n) for n in self.names}
        self.att._kernel_fns.update({n: self.kernels[n] for n in self.names})
        return self

    def __exit__(self, *exc):
        self.att._kernel_fns.update(self.saved)


def surface_wide_lm(mt, att, seed, card, parents=()):
    """The transformer LM at WIDE_LM (d_model 1024 over 4 heads: head dim
    256, on the wide pair) served through the Predictor (B=1, one launch
    of the wide forward a layer) and held to a cpu() Predictor (the plain
    attention); then one SGD step through Module (the wide forward with
    its lse and the wide backward, once a layer each), its loss finite.
    Then the served forward's and the SGD step's host ms (to a sync); with
    ``parents``, the same with each other tree's wide pair swapped into the
    wrappers (WideSwap), in WIDE_LM_TURNS["rounds"] rounds of turns:
    parent, this, this, parent, with the spread of the rounds."""
    sym = mt.models.get_transformer_lm(**WIDE_LM)
    sym_json = sym.tojson()
    arg_shapes, _, _ = sym.infer_shape(data=(1, WIDE_LM["seq_len"]))
    rng = np.random.default_rng(seed + 16)
    params = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        w = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        params["arg:" + name] = w + np.float32(name.endswith("_gamma"))
    t = WIDE_LM["seq_len"]
    x, y = lm_batch(seed + 17, 1, t, WIDE_LM["vocab_size"])
    _zero_flash_counts(att)
    pred = mt.Predictor(sym_json, params, ctx=mt.gpu(0),
                        input_shapes={"data": (1, t)})
    pred.forward(data=x)
    out = pred.get_outputs()[0]
    torch.cuda.synchronize()
    served = _flash_counts(att)
    cpu_pred = mt.Predictor(sym_json, params, ctx=mt.cpu(),
                            input_shapes={"data": (1, t)})
    cpu_pred.forward(data=x)
    err = float(np.abs(out - cpu_pred.get_outputs()[0]).max())
    quiet = _quiet_logger()
    mod = mt.mod.Module(sym, context=mt.gpu(0), logger=quiet)
    mod.bind(data_shapes=[("data", (1, t))],
             label_shapes=[("softmax_label", (t,))])
    mod.init_params(arg_params={k[4:]: mt.nd.array(v, ctx=mt.cpu())
                                for k, v in params.items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.01})
    batch = mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                            [mt.nd.array(y, ctx=mt.cpu())])
    _zero_flash_counts(att)
    mod.forward_backward(batch)
    mod.update()
    probs = mod.get_outputs()[0]._data
    torch.cuda.synchronize()
    trained = _flash_counts(att)
    labels = torch.from_numpy(y).long().to(probs.device)
    loss = float(-torch.log(probs[torch.arange(t, device=probs.device),
                                  labels].clamp(min=1e-30)).mean())
    layers = WIDE_LM["num_layers"]
    log("  [%s] LM at head dim %d (%s): served through the Predictor, wide "
        "forward launches %d, vs a cpu() Predictor max abs err %.3e; one SGD "
        "step through Module: wide forward %d, wide backward %d launches, "
        "CE %.4f" % (card, WIDE_LM["d_model"] // WIDE_LM["num_heads"],
                     WIDE_LM, served[1], err, trained[1], trained[3], loss))
    if served != (0, layers, 0, 0) or trained != (0, layers, 0, layers) or \
            not err <= 1e-4 or not np.isfinite(out).all() or \
            not np.isfinite(loss):
        raise AssertionError("the head-dim-256 LM: launches %s / %s, err %g,"
                             " CE %r" % (served, trained, err, loss))
    res = dict(served_launches=served[1], trained_fwd_launches=trained[1],
               trained_bwd_launches=trained[3], cpu_err=err, ce=loss)

    def serve():
        pred.forward(data=x)

    def step():
        mod.forward_backward(batch)
        mod.update()

    res["served_ms"] = host_ms(serve, 1, iters=5, warmup=1)
    res["step_ms"] = host_ms(step, 1, iters=3, warmup=1)
    log("  [%s] the head-dim-256 LM: served forward %.2f ms, SGD step %.2f "
        "ms (host clock to a sync)" % (card, res["served_ms"],
                                       res["step_ms"]))
    res["turns"] = []
    for parent in parents:
        if att.WIDE_KERNEL not in parent.kernels:
            continue
        turn = {"parent": parent.csrc}
        for label, fn in (("served", serve), ("step", step)):
            iters, rounds = WIDE_LM_TURNS[label], []
            for _ in range(WIDE_LM_TURNS["rounds"]):
                with WideSwap(att, parent.kernels):
                    p1 = host_ms(fn, 1, iters=iters, warmup=1)
                t1 = host_ms(fn, 1, iters=iters, warmup=1)
                t2 = host_ms(fn, 1, iters=iters, warmup=1)
                with WideSwap(att, parent.kernels):
                    p2 = host_ms(fn, 1, iters=iters, warmup=1)
                rounds.append(([p1, p2], [t1, t2]))
            this = [x for _, t in rounds for x in t]
            par = [x for p, _ in rounds for x in p]
            ratio = [sum(p) / sum(t) for p, t in rounds]
            turn[label] = dict(
                rounds=rounds, this_median=float(np.median(this)),
                parent_median=float(np.median(par)),
                ratio_median=float(np.median(ratio)), ratio_min=min(ratio),
                ratio_max=max(ratio))
            log("    %s in turns with %s's wide pair, %d rounds (parent, "
                "this, this, parent; median of %d calls each): this %.2f ms "
                "(%.2f-%.2f), parent %.2f ms (%.2f-%.2f); parent/this a "
                "round: median %.4f, %.4f-%.4f"
                % (label, parent.csrc, len(rounds), iters,
                   turn[label]["this_median"], min(this), max(this),
                   turn[label]["parent_median"], min(par), max(par),
                   turn[label]["ratio_median"], min(ratio), max(ratio)))
        res["turns"].append(turn)
    return res


def phase_surface(mt, att, epi, seed, card, parents=()):
    """The inference and inspection surface (phase 12); see the module
    docstring. ``parents``: surface_wide_lm's."""
    res = {"resnet": surface_resnet(mt, epi, seed, card),
           "sequential": surface_sequential(mt, seed, card),
           "monitor_step": surface_monitor_step(mt, seed, card)}
    t0 = time.perf_counter()
    acc = python_loss_twin(mt, mt.gpu(0), **{
        k: PYLOSS[k] for k in ("epochs", "batch_size", "num_examples",
                               "seed")})
    log("  [%s] python_loss twin (SequentialModule(Module(MLP), "
        "PythonLossModule) on gpu(0)): val accuracy %.3f in %.1f s (gate > "
        "%.1f)" % (card, acc, time.perf_counter() - t0, PYLOSS["gate"]))
    if not acc > PYLOSS["gate"]:
        raise AssertionError("python_loss twin stuck at %.3f" % acc)
    res["python_loss_acc"] = acc
    res["lm"] = surface_lm(mt, att, seed, card)
    res["wide_lm"] = surface_wide_lm(mt, att, seed, card, parents)
    return res


# ---------------------------------------------------------------- phase 13
def train_imagenet_twin(mt, ctx, data_train, data_val=None, num_layers=50,
                        image_shape=(3, 224, 224), num_classes=1000,
                        batch_size=256, num_epochs=1, lr=0.1,
                        lr_step_epochs="30,60", kv_store="local",
                        epoch_size=0, speedometer_period=20, wrap=None,
                        callbacks=(), logger=None):
    """examples/image_classification/train_imagenet.py:64-106 through the
    port's names, on ``ctx``: ResNet (v2) from ``mt.models.get_resnet``,
    ``kv.create(kv_store)``, ``io.ImageRecordIter`` over ``data_train``
    (shuffle, rand_crop, rand_mirror, the ImageNet means, the kvstore's
    part) cut to ``epoch_size`` batches by ``io.ResizeIter``, a centre-
    cropped ``ImageRecordIter`` over ``data_val``, SGD (momentum 0.9, wd
    1e-4) with ``MultiFactorScheduler``, ``Accuracy`` and
    ``TopKAccuracy(top_k=5)``, and a ``Speedometer`` whose readings are
    kept. ``wrap`` (if given) wraps the train iterator before the resize,
    ``callbacks`` run after the Speedometer. Returns (module, speeds,
    the train ImageRecordIter, the val one or None)."""
    net = mt.models.get_resnet(num_classes=num_classes,
                               num_layers=num_layers,
                               image_shape=image_shape)
    kv = mt.kv.create(kv_store)
    train = records = mt.io.ImageRecordIter(
        path_imgrec=data_train, data_shape=image_shape,
        batch_size=batch_size, shuffle=True, rand_mirror=True,
        rand_crop=True, mean_r=123.68, mean_g=116.779, mean_b=103.939,
        num_parts=kv.num_workers, part_index=kv.rank)
    if wrap is not None:
        train = wrap(train)
    if epoch_size:
        train = mt.io.ResizeIter(train, epoch_size)
    val = None
    if data_val:
        val = mt.io.ImageRecordIter(
            path_imgrec=data_val, data_shape=image_shape,
            batch_size=batch_size,
            mean_r=123.68, mean_g=116.779, mean_b=103.939)
    steps = [int(e) for e in lr_step_epochs.split(",") if e]
    lr_sched = mt.lr_scheduler.MultiFactorScheduler(
        step=[s * 5000 for s in steps], factor=0.1) if steps else None
    mod = mt.mod.Module(net, context=ctx,
                        **({"logger": logger} if logger else {}))
    speeds = []

    class _MeterHook(mt.callback.Speedometer):
        def _emit(self, param, speed):
            speeds.append(speed)
            super()._emit(param, speed)

    mod.fit(train, eval_data=val, num_epoch=num_epochs, kvstore=kv,
            optimizer="sgd",
            optimizer_params={"learning_rate": lr, "momentum": 0.9,
                              "wd": 1e-4, "lr_scheduler": lr_sched},
            eval_metric=[mt.metric.Accuracy(),
                         mt.metric.TopKAccuracy(top_k=5)],
            batch_end_callback=[_MeterHook(batch_size, speedometer_period)]
            + list(callbacks))
    return mod, speeds, records, val


class WaitClock:
    """A DataIter that passes another one's batches through and keeps the
    host-clock ms each ``next()`` waited for its batch."""

    def __init__(self, it):
        self.it = it
        self.waits = []
        self.batch_size = it.batch_size
        self.provide_data = it.provide_data
        self.provide_label = it.provide_label

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def reset(self):
        self.it.reset()

    def next(self):
        t0 = time.perf_counter()
        try:
            return self.it.next()
        finally:
            self.waits.append((time.perf_counter() - t0) * 1e3)


def records_pack(mt, tmp, seed):
    """The train, val and detection ``.rec`` files under ``tmp``, packed
    by the port's packers; seconds and bytes of each."""
    cfg = RECORDS
    out = {}
    for name, fn, kw in (
            ("train", mt.test_utils.make_rec,
             dict(n=cfg["train"], edge=cfg["edge"], seed=seed,
                  num_classes=cfg["label_classes"])),
            ("val", mt.test_utils.make_rec,
             dict(n=cfg["val"], edge=cfg["edge"], seed=seed + 1,
                  num_classes=cfg["label_classes"])),
            ("det", mt.test_utils.make_det_rec,
             dict(n=cfg["det"], edge=cfg["det_edge"], seed=seed + 2,
                  num_classes=SSD["num_classes"]))):
        path = os.path.join(tmp, name + ".rec")
        t0 = time.perf_counter()
        fn(path, **kw)
        secs = time.perf_counter() - t0
        size = os.path.getsize(path)
        out[name] = {"path": path, "records": kw["n"], "seconds": secs,
                     "bytes": size}
        log("  packed %s: %d records at %dx%d in %.2f s, %d bytes (%.1f KB "
            "a record)" % (name, kw["n"], kw["edge"], kw["edge"], secs, size,
                           size / kw["n"] / 1e3))
    return out


def _digest(batch):
    import hashlib
    h = hashlib.sha1(batch.data[0].asnumpy().tobytes())
    h.update(batch.label[0].asnumpy().tobytes())
    return h.hexdigest()


def _train_recipe(mt, path, threads, **kw):
    """train_imagenet.py's train ImageRecordIter at B=256, 224x224."""
    args = dict(path_imgrec=path, data_shape=RESNET["image_shape"],
                batch_size=RECORDS["batch"], shuffle=True, rand_crop=True,
                rand_mirror=True, mean_r=123.68, mean_g=116.779,
                mean_b=103.939, preprocess_threads=threads)
    args.update(kw)
    return mt.io.ImageRecordIter(**args)


def numpy_first_batch(path, seed, shape, batch, mean):
    """The first batch of the train recipe, decoded independently: the
    epoch's order from ``RandomState(seed)``, cv2 decodes, the crops and
    mirrors from ``RandomState(seed + 12345)`` in record order, minus
    the means, NCHW."""
    import cv2
    from mxtpu_torch import recordio
    rec = recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                     path, "r")
    order = list(rec.keys)
    np.random.RandomState(seed).shuffle(order)
    rng = np.random.RandomState(seed + 12345)
    c, h, w = shape
    data = np.empty((batch, c, h, w), np.float32)
    label = np.empty(batch, np.float32)
    for i, key in enumerate(order[:batch]):
        header, buf = recordio.unpack(rec.read_idx(key))
        img = cv2.cvtColor(cv2.imdecode(np.frombuffer(buf, np.uint8), 1),
                           cv2.COLOR_BGR2RGB)
        H, W = img.shape[:2]
        y0 = rng.randint(0, H - h + 1)
        x0 = rng.randint(0, W - w + 1)
        img = img[y0:y0 + h, x0:x0 + w]
        if rng.rand() < 0.5:
            img = img[:, ::-1]
        data[i] = (img.astype(np.float32) - mean).transpose(2, 0, 1)
        label[i] = header.label
    rec.close()
    return data, label


def records_iterator(mt, paths, seed, card):
    """The train recipe's ImageRecordIter alone (see phase 13 in the
    module docstring): images/s at each thread count over two epochs,
    beside the rate ResNet-50's in-memory step needs; the gates on its
    batches."""
    cfg = RECORDS
    train = paths["train"]["path"]
    b = cfg["batch"]
    rates, first_epochs = {}, {}
    for threads in cfg["threads"]:
        it = _train_recipe(mt, train, threads, seed=seed)
        epochs = []
        for epoch in range(cfg["iter_epochs"]):
            if epoch:
                it.reset()
            t0 = time.perf_counter()
            digests = [_digest(batch) for batch in it]
            secs = time.perf_counter() - t0
            epochs.append(len(digests) * b / secs)
            if not epoch:
                first_epochs[threads] = digests
        it.close()
        rates[threads] = {"epochs_images_per_s": epochs,
                          "images_per_s": float(np.mean(epochs))}
        log("  [%s] ImageRecordIter B=%d %s (crop, mirror, means), "
            "preprocess_threads=%d: images/s by epoch %s, mean %.1f; "
            "ResNet-50's in-memory step needs %d"
            % (card, b, "x".join(map(str, RESNET["image_shape"][1:])),
               threads, [round(v, 1) for v in epochs],
               rates[threads]["images_per_s"], cfg["need_images_per_s"]))
    many = max(cfg["threads"])
    again = _train_recipe(mt, train, many, seed=seed)
    second = [_digest(batch) for batch in again]
    again.close()
    one = _train_recipe(mt, train, 1, seed=seed)
    t0 = time.perf_counter()
    single, first = [], None
    for batch in one:
        first = first or batch
        single.append(_digest(batch))
    rates[1] = {"images_per_s": len(single) * b
                / (time.perf_counter() - t0)}
    one.close()
    same = {t: d == second for t, d in first_epochs.items()}
    log("  an epoch at %d threads, twice, and at 1 thread (%.1f images/s): "
        "%d batches, bit-identical %s; at 1 thread %s"
        % (many, rates[1]["images_per_s"], len(second), same,
           single == second))
    if not (first_epochs[many] == second == single and all(same.values())):
        raise AssertionError("ImageRecordIter's batches depend on the run "
                             "or the thread count: %s, 1 thread %s"
                             % (same, single == second))
    mean = np.array([123.68, 116.779, 103.939], np.float32)
    want, want_label = numpy_first_batch(train, seed, RESNET["image_shape"],
                                         b, mean)
    got = first.data[0].asnumpy()
    decode_err = float(np.abs(got - want).max())
    label_ok = bool(np.array_equal(first.label[0].asnumpy(), want_label))
    log("  first batch vs a numpy decode (cv2, the same drawn crops, "
        "mirrors and means): max abs err %.3e, labels equal %s"
        % (decode_err, label_ok))
    if decode_err != 0.0 or not label_ok:
        raise AssertionError("ImageRecordIter's first batch differs from "
                             "the numpy decode: %g" % decode_err)
    val = paths["val"]["path"]
    n_val = paths["val"]["records"]
    tail_b = cfg["tail_batch"]
    it = mt.io.ImageRecordIter(path_imgrec=val, data_shape=RESNET[
        "image_shape"], batch_size=tail_b, preprocess_threads=many)
    batches = list(it)
    it.close()
    tail = batches[-1]
    n = n_val - (len(batches) - 1) * tail_b
    td = tail.data[0].asnumpy()
    wrap_ok = all(np.array_equal(td[n + j], td[j % n])
                  for j in range(tail_b - n))
    log("  val at B=%d: %d batches, tail pad %d (want %d), wrapped rows "
        "== the tail's first rows %s" % (tail_b, len(batches), tail.pad,
                                         tail_b - n, wrap_ok))
    if tail.pad != tail_b - n or not wrap_ok:
        raise AssertionError("the tail batch's pad %s is wrong" % tail.pad)
    kw = dict(path_imgrec=train, data_shape=RESNET["image_shape"],
              batch_size=b, shuffle=True, rand_crop=True, rand_mirror=True,
              preprocess_threads=many, seed=seed)
    raw = mt.io.ImageRecordUInt8Iter(**kw)
    flt = mt.io.ImageRecordIter(**kw)
    u8_same = []
    for _ in range(cfg["uint8_batches"]):
        bu, bf = raw.next(), flt.next()
        u8_same.append(bu.data[0].dtype == np.uint8 and np.array_equal(
            bu.data[0].asnumpy().astype(np.float32), bf.data[0].asnumpy()))
    raw.close()
    flt.close()
    log("  ImageRecordUInt8Iter's pixels == the float iterator's before "
        "means, %d batches: %s" % (len(u8_same), u8_same))
    if not all(u8_same):
        raise AssertionError("ImageRecordUInt8Iter differs from the float "
                             "iterator")
    return {"rates": rates, "decode_err": decode_err,
            "tail_pad": tail.pad, "uint8_equal": u8_same}


def _softmax_ce(probs, labels):
    p = probs.double()
    idx = labels.to(device=p.device, dtype=torch.long).reshape(-1)
    return float(-torch.log(p[torch.arange(len(idx)), idx]
                            .clamp_min(1e-30)).mean())


def record_step_parts(mt, mod, records, n):
    """What a record-fed step of ``mod`` is made of, on one batch from the
    ImageRecordIter ``records``, each the median of ``n`` timed runs after
    a warm one: the step from the cpu() batch (the fit's path: the module
    copies it in), the step from the same batch on the card, the batch's
    host-to-card copy from pageable and from pinned memory, and the
    kernel and copy ms of one profiled step from the cpu() batch."""
    records.reset()
    host = records.next()
    card_batch = mt.io.DataBatch(
        [host.data[0].as_in_context(mt.gpu(0))],
        [host.label[0].as_in_context(mt.gpu(0))])

    def median_ms(fn):
        times = []
        for i in range(n + 1):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t1) * 1e3)
        return float(np.median(times))

    def step(batch):
        mod.forward_backward(batch)
        mod.update()

    x = host.data[0]._data
    dev = card_batch.data[0]._data.device
    pinned = x.pin_memory()
    kernels = step_kernels(lambda: step(host))
    return {"host_batch_step_ms": median_ms(lambda: step(host)),
            "card_batch_step_ms": median_ms(lambda: step(card_batch)),
            "copy_ms_pageable": median_ms(lambda: x.to(dev)),
            "copy_ms_pinned": median_ms(
                lambda: pinned.to(dev, non_blocking=True)),
            "batch_bytes": x.numel() * x.element_size(),
            "device_ms": kernels[0][1] if kernels else float("nan")}


def records_config2(mt, epi, paths, seed, card, resnet_row=None):
    """ResNet-50 v2 through ``train_imagenet_twin`` on gpu(0) from the
    train ``.rec`` (B=256, ``ResizeIter`` of RECORDS["epoch_size"]
    batches, RECORDS["epochs"] epochs, the val ``.rec`` scored after
    each), then the evaluation forward's gate, ``Module.predict`` over
    the val iterator and TopKAccuracy's device sum against its host sum
    (see phase 13 in the module docstring)."""
    cfg = RECORDS
    b = cfg["batch"]
    clock = []
    ce, stamps = [], []

    def record(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        mod_ = param.locals["self"]
        ce.append(_softmax_ce(mod_.get_outputs()[0]._data,
                              param.locals["data_batch"].label[0]._data))

    def wrap(it):
        clock.append(WaitClock(it))
        return clock[0]

    np.random.seed(seed)  # the initializer's draws
    torch.cuda.synchronize()
    epi.bn_apply_relu_add.launches = 0  # the fit's scoring forwards
    t0 = time.perf_counter()
    mod, speeds, train, val = train_imagenet_twin(
        mt, mt.gpu(0), paths["train"]["path"], paths["val"]["path"],
        num_layers=RESNET["num_layers"], image_shape=RESNET["image_shape"],
        num_classes=RESNET["num_classes"], batch_size=b,
        num_epochs=cfg["epochs"], epoch_size=cfg["epoch_size"],
        speedometer_period=cfg["speedometer_period"], wrap=wrap,
        callbacks=[record], logger=_quiet_logger())
    fit_eval_launches = epi.bn_apply_relu_add.launches
    ms = [float(v) * 1e3 for v in np.diff([t0] + stamps)]
    waits = clock[0].waits
    steps = cfg["epochs"] * cfg["epoch_size"]
    # a step inside an epoch: not the first (the iterator's reset, the
    # previous epoch's scoring of the val .rec)
    inner = [v for i, v in enumerate(ms) if i % cfg["epoch_size"]]
    med = float(np.median(inner))
    log("  [%s] ResNet-50 v2 fit from the train .rec (B=%d, %d epochs of "
        "ResizeIter %d, val .rec scored each epoch): CE by step %s"
        % (card, b, cfg["epochs"], cfg["epoch_size"],
           [round(v, 4) for v in ce]))
    if len(ce) != steps or not np.all(np.isfinite(ce)) or \
            not ce[-1] < ce[0]:
        raise AssertionError("ResNet-50 from records did not lower a finite "
                             "cross-entropy: %s" % ce)
    row = {"batch": b, "steps": steps, "ce": ce, "step_ms": ms,
           "step_ms_median": med, "images_per_s": b / (med / 1e3),
           "wait_ms": waits, "wait_ms_median": float(np.median(
               [w for i, w in enumerate(waits) if i % cfg["epoch_size"]])),
           "speedometer": speeds, "fit_eval_launches": fit_eval_launches}
    row.update(record_step_parts(mt, mod, train, cfg["memory_steps"]))
    row["busy_share"] = row["device_ms"] / med
    # phase 7's fit (device_prefetch, metric_sync=1, a checkpoint each
    # epoch) by the same statistic: the median of its steps inside an
    # epoch
    row["phase7_step_ms"] = (resnet_row or {}).get(
        "step_ms_within_epoch_median")
    log("  [%s] step from records %.2f ms median inside an epoch (%s), "
        "%.1f images/s; the iterator's wait a step %.2f ms median (%s); "
        "Speedometer %s"
        % (card, med, [round(v, 1) for v in ms], row["images_per_s"],
           row["wait_ms_median"], [round(v, 1) for v in waits],
           [round(v, 1) for v in speeds]))
    log("  [%s] the same module on one record batch, medians of %d: step "
        "from the cpu() batch %.2f ms, from the batch on the card %.2f ms; "
        "the batch's host-to-card copy %.2f ms pageable, %.2f ms pinned "
        "(%d bytes); %.2f ms of kernels and copies in a profiled step from "
        "the cpu() batch: busy %.1f %% of the record-fed median; phase 7's "
        "in-memory fit step, median inside an epoch: %s ms"
        % (card, cfg["memory_steps"], row["host_batch_step_ms"],
           row["card_batch_step_ms"], row["copy_ms_pageable"],
           row["copy_ms_pinned"], row["batch_bytes"], row["device_ms"],
           100 * row["busy_share"], row["phase7_step_ms"]))

    val.reset()  # the fit's last scoring pass ran it to its end
    vbatch = val.next()

    def forward():
        mod.forward(vbatch, is_train=False)
        return mod.get_outputs()[0]._data

    row.update(eval_forward_gate(
        epi, forward, lambda: mod._exec_group.execs[0].fused_sites,
        "from records, the val .rec's evaluation forward"))
    epi.bn_apply_relu_add.launches = 0
    pred = mod.predict(val)
    torch.cuda.synchronize()
    row["predict_launches"] = epi.bn_apply_relu_add.launches
    n_val = paths["val"]["records"]
    val_batches = -(-n_val // b)
    log("  Module.predict over the val ImageRecordIter: %s, %d batches, "
        "epilogue launches %d, finite %s"
        % (tuple(pred.shape), val_batches, row["predict_launches"],
           bool(torch.isfinite(pred._data).all())))
    if pred.shape != (n_val, RESNET["num_classes"]) or \
            row["predict_launches"] != RESNET_SITES * val_batches or \
            not bool(torch.isfinite(pred._data).all()):
        raise AssertionError("predict over the val records: %s, %d launches"
                             % (pred.shape, row["predict_launches"]))
    val.reset()
    labels = torch.cat([vb.label[0]._data for vb in val])[:n_val]
    host = mt.metric.TopKAccuracy(top_k=5)
    host.update([mt.nd.array(labels, ctx=mt.cpu())],
                [mt.nd.array(pred._data.cpu(), ctx=mt.cpu())])
    dev = mt.metric.TopKAccuracy(top_k=5)
    accum = mt.metric.DeviceMetricAccum.wrap(dev)
    accum.update([labels.to(pred._data.device)], [pred._data])
    accum.sync()
    row["topk"] = {"host": [host.sum_metric, host.num_inst],
                   "device": [dev.sum_metric, dev.num_inst],
                   "syncs": accum.syncs}
    log("  TopKAccuracy(5) over the val predictions: host %s, device %s "
        "(%d host copy)" % (row["topk"]["host"], row["topk"]["device"],
                             accum.syncs))
    if row["topk"]["host"] != row["topk"]["device"]:
        raise AssertionError("TopKAccuracy's device sum differs from its "
                             "host sum: %s" % row["topk"])
    for it_ in (train, val):
        it_.close()
    del mod
    torch.cuda.empty_cache()
    return row


def records_config5(mt, paths, seed, card):
    """The SSD (vgg16_reduced, 300x300, B=32) through ``Module.fit`` from
    the detection ``.rec`` by ``ImageDetRecordIter`` as examples/ssd/
    train.py:81-84 sets it, then ``ssd_eval`` through ``ImageDetRecordIter``
    as evaluate.py:130 sets it (see phase 13 in the module docstring)."""
    from mxtpu_torch.models import ssd_data
    from mxtpu_torch.ops import contrib
    cfg = SSD
    b = RECORDS["ssd_batch"]
    shape = (3, cfg["data_shape"], cfg["data_shape"])
    det = paths["det"]["path"]
    train = mt.io.ImageDetRecordIter(
        path_imgrec=det, data_shape=shape, batch_size=b, shuffle=True,
        mean_pixels=(123, 117, 104), rand_mirror_prob=0.5)
    mod = mt.mod.Module(mt.models.ssd.get_symbol_train(
        num_classes=cfg["num_classes"], num_scales=cfg["num_scales"],
        network=cfg["network"]), label_names=("label",), context=mt.gpu(0),
        logger=_quiet_logger())
    ce, stamps, boxes = [], [], []

    def batch_end(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        m = ssd_data.MultiBoxMetric()
        m.update(None, param.locals["self"].get_outputs()[:3])
        ce.append(float(m.get()[1][0]))
        lab = param.locals["data_batch"].label[0].asnumpy()
        valid = lab[..., 0] >= 0
        boxes.append((int(valid.sum()), float(lab[valid][:, 1:5].min()),
                      float(lab[valid][:, 1:5].max())))

    random.seed(seed)  # the mirror's draws
    np.random.seed(seed)  # Xavier's
    contrib.nms_keep.launches = 0
    clock = WaitClock(train)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(clock, num_epoch=RECORDS["ssd_epochs"],
            eval_metric=ssd_data.MultiBoxMetric(), optimizer="sgd",
            optimizer_params=SSD_OPT, initializer=mt.init.Xavier(),
            batch_end_callback=[mt.callback.Speedometer(b, 10, log=False),
                                batch_end])
    fit_launches = contrib.nms_keep.launches
    ms = [float(v) * 1e3 for v in np.diff([t0] + stamps)]
    steps = len(stamps)
    in_box = all(lo >= 0.0 and hi <= 1.0 for _, lo, hi in boxes)
    steady = ms[1:] or ms
    med = float(np.median(steady))
    log("  [%s] SSD fit from the det .rec through ImageDetRecordIter (B=%d, "
        "%d epochs, %d steps): CE %s, step ms %s (%.2f median after the "
        "first, %.1f images/s), the iterator's wait a step %s ms; label "
        "boxes in [0, 1]: %s (objects, min, max a batch %s); multibox_nms "
        "launches %d"
        % (card, b, RECORDS["ssd_epochs"], steps, [round(v, 4) for v in ce],
           [round(v, 1) for v in ms], med, b / (med / 1e3),
           [round(v, 1) for v in clock.waits], in_box, boxes,
           fit_launches))
    if not np.all(np.isfinite(ce)) or steps != RECORDS["ssd_epochs"] * (
            paths["det"]["records"] // b):
        raise AssertionError("SSD from records: CE %s over %d steps"
                             % (ce, steps))
    if not in_box or fit_launches != steps:
        raise AssertionError("SSD from records: boxes in [0, 1] %s, "
                             "suppression launches %d in %d steps"
                             % (in_box, fit_launches, steps))
    trained = mod.get_params()[0]
    train.close()
    del mod
    torch.cuda.empty_cache()
    ev = mt.io.ImageDetRecordIter(path_imgrec=det, data_shape=shape,
                                  batch_size=b, mean_pixels=(123, 117, 104))
    res = ssd_eval(mt, contrib, ssd_data, trained, seed, card, it=ev)
    ev.close()
    return {"ce": ce, "step_ms": ms, "step_ms_median": med,
            "images_per_s": b / (med / 1e3), "wait_ms": clock.waits,
            "boxes": boxes,
            "fit_launches": fit_launches, "eval": res}


def phase_records(mt, epi, seed, card, resnet_row=None):
    """Phase 13: the record pipeline (see the module docstring)."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_records_")
    try:
        t0 = time.perf_counter()
        paths = records_pack(mt, tmp, seed)
        res = {"pack": {k: {kk: vv for kk, vv in v.items() if kk != "path"}
                        for k, v in paths.items()}}
        res["iterator"] = records_iterator(mt, paths, seed, card)
        res["config2"] = records_config2(mt, epi, paths, seed, card,
                                         resnet_row)
        res["config5"] = records_config5(mt, paths, seed, card)
        res["seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    c2, c5 = res["config2"], res["config5"]
    res["launches"] = {
        "epilogue": {"records_fit_eval": c2["fit_eval_launches"],
                     "records_eval": c2["eval_launches"],
                     "records_predict": c2["predict_launches"]},
        "nms": {"records_ssd_fit": c5["fit_launches"],
                "records_ssd_eval": c5["eval"]["launches"]}}
    log("  records phase %.1f s" % res["seconds"])
    return res


def image_packages():
    """{"cv2": version or "absent", "PIL": ...} on this machine."""
    import importlib
    found = {}
    for name in ("cv2", "PIL"):
        try:
            found[name] = importlib.import_module(name).__version__
        except ImportError:
            found[name] = "absent"
    return found


# phase 14: ResNet-50 v2 at full width (phase 7's model and images)
# trained 4 steps (2 epochs of 2 batches, one val batch scored each
# epoch) with Nadam on the Updater path, then 5 steps timed on a batch on
# the card; the optimizers at the 2048x1000 FC weight, 4 updates each;
# 2^22 draws a sampler
FRONTEND = dict(batch=256, epochs=2, lr=0.001, wd=1e-4, timed_steps=5,
                opt_steps=4, fc=(1000, 2048), draws=1 << 22, sigmas=5.0)


def _one_hot_metric(mt, klass):
    """``klass`` (MSE, RMSE or MAE) scored against the one-hot of the
    class label, on the host path and in its device kernel alike."""
    import torch.nn.functional as F

    def one_hot(label, pred):
        return F.one_hot(label.to(torch.int64).reshape(-1),
                         pred.shape[1]).to(pred.dtype)

    class OneHot(klass):
        def update(self, labels, preds):
            super().update([mt.nd.NDArray(one_hot(l._data, p._data))
                            for l, p in zip(labels, preds)], preds)

        def device_kernel(self):
            k = super().device_kernel()
            return mt.metric.DeviceKernel(
                lambda label, pred: k.sum_fn(one_hot(label, pred), pred),
                k.count_fn)

    OneHot.__name__ = "OneHot" + klass.__name__
    return OneHot(name="onehot_" + klass.__name__.lower())


def frontend_metric(mt):
    """Phase 14's eval metric: Accuracy, TopKAccuracy(5), CrossEntropy,
    and MSE, RMSE and MAE against the one-hot label."""
    return mt.metric.CompositeEvalMetric(
        [mt.metric.Accuracy(), mt.metric.TopKAccuracy(top_k=5),
         mt.metric.CrossEntropy()] +
        [_one_hot_metric(mt, k) for k in (mt.metric.MSE, mt.metric.RMSE,
                                          mt.metric.MAE)])


def frontend_initializer(mt):
    """Mixed over every ResNet-50 v2 parameter: Orthogonal for the FC
    weight, MSRAPrelu for the convolutions, One/Zero for the BatchNorm
    scales and shifts, the biases and the moving statistics."""
    init = mt.init
    return init.Mixed(
        [r"fc1_weight$", r".*(conv\d+|_sc)_weight$", r".*_gamma$",
         r".*_(beta|bias)$", r".*_moving_mean$", r".*_moving_var$"],
        [init.Orthogonal(), init.MSRAPrelu(), init.One(), init.Zero(),
         init.Zero(), init.One()])


def frontend_training(mt, epi, seed, card, resnet_row):
    """ResNet-50 v2 (224x224, 1000 classes, B=256, f32) through
    Module.fit on gpu(0): Mixed initialization, Nadam (wd 1e-4) on the
    Updater path (no fused rule), Speedometer and ProgressBar at each
    batch, LogValidationMetricsCallback after each epoch's score of one
    val batch, the composite metric on the device. Gates: a finite loss
    every step; the Updater path; every parameter matched by a pattern
    (Mixed raises otherwise); each device metric's sum equal to its host
    update within
    1e-6 relative on a trained batch; the evaluation forward's 50
    epilogue launches bit for bit against the plain epilogue."""
    cfg = FRONTEND
    b = cfg["batch"]
    sym = mt.models.get_resnet(**RESNET)
    x, y = resnet_train_data(seed)
    steps_per_epoch = len(x) // b
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    ce, stamps = [], []

    def record(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        ce.append(dict(zip(*param.eval_metric.get()))["cross-entropy"])

    metric = frontend_metric(mt)
    np.random.seed(seed)
    epi.bn_apply_relu_add.launches = 0
    t0 = time.perf_counter()
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=b),
            eval_data=mt.io.NDArrayIter(x[:b], y[:b], batch_size=b),
            num_epoch=cfg["epochs"], eval_metric=metric, optimizer="nadam",
            optimizer_params={"learning_rate": cfg["lr"], "wd": cfg["wd"],
                              "rescale_grad": 1.0 / b},
            initializer=frontend_initializer(mt),
            batch_end_callback=[record, mt.callback.Speedometer(b, 1,
                                                                log=False),
                                mt.callback.ProgressBar(steps_per_epoch)],
            eval_end_callback=mt.callback.LogValidationMetricsCallback(),
            metric_sync=1, device_prefetch=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    score_launches = epi.bn_apply_relu_add.launches
    sys.stdout.write("\n")
    if mod._fused is not None or type(mod._optimizer).__name__ != "Nadam":
        raise AssertionError("Nadam did not take the Updater path")
    ms = [float(v) for v in np.diff([t0] + stamps) * 1e3]
    log("  cross-entropy by step: %s" % [round(v, 4) for v in ce])
    if len(ce) != cfg["epochs"] * steps_per_epoch or \
            not np.all(np.isfinite(ce)):
        raise AssertionError("the Nadam steps' loss is not finite: %s" % ce)
    if score_launches != RESNET_SITES * cfg["epochs"]:
        raise AssertionError("the epochs' scores launched the epilogue %d "
                             "times" % score_launches)
    # steps after each epoch's first (which follows a reset and a score)
    inner = [m for i, m in enumerate(ms) if i % steps_per_epoch]
    row = {"steps": len(ms), "ce": ce, "step_ms": ms,
           "step_ms_within_epoch": float(np.mean(inner)), "fit_s": fit_s,
           "score_launches": score_launches}
    batch = mt.io.DataBatch([mt.nd.array(x[:b], ctx=mt.cpu())],
                            [mt.nd.array(y[:b], ctx=mt.cpu())])

    def forward():
        mod.forward(batch, is_train=False)
        return mod.get_outputs()[0]._data

    gate = eval_forward_gate(
        epi, forward, lambda: mod._exec_group.execs[0].fused_sites,
        "Nadam-trained model's evaluation forward")
    if gate["eval_max_abs_err"] != 0.0:
        raise AssertionError("the epilogue is not bit for bit: %g"
                             % gate["eval_max_abs_err"])
    row.update(gate)
    row["launches"] = score_launches + gate["eval_launches"]
    row["metrics"] = frontend_metric_gate(mt, forward(), batch)
    on_card = mt.io.DataBatch([mt.nd.array(x[:b], ctx=mt.gpu(0))],
                              [mt.nd.array(y[:b], ctx=mt.gpu(0))])
    timed = []
    for _ in range(cfg["timed_steps"]):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mod.forward_backward(on_card)
        mod.update()
        torch.cuda.synchronize()
        timed.append((time.perf_counter() - t1) * 1e3)
    row["timed_step_ms"] = timed
    row["timed_step_ms_median"] = float(np.median(timed))
    fused = resnet_row and resnet_row.get("step_ms_within_epoch_median")
    row["phase7_fused_sgd_step_ms"] = fused
    log("  [%s] Nadam on the Updater path: fit's step ms %s (from the "
        "prefetcher); %d steps on a card-resident batch %s, median %.2f ms "
        "against phase 7's fused SGD step %s ms (%s, the median inside an "
        "epoch); fit %.1f s"
        % (card, [round(v, 1) for v in ms], len(timed),
           [round(v, 1) for v in timed], row["timed_step_ms_median"],
           "%.2f" % fused if fused else "not measured", card, fit_s))
    del mod
    torch.cuda.empty_cache()
    return row


def frontend_metric_gate(mt, out, batch):
    """Each metric of phase 14's composite on one trained batch: the
    device sum (``DeviceMetricAccum``, one sync) against the host
    ``update`` of the same outputs, within 1e-6 relative."""
    label = batch.label[0].as_in_context(mt.gpu(0))
    pred = mt.nd.NDArray(out)
    dev = mt.metric.DeviceMetricAccum.wrap(frontend_metric(mt))
    if dev is None:
        raise AssertionError("a phase 14 metric has no device kernel")
    dev.update([label], [pred])
    got = dict(dev.sync())
    host = frontend_metric(mt)
    host.update([label], [pred])
    worst = {}
    for name, want in host.get_name_value():
        worst[name] = abs(got[name] - want) / max(abs(want), 1e-30)
    log("  device metric sums against the host update (relative): %s"
        % {k: "%.1e" % v for k, v in worst.items()})
    if dev.syncs != 1 or max(worst.values()) > 1e-6:
        raise AssertionError("device metrics disagree with the host: %s"
                             % worst)
    return {"values": got, "rel_err": worst}


FRONTEND_OPTIMIZERS = [
    ("adadelta", {"rho": 0.9}), ("adamax", {"learning_rate": 0.002}),
    ("nadam", {"learning_rate": 0.001}), ("ftrl", {"learning_rate": 0.1}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9}), ("test", {}),
    ("ccsgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
             "multi_precision": True})]


def frontend_optimizers(mt, seed):
    """Each new optimizer's 4 Updater steps at ResNet-50's largest
    parameter (the 2048x1000 FC weight; float16 with SGD's
    multi_precision) on gpu(0) against the same steps on cpu(): the
    largest difference over the largest value, of the weight and of every
    state, within 1e-6 (float16: one float16 step). SGLD: the noise of one
    update (weight decay and gradient 0) has mean 0 and variance lr
    within 5 standard errors."""
    rng = np.random.RandomState(seed + 14)
    shape = FRONTEND["fc"]
    w0 = (rng.randn(*shape) * 0.02).astype(np.float32)
    grads = [rng.randn(*shape).astype(np.float32)
             for _ in range(FRONTEND["opt_steps"])]
    rows = {}

    def run(ctx, name, params, dtype):
        opt = mt.optimizer.create(name, wd=1e-4, rescale_grad=1.0 / 256,
                                  **params)
        upd = mt.optimizer.get_updater(opt)
        w = mt.nd.array(w0, ctx=ctx, dtype=dtype)
        for g in grads:
            upd(0, mt.nd.array(g, ctx=ctx, dtype=dtype), w)
        state = upd.states[0]
        leaves = [s for s in (state if isinstance(state, tuple)
                              else (state,)) if s is not None]
        return [w._data] + [s._data for s in leaves]

    for name, params in FRONTEND_OPTIMIZERS:
        dtype = "float16" if params.get("multi_precision") else "float32"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = run(mt.gpu(0), name, params, dtype)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / FRONTEND["opt_steps"]
        host = run(mt.cpu(), name, params, dtype)
        errs = [float((a.cpu().double() - b.double()).abs().max()
                      / max(float(b.double().abs().max()), 1e-30))
                for a, b in zip(card, host)]
        tol = 1e-3 if dtype == "float16" else 1e-6
        rows["%s%s" % (name, "_mp" if dtype == "float16" else "")] = {
            "rel_err": errs, "update_ms": ms}
        if len(card) != len(host) or max(errs) > tol:
            raise AssertionError("%s on gpu(0) differs from cpu(): %s"
                                 % (name, errs))
    lr, n = 0.04, shape[0] * shape[1]
    w = mt.nd.zeros(shape, ctx=mt.gpu(0))
    mt.optimizer.get_updater(mt.optimizer.create("sgld", learning_rate=lr))(
        0, mt.nd.zeros(shape, ctx=mt.gpu(0)), w)
    noise = w._data.double()
    mean, var = float(noise.mean()), float(noise.var())
    rows["sgld"] = {"mean": mean, "var": var}
    log("  optimizers at %s, 4 updates, gpu(0) vs cpu() (largest relative "
        "difference): %s; SGLD noise mean %.2e var %.5f (lr %g)"
        % (shape, {k: "%.1e" % max(v["rel_err"]) for k, v in rows.items()
                   if "rel_err" in v}, mean, var, lr))
    if abs(mean) > 5 * np.sqrt(lr / n) or \
            abs(var - lr) > 5 * lr * np.sqrt(2.0 / n):
        raise AssertionError("SGLD's noise is not N(0, lr): %g, %g"
                             % (mean, var))
    return rows


def _frontend_draws(mt):
    """(name, draw(), analytic mean, variance) of phase 14's samplers:
    the 8 ``random`` distributions and the 8 ``sample_*`` ops, 2^22
    values each on gpu(0) (the per-row ops: 4 rows of 2^20)."""
    n, ctx = FRONTEND["draws"], mt.gpu(0)
    r = mt.random
    rows = n // 4

    def per_row(op, *params):
        args = [mt.nd.array(np.full((4,), p, np.float32), ctx=ctx)
                for p in params]
        return lambda: getattr(mt.nd, op)(*args, shape=(rows,))

    probs = mt.nd.array(np.array([0.1, 0.2, 0.3, 0.4], np.float32), ctx=ctx)
    return [
        ("uniform", lambda: r.uniform(-1, 3, shape=(n,), ctx=ctx), 1.0,
         16 / 12.0),
        ("normal", lambda: r.normal(0.5, 2.0, shape=(n,), ctx=ctx), 0.5,
         4.0),
        ("gamma", lambda: r.gamma(2.5, 0.5, shape=(n,), ctx=ctx), 1.25,
         0.625),
        ("exponential", lambda: r.exponential(4.0, shape=(n,), ctx=ctx),
         0.25, 1 / 16.0),
        ("poisson", lambda: r.poisson(3.5, shape=(n,), ctx=ctx), 3.5, 3.5),
        ("negative_binomial", lambda: r.negative_binomial(
            3, 0.4, shape=(n,), ctx=ctx), 4.5, 11.25),
        ("generalized_negative_binomial", lambda:
         r.generalized_negative_binomial(2.0, 0.5, shape=(n,), ctx=ctx),
         2.0, 4.0),
        ("multinomial", lambda: r.multinomial(probs, shape=(n,)), 2.0, 1.0),
        ("sample_uniform", per_row("sample_uniform", -1.0, 3.0), 1.0,
         16 / 12.0),
        ("sample_normal", per_row("sample_normal", 0.5, 2.0), 0.5, 4.0),
        ("sample_gamma", per_row("sample_gamma", 2.5, 0.5), 1.25, 0.625),
        ("sample_exponential", per_row("sample_exponential", 4.0), 0.25,
         1 / 16.0),
        ("sample_poisson", per_row("sample_poisson", 3.5), 3.5, 3.5),
        ("sample_negative_binomial", per_row("sample_negative_binomial",
                                             3.0, 0.4), 4.5, 11.25),
        ("sample_generalized_negative_binomial", per_row(
            "sample_generalized_negative_binomial", 2.0, 0.5), 2.0, 4.0),
        ("sample_multinomial", lambda: mt.nd.sample_multinomial(
            probs, shape=(n,)), 2.0, 1.0)]


def frontend_random(mt, seed):
    """Each sampler's 2^22 draws on gpu(0): kept on the card (the result
    is a CUDA tensor; the moments are reduced there and only they are
    copied), mean and variance within 5 standard errors of the analytic
    moments (the variance's error from the draws' fourth moment), and
    the same seed drawing the same bits."""
    rows = {}
    k = FRONTEND["sigmas"]
    for name, draw, mean, var in _frontend_draws(mt):
        mt.random.seed(seed)
        a = draw()
        if not a._data.is_cuda or a.context != mt.gpu(0):
            raise AssertionError("%s drew off the card" % name)
        mt.random.seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = draw()  # timed warm: the first call loads the kernels
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        same = bool(torch.equal(a._data, again._data))
        x = a._data.reshape(-1).double()
        n = x.numel()
        m, v = float(x.mean()), float(x.var(unbiased=False))
        m4 = float(((x - m) ** 4).mean())
        z_mean = abs(m - mean) / np.sqrt(var / n)
        z_var = abs(v - var) / np.sqrt(max(m4 - var ** 2, 1e-30) / n)
        rows[name] = {"n": n, "mean": m, "var": v, "z_mean": z_mean,
                      "z_var": z_var, "same_seed_same_bits": same,
                      "ms": ms, "dtype": str(a.dtype)}
        if n != FRONTEND["draws"] or z_mean > k or z_var > k or not same:
            raise AssertionError("%s: %s" % (name, rows[name]))
    log("  samplers, 2^22 draws each on gpu(0) (mean, variance z-scores; "
        "ms): %s" % {k_: "%.2f %.2f %.1f" % (r_["z_mean"], r_["z_var"],
                                             r_["ms"])
                     for k_, r_ in rows.items()})
    return rows


def frontend_faults(mt):
    """ROADMAP C.8-C.13 on CUDA tensors, each against the same op on
    cpu(): the relu/abs/power gradients at ties, integer scalar
    arithmetic, integer sums and means, numpy dtypes in and out."""
    ties = np.array([-1.0, 0.0, -0.0, 2.0], np.float32)
    ints = np.array([7, 1, -3], np.int32)
    u8 = np.array([250, 3, 9], np.uint8)
    out = {}

    def grads(ctx, f):
        x = mt.nd.array(ties, ctx=ctx)
        x.attach_grad()
        with mt.autograd.record():
            y = f(x)
        y.backward()
        return x.grad.asnumpy()

    cases = {
        "relu": lambda x: mt.nd.relu(x),
        "Activation(relu)": lambda x: mt.nd.Activation(x, act_type="relu"),
        "abs": lambda x: mt.nd.abs(x),
        "x ** 0": lambda x: x ** 0,
        "0 ** x": lambda x: 0 ** x}
    for name, f in cases.items():
        got, want = grads(mt.gpu(0), f), grads(mt.cpu(), f)
        out[name] = got.tolist()
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(out["relu"], [0, 0.5, 0.5, 1])

    def arith(ctx):
        i = mt.nd.array(ints, ctx=ctx)
        u = mt.nd.array(u8, ctx=ctx)
        return [i + 0.5, i - 0.7, 0.7 - i, i * 2.5, i / 2, u + 10, u * 1.5,
                i.sum(), u.sum(), i.mean(), u.mean(),
                mt.nd.zeros((2,), ctx=ctx, dtype=np.float16),
                mt.nd.array(i, ctx=ctx)]

    for j, (g, h) in enumerate(zip(arith(mt.gpu(0)), arith(mt.cpu()))):
        # the means may round one ulp apart (the card's reduction order)
        if g.dtype != h.dtype or not np.allclose(g.asnumpy(), h.asnumpy(),
                                                 rtol=1e-6, atol=0):
            raise AssertionError("integer case %d: %s %s against %s %s"
                                 % (j, g.dtype, g.asnumpy(), h.dtype,
                                    h.asnumpy()))
    got = arith(mt.gpu(0))
    types = [str(a.dtype) for a in got]
    want = ["int32"] * 4 + ["float32", "uint8", "uint8", "int32", "uint32",
                            "float32", "float32", "float16", "int32"]
    if types != want or got[5].asnumpy().tolist() != [4, 13, 19]:
        raise AssertionError("types %s, uint8 + 10 %s" % (
            types, got[5].asnumpy().tolist()))
    out["types"] = types
    log("  faults C.8-C.13 on gpu(0) == cpu(): relu/abs/pow gradients %s; "
        "types %s" % ({k: v for k, v in out.items() if k != "types"},
                      types))
    return out


def phase_frontend(mt, epi, seed, card, resnet_row=None):
    """Phase 14 (module docstring): the training, optimizer, sampler and
    fault parts, with the phase's seconds."""
    t0 = time.perf_counter()
    row = {"train": frontend_training(mt, epi, seed, card, resnet_row),
           "optimizers": frontend_optimizers(mt, seed),
           "random": frontend_random(mt, seed),
           "faults": frontend_faults(mt)}
    row["launches"] = {"frontend_eval": row["train"]["launches"]}
    row["seconds"] = time.perf_counter() - t0
    log("  [%s] frontend phase %.1f s" % (card, row["seconds"]))
    return row


# phase 15: the rest of the image zoo (A.15) at full width and the op
# tranche (A.7) on the card. The symbolic models (name, input edge, fused
# BatchNorm->ReLU sites) served at B=32 through Module.predict; Gluon's
# zoo nets the same way through get_model; inception_v3 trained 3 SGD
# steps and densenet121 2 Trainer steps at B=32
ZOO = dict(batch=32, cpu_rows=2, lr=0.01, momentum=0.9, train_steps=3,
           gluon_steps=2, timed_iters=20)
ZOO_SYMBOLIC = (("inception_v3", 299, 94), ("inception_v4", 299, 149),
                ("inception_resnet_v2", 299, 204), ("googlenet", 224, 0))
ZOO_GLUON = (("densenet121", 224, 121), ("inceptionv3", 299, 94),
             ("mobilenet1.0", 224, 27), ("vgg16_bn", 224, 13),
             ("squeezenet1.0", 224, 0), ("alexnet", 224, 0))
# the epilogue's sites grouped by plane edge (the largest edge of a group)
ZOO_PLANES = ((8, "8x8"), (17, "17x17"), (35, "35x35"),
              (1 << 30, "71x71 and up"))


def zoo_params(sym, shape, seed):
    """Seeded numpy weights and BN statistics for ``sym`` at ``shape``
    (mxtpu's checkpoint naming): He-scaled convolutions, the classifier
    at 1/fan_in, gamma in U(0.5, 1.5), beta and biases in U(-0.1, 0.1),
    moving_mean N(0, 0.1), moving_var U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    params = {}
    for name, s in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        fan_in = int(np.prod(s[1:])) if len(s) > 1 else 1
        if name.endswith("_gamma"):
            w = rng.uniform(0.5, 1.5, s)
        elif name.endswith(("_beta", "_bias")):
            w = rng.uniform(-0.1, 0.1, s)
        elif name.startswith("fc"):
            w = rng.standard_normal(s) / np.sqrt(fan_in)
        else:
            w = rng.standard_normal(s) * np.sqrt(2.0 / fan_in)
        params["arg:" + name] = w.astype(np.float32)
    for name, s in zip(sym.list_auxiliary_states(), aux_shapes):
        w = rng.normal(0.0, 0.1, s) if name.endswith("_moving_mean") \
            else rng.uniform(0.5, 1.5, s)
        params["aux:" + name] = w.astype(np.float32)
    return params


def fused_site_shapes(mt, sym, shape):
    """The output shapes of the BatchNorms that the inference walk fuses
    with their ReLU (``executor._fusable_bn``), at input ``shape``."""
    from mxtpu_torch.executor import _fusable_bn
    topo = sym._topo()
    outs = {(id(n), i) for n, i in sym._outputs}
    consumers = {}
    for node in topo:
        for n, _ in node.inputs:
            consumers.setdefault(id(n), []).append(node)
    bns = [n for n in topo if not n.is_variable
           and _fusable_bn(n, consumers, outs) is not None]
    if not bns:
        return []
    return [tuple(s) for s in mt.sym.Group(
        [mt.symbol.Symbol([(n, 0)]) for n in bns]).infer_shape(
            data=shape)[1]]


def zoo_epilogue_planes(epi, site_shapes, gen, label):
    """The epilogue kernel timed alone at each fused site of one forward
    (f32, NCHW, no residual; each distinct shape once, weighted by its
    count), grouped by plane edge (``ZOO_PLANES``): launches, kernel ms,
    bytes bound ms and the share of the bound the kernel reaches."""
    from collections import Counter
    groups = {}
    for shape, count in sorted(Counter(site_shapes).items()):
        x, s, b, _ = epilogue_inputs(shape, 1, torch.float32, False, gen)
        ms = cuda_ms(lambda: epi.bn_apply_relu_add(x, s, b, axis=1),
                     ZOO["timed_iters"])
        bound = epilogue_bound_ms(shape, 1, torch.float32, False)[0]
        key = next(k for edge, k in ZOO_PLANES if shape[2] <= edge)
        g = groups.setdefault(key, dict(launches=0, ms=0.0, bound_ms=0.0,
                                        shapes=[]))
        g["launches"] += count
        g["ms"] += count * ms
        g["bound_ms"] += count * bound
        g["shapes"].append([list(shape), count, ms, bound])
    for key, g in groups.items():
        g["bound_share"] = g["bound_ms"] / g["ms"]
        log("  %s epilogue sites %-13s: %3d launches, kernel %.4f ms, bound "
            "%.4f ms (bytes), at %.1f%% of the bound"
            % (label, key, g["launches"], g["ms"], g["bound_ms"],
               100.0 * g["bound_share"]))
    return groups


def zoo_symbolic(mt, epi, seed, card, gen):
    """Each symbolic model of ``ZOO_SYMBOLIC`` served at B=32 through
    ``Module.predict`` on gpu(0) from seeded weights: probabilities
    finite and summing to 1, the epilogue once per fused site, the first
    ``cpu_rows`` rows within 1e-4 of a cpu() Predictor's, the evaluation
    forward against the plain epilogue (``eval_forward_gate``); then the
    epilogue alone at the model's sites by plane size."""
    b, r = ZOO["batch"], ZOO["cpu_rows"]
    quiet = _quiet_logger()
    rows = {}
    for i, (name, edge, sites) in enumerate(ZOO_SYMBOLIC):
        sym = getattr(mt.models, name).get_symbol(num_classes=1000)
        shape = (b, 3, edge, edge)
        params = zoo_params(sym, shape, seed + i)
        args, auxs = mt.model.split_params(
            {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params.items()}, "")
        rng = np.random.default_rng(seed + 20 + i)
        x = rng.standard_normal(shape, dtype=np.float32)
        y = rng.integers(0, 1000, b).astype(np.float32)
        it = mt.io.NDArrayIter(x, y, batch_size=b)
        mod = mt.mod.Module(sym, context=mt.gpu(0), logger=quiet)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
                 for_training=False)
        mod.set_params(args, auxs)
        mod.predict(it)  # cuDNN's first calls
        torch.cuda.synchronize()
        epi.bn_apply_relu_add.launches = 0  # count the main path alone
        t0 = time.perf_counter()
        pred = mod.predict(it)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = epi.bn_apply_relu_add.launches
        fused = mod._exec_group.execs[0].fused_sites
        out = pred._data
        dev = float((out.double().sum(dim=1) - 1).abs().max())
        cpu_pred = mt.Predictor(sym.tojson(), params, ctx=mt.cpu(),
                                input_shapes={"data": (r,) + shape[1:]})
        cpu_pred.forward(data=x[:r])
        cpu_err = float(np.abs(out[:r].cpu().numpy()
                               - cpu_pred.get_outputs()[0]).max())
        log("  [%s] %s at %dx%d, B=%d: predict %.2f ms (%.1f images/s); "
            "%d fused sites, epilogue launches %d; rows sum to 1 +- %.2e; "
            "gpu vs cpu Predictor on %d rows max abs err %.3e"
            % (card, name, edge, edge, b, secs * 1e3, b / secs, fused,
               launches, dev, r, cpu_err))
        if tuple(pred.shape) != (b, 1000) or \
                not bool(torch.isfinite(out).all()) or dev > 1e-4:
            raise AssertionError("%s predict: shape %s, rows sum to 1 +- %g"
                                 % (name, pred.shape, dev))
        if fused != sites or launches != sites:
            raise AssertionError("%s: %d fused sites, %d epilogue launches "
                                 "(want %d)" % (name, fused, launches, sites))
        if not cpu_err <= 1e-4:
            raise AssertionError("%s on the card disagrees with the cpu "
                                 "Predictor: %g" % (name, cpu_err))
        batch = mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                [mt.nd.array(y, ctx=mt.cpu())])

        def forward():
            mod.forward(batch, is_train=False)
            return mod.get_outputs()[0]._data

        row = dict(edge=edge, predict_ms=secs * 1e3, launches=launches,
                   cpu_err=cpu_err)
        row.update(eval_forward_gate(
            epi, forward, lambda: mod._exec_group.execs[0].fused_sites,
            "%s evaluation forward" % name, expect=sites))
        row["planes"] = zoo_epilogue_planes(
            epi, fused_site_shapes(mt, sym, shape), gen, name)
        rows[name] = row
        del mod, cpu_pred, pred, out
        torch.cuda.empty_cache()
    return rows


def zoo_training(mt, seed, card):
    """inception_v3 (299x299, 1000 classes) through ``Module.fit`` on
    gpu(0): ``train_steps`` SGD steps at B=32 (lr 0.01, momentum 0.9)
    from seeded weights over seeded images; the cross-entropy finite at
    every step and every weight moved."""
    b, n = ZOO["batch"], ZOO["train_steps"]
    sym = mt.models.inception_v3.get_symbol(num_classes=1000)
    params = zoo_params(sym, (b, 3, 299, 299), seed)
    args, auxs = mt.model.split_params(
        {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params.items()}, "")
    rng = np.random.default_rng(seed + 30)
    x = rng.random((n * b, 3, 299, 299), dtype=np.float32)
    y = rng.integers(0, 1000, n * b).astype(np.float32)
    mod = mt.mod.Module(sym, context=mt.gpu(0), logger=_quiet_logger())
    ce, stamps = [], []

    def record(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        ce.append(param.eval_metric.get()[1])
        param.eval_metric.reset()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=b), num_epoch=1,
            eval_metric="ce", optimizer="sgd",
            optimizer_params={"learning_rate": ZOO["lr"],
                              "momentum": ZOO["momentum"],
                              "rescale_grad": 1.0 / b},
            arg_params=args, aux_params=auxs, batch_end_callback=record,
            metric_sync=1)
    ms = [float(v) for v in np.diff([t0] + stamps) * 1e3]
    trained, trained_aux = mod.get_params()
    # gammas under fix_gamma take no step
    weights = [k for k in args if k.endswith(("_weight", "_bias"))]
    still = [k for k in weights
             if np.array_equal(trained[k].asnumpy(), args[k].asnumpy())]
    stats_still = [k for k, v in auxs.items()
                   if np.array_equal(trained_aux[k].asnumpy(), v.asnumpy())]
    log("  [%s] inception_v3 Module.fit, %d SGD steps at B=%d: "
        "cross-entropy %s, step ms %s; weights unmoved %d of %d, moving "
        "statistics unmoved %d of %d" % (card, n, b, [round(v, 4) for v in ce],
                                         [round(v, 1) for v in ms],
                                         len(still), len(weights),
                                         len(stats_still), len(auxs)))
    if len(ce) != n or not np.all(np.isfinite(ce)) or still or stats_still:
        raise AssertionError("inception_v3 training: cross-entropy %s, "
                             "unmoved %s %s" % (ce, still[:3],
                                                stats_still[:3]))
    return dict(ce=ce, step_ms=ms)


def zoo_gluon(mt, epi, seed, card):
    """Each net of ``ZOO_GLUON`` from ``get_model`` (1000 classes), Xavier
    on gpu(0), hybridized: one inference forward at B=32 (finite, the
    epilogue once per fused site, equal to the plain epilogue); then
    ``gluon_steps`` SGD ``Trainer.step``s of densenet121 at B=32 (the
    loss finite, every weight and moving statistic moved)."""
    b = ZOO["batch"]
    v = mt.gluon.model_zoo.vision
    rows = {}
    for i, (name, edge, sites) in enumerate(ZOO_GLUON):
        np.random.seed(seed + i)
        net = v.get_model(name)
        net.initialize(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                      magnitude=2), ctx=mt.gpu(0))
        net.hybridize()
        rng = np.random.default_rng(seed + 40 + i)
        x = mt.nd.array(rng.standard_normal((b, 3, edge, edge),
                                            dtype=np.float32), ctx=mt.gpu(0))
        out = net(x)._data  # shapes resolved, cuDNN's first calls
        torch.cuda.synchronize()
        if tuple(out.shape) != (b, 1000) or not bool(
                torch.isfinite(out).all()):
            raise AssertionError("gluon %s: output %s not finite"
                                 % (name, tuple(out.shape)))
        rows[name] = eval_forward_gate(
            epi, lambda: net(x)._data, lambda: net.fused_sites,
            "[%s] gluon %s at %dx%d" % (card, name, edge, edge),
            expect=sites)
        if name == "densenet121":
            rows[name]["train"] = zoo_gluon_steps(mt, net, x, rng, card)
        del net, x, out
        torch.cuda.empty_cache()
    return rows


def zoo_gluon_steps(mt, net, x, rng, card):
    b = ZOO["batch"]
    y = mt.nd.array(rng.integers(0, 1000, b).astype(np.float32),
                    ctx=mt.gpu(0))
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": ZOO["lr"], "momentum": ZOO["momentum"]})
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    before = {k: p.data(mt.gpu(0))._data.clone()
              for k, p in net.collect_params().items()}
    losses, ms = [], []
    for _ in range(ZOO["gluon_steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(b)
        losses.append(float(loss.mean().asscalar()))
        ms.append((time.perf_counter() - t0) * 1e3)
    checked = {k: p for k, p in net.collect_params().items()
               if k.endswith(("weight", "running_mean", "running_var"))}
    still = [k for k, p in checked.items()
             if torch.equal(before[k], p.data(mt.gpu(0))._data)]
    log("  [%s] gluon densenet121, %d Trainer steps at B=%d: loss %s, step "
        "ms %s, weights and moving statistics unmoved %d of %d"
        % (card, len(losses), b, [round(v, 4) for v in losses],
           [round(v, 1) for v in ms], len(still), len(checked)))
    if not np.all(np.isfinite(losses)) or still:
        raise AssertionError("densenet121 Trainer steps: loss %s, unmoved "
                             "%s" % (losses, still[:3]))
    return dict(losses=losses, step_ms=ms)


def zoo_ops(mt, card):
    """Every case of ``tests/op_tranche_cases.py`` (the 97 names of the
    tranche: out-of-range indices, ties, NaN, integer and float16 inputs)
    on CUDA tensors against cpu(): the same dtypes, NaN and infinity
    positions, integers equal, floats within 1e-5 (forward) and 1e-4
    (gradient) of the largest; the context synchronized after each, so a
    device assert fails the case that set it off. Then Gluon's
    Conv2DTranspose on gpu(0) against cpu() from the same weights."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from op_tranche_cases import CASES

    def run(name, arrays, attrs, diff, device):
        xs = [torch.from_numpy(a.copy()).to(device) for a in arrays]
        for i in diff:
            xs[i].requires_grad_()
        op = mt.ops.registry.get_op(name)
        outs = op.apply(op.parse_attrs(dict(attrs)), xs, device)
        grads = []
        if diff and outs[0].requires_grad:
            head = torch.from_numpy(np.asarray(np.random.RandomState(7).randn(
                *outs[0].shape), np.float32)).to(device, outs[0].dtype)
            grads = [g for g in torch.autograd.grad(
                outs[0], [xs[i] for i in diff], head, allow_unused=True)
                if g is not None]
        return [t.detach().cpu() for t in list(outs) + grads], len(outs)

    def err(got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            return float("inf")
        if not want.is_floating_point():
            return 0.0 if torch.equal(got, want) else float("inf")
        g, w = got.double(), want.double()
        odd = torch.isnan(w) | torch.isinf(w)
        if not torch.equal(torch.isnan(g), torch.isnan(w)) or \
                not torch.equal(g[torch.isinf(w)], w[torch.isinf(w)]):
            return float("inf")
        if not bool((~odd).any()):
            return 0.0
        return float((g[~odd] - w[~odd]).abs().max()) / max(
            1.0, float(w[~odd].abs().max()))

    worst = {"forward": 0.0, "gradient": 0.0}
    names = set()
    card_dev = mt.gpu(0).torch_device
    for name, arrays, attrs, diff in CASES:
        got, n_out = run(name, arrays, attrs, diff, card_dev)
        torch.cuda.synchronize()
        want, _ = run(name, arrays, attrs, diff, "cpu")
        if len(got) != len(want):
            raise AssertionError("%s %s: %d results on the card, %d on cpu"
                                 % (name, attrs, len(got), len(want)))
        for j, (g, w) in enumerate(zip(got, want)):
            kind = "forward" if j < n_out else "gradient"
            e = err(g, w)
            worst[kind] = max(worst[kind], e)
            if not e <= (1e-5 if kind == "forward" else 1e-4):
                raise AssertionError("%s %s on the card: %s error %g"
                                     % (name, attrs, kind, e))
        names.add(name)
    torch.backends.cudnn.allow_tf32 = False
    wx = [np.random.RandomState(s).randn(*shape).astype(np.float32)
          for s, shape in ((0, (2, 4, 7, 6)), (1, (4, 3, 3, 3)), (2, (6,)))]

    def deconv(ctx):
        with ctx:
            layer = mt.gluon.nn.Conv2DTranspose(
                6, 3, strides=2, padding=1, output_padding=1, groups=2,
                in_channels=4)
            layer.initialize(ctx=ctx)
            layer.weight.set_data(mt.nd.array(wx[1], ctx=ctx))
            layer.bias.set_data(mt.nd.array(wx[2], ctx=ctx))
            return layer(mt.nd.array(wx[0], ctx=ctx))._data.cpu()

    deconv_err = err(deconv(mt.gpu(0)), deconv(mt.cpu()))
    log("  [%s] op tranche: %d cases of %d op names on CUDA tensors vs cpu: "
        "worst forward error %.3e, gradient %.3e (of the largest); "
        "Conv2DTranspose gpu vs cpu %.3e" % (card, len(CASES), len(names),
                                             worst["forward"],
                                             worst["gradient"], deconv_err))
    if not deconv_err <= 1e-5:
        raise AssertionError("Conv2DTranspose on the card: %g" % deconv_err)
    return dict(cases=len(CASES), names=len(names), deconv_err=deconv_err,
                **{"worst_%s" % k: v for k, v in worst.items()})


def phase_zoo(mt, epi, seed, card):
    """Phase 15 (module docstring): the symbolic models served and their
    epilogue sites timed, inception_v3 trained, the Gluon zoo, the op
    tranche; with the phase's seconds and its epilogue launches by
    path."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    row = {"symbolic": zoo_symbolic(mt, epi, seed, card, gen),
           "train": zoo_training(mt, seed, card),
           "gluon": zoo_gluon(mt, epi, seed, card),
           "ops": zoo_ops(mt, card)}
    sym, glu = row["symbolic"].values(), row["gluon"].values()
    row["launches"] = {
        "zoo_predict": sum(r["launches"] for r in sym),
        "zoo_eval": sum(r["eval_launches"] for r in sym),
        "zoo_gluon_eval": sum(r["eval_launches"] for r in glu)}
    row["seconds"] = time.perf_counter() - t0
    log("  [%s] zoo phase %.1f s; epilogue launches %s"
        % (card, row["seconds"], row["launches"]))
    return row


# ---------------------------------------------------------------- phase 16
def roi_inputs(seed, rois, channels, shape, image, pooled, device="cuda"):
    """ROIPooling's inputs at the Faster R-CNN's stage-2 shape: a ReLU'd 2
    x C x H x W map (most bins tie at zero) and ROIs in image pixels, a
    quarter with corners on multiples of 8 (.5 after the 1/16 scale: the
    half-to-even case)."""
    rng = np.random.RandomState(seed)
    data = np.maximum(rng.randn(2, channels, *shape), 0).astype(np.float32)
    h, w = image
    x1 = rng.uniform(-20, w - 40, rois)
    y1 = rng.uniform(-20, h - 40, rois)
    boxes = np.stack([rng.randint(0, 2, rois), x1, y1,
                      x1 + rng.uniform(8, w / 2, rois),
                      y1 + rng.uniform(8, h / 2, rois)], 1)
    boxes = boxes.astype(np.float32)
    boxes[::4, 1:] = np.round(boxes[::4, 1:] / 8) * 8
    return (torch.from_numpy(data).to(device),
            torch.from_numpy(boxes).to(device), pooled, 1 / 16)


def roi_large_window_inputs(seed, device="cuda"):
    """One ROI over the whole of a ReLU'd 1 x 8 x 160 x 240 map at 1/1,
    7x7 bins of ~23 x 34 pixels: a window larger than the forward's
    staged tile, walked in row bands."""
    rng = np.random.RandomState(seed)
    data = np.maximum(rng.randn(1, 8, 160, 240) - 0.5, 0).astype(np.float32)
    rois = np.array([[0, 0, 0, 239, 159]], np.float32)
    return (torch.from_numpy(data).to(device),
            torch.from_numpy(rois).to(device), (7, 7), 1.0)


def roi_covered(data, rois, pooled, scale):
    """The map pixels (n, y, x) that some bin of some ROI covers, from the
    bins' own bounds (``spatial._roi_bins``): a ROI's bins are the
    products of its row spans and its column spans, so they cover the
    union of its non-empty row spans by the union of its non-empty column
    spans."""
    from mxtpu_torch.ops import spatial
    N, _, H, W = data.shape
    rois = rois.detach().float()
    hs, he, ws, we = spatial._roi_bins(rois, pooled[0], pooled[1], scale,
                                       H, W)
    yy = torch.arange(H, dtype=rois.dtype, device=rois.device)
    xx = torch.arange(W, dtype=rois.dtype, device=rois.device)
    in_y = ((yy >= hs[..., None]) & (yy < he[..., None])).any(1)  # (R, H)
    in_x = ((xx >= ws[..., None]) & (xx < we[..., None])).any(1)  # (R, W)
    bidx = spatial._batch_index(rois[:, 0], N)
    hit = torch.zeros((N, H, W), dtype=torch.bool, device=rois.device)
    for n in range(N):
        mine = bidx == n
        hit[n] = (in_y[mine][:, :, None] & in_x[mine][:, None, :]).any(0)
    return int(hit.sum())


def roi_bytes(data, rois, pooled, scale):
    """ROIPooling's bytes on these inputs. The function's least: the
    forward reads each map pixel that some bin covers (every channel) and
    the ROIs and writes the max; the backward reads dy, those pixels
    (each bin's max and tie count follow from them again) and the ROIs
    and writes the whole dx. This route's: the forward the same; the
    backward's first launch reads dy, the covered pixels and the ROIs and
    writes each bin's (max, share) pair and each ROI's bin table, its
    second reads the tables, the whole map and the pairs and writes
    dx."""
    N, C, H, W = data.shape
    R = rois.shape[0]
    ph, pw = pooled
    out = R * C * ph * pw * 4
    covered = roi_covered(data, rois, pooled, scale)
    pixels = covered * C * 4
    rb = rois.numel() * 4
    table = R * (5 + 2 * ph + 2 * pw) * 4
    whole = N * C * H * W * 4
    return {"covered_pixels": covered,
            "covered_share": covered / float(N * H * W),
            "fwd": pixels + rb + out, "bwd": out + pixels + rb + whole,
            "route_fwd": pixels + rb + out,
            "route_bwd": (out + pixels + rb + 2 * out + table)
            + (table + whole + 2 * out + whole)}


def roi_bound_ms(data, rois, pooled, scale):
    """roi_bytes at 3.35 TB/s: (bound, bwd_bound, route, bwd_route) in
    ms."""
    nb = roi_bytes(data, rois, pooled, scale)
    return tuple(nb[k] / HBM_BYTES_PER_S * 1e3
                 for k in ("fwd", "bwd", "route_fwd", "route_bwd"))


def roi_takes_tie_count(src):
    """Whether the roi_pooling.cu at ``src`` has the earlier interface, in
    which ``roi_pool_forward`` also takes an int32 tie count."""
    with open(src) as f:
        text = f.read()
    head = text[text.index("int roi_pool_forward("):]
    return "count" in head[:head.index(")")]


def roi_binding(lib, tie_count):
    """ctypes bindings of a built roi_pooling library on tensors, on the
    current stream: ``forward(data, rois, pooled, scale)`` -> (out,
    count) and ``backward(dy, data, rois, scale, out, count)`` -> dx.
    Without ``tie_count``, this tree's interface (the max alone, count
    None; the backward's (max, share) and table scratch); with it, the
    earlier one (the forward also writes an int32 tie count, the backward
    reads it with the max)."""
    import ctypes
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shared = not tie_count
    fwd, bwd = lib.roi_pool_forward, lib.roi_pool_backward
    fwd.argtypes = [P] * (3 if shared else 4) + [I] * 7 + [F, P]
    bwd.argtypes = [P] * 6 + [I] * 7 + [F, P]
    fwd.restype = bwd.restype = I
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def forward(data, rois, pooled, scale):
        N, C, H, W = data.shape
        R = rois.shape[0]
        out = data.new_empty((R, C) + tuple(pooled))
        ptrs = [data.data_ptr(), rois.data_ptr(), out.data_ptr()]
        count = None
        if not shared:
            count = torch.empty(out.shape, dtype=torch.int32,
                                device=data.device)
            ptrs.append(count.data_ptr())
        rc = fwd(*ptrs, N, C, H, W, R, *pooled, float(scale), stream())
        if rc:
            raise AssertionError("roi_pool_forward: cuda error %d" % rc)
        return out, count

    def backward(dy, data, rois, scale, out, count):
        N, C, H, W = data.shape
        R, _, ph, pw = out.shape
        dx = torch.empty_like(data)
        if shared:
            kv = data.new_empty((R, ph, pw, C, 2))
            table = torch.empty((R, 5 + 2 * ph + 2 * pw), dtype=torch.int32,
                                device=data.device)
            ptrs = [dy, data, rois, kv, table, dx]
        else:
            ptrs = [dy, data, out, count, rois, dx]
        rc = bwd(*[t.data_ptr() for t in ptrs], N, C, H, W, R, ph, pw,
                 float(scale), stream())
        if rc:
            raise AssertionError("roi_pool_backward: cuda error %d" % rc)
        return dx

    return {"forward": forward, "backward": backward}


def roi_checked(spatial, data, rois, pooled, scale, seed, backward=True):
    """``roi_pool`` on the card against its plain version: the forward
    bit for bit; with ``backward``, the gradient under autograd within
    1e-6 of the plain version's largest, NaN where it is NaN, and
    bit-identical on repeat. Returns (out, dy, dx, forward err, backward
    err, the plain gradient's largest)."""
    x = data.clone().requires_grad_(backward)
    y = spatial.roi_pool(x, rois, pooled, scale)
    want = spatial.roi_pool_reference(data, rois, pooled, scale)
    torch.cuda.synchronize()
    out = y.detach()
    fwd_err = abs_err(out, want)
    if not torch.equal(out, want):
        raise AssertionError("roi_pooling forward differs from its plain "
                             "version: max abs err %g" % fwd_err)
    if not backward:
        return out, None, None, fwd_err, None, None
    dy = torch.randn(y.shape, generator=torch.Generator(
        device=data.device).manual_seed(seed), device=data.device)
    (g1,) = torch.autograd.grad(y, [x], dy, retain_graph=True)
    (g2,) = torch.autograd.grad(y, [x], dy)
    gw = spatial.roi_pool_backward_reference(data, rois, dy, pooled, scale)
    torch.cuda.synchronize()
    fin = ~torch.isnan(gw)
    bwd_err = abs_err(g1[fin], gw[fin])
    bwd_scale = float(gw[fin].abs().max()) if fin.any() else 0.0
    same = torch.equal(torch.nan_to_num(g1), torch.nan_to_num(g2))
    if bwd_err > 1e-6 * bwd_scale or not same or \
            not torch.equal(torch.isnan(g1), ~fin):
        raise AssertionError(
            "roi_pooling backward: max abs err %g against the plain "
            "version's largest %g (1e-6 allowed), NaN where it is NaN: %s, "
            "repeat bit-identical: %s"
            % (bwd_err, bwd_scale, torch.equal(torch.isnan(g1), ~fin), same))
    return out, dy, g1.detach(), fwd_err, bwd_err, bwd_scale


def roi_launch_ms(step):
    """Device ms of the backward's two kernels, each the mean of its
    launches in four profiled ``step()``s (backward calls), by kernel
    name (None where the profiler saw none: it may drop a session's first
    launch)."""
    names = {"roi_bins_kernel": "share", "roi_pool_gather_kernel": "gather"}

    def steps():
        for _ in range(4):
            step()

    prof = profiled(steps)
    seen = {}
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        for key, label in names.items():
            if key in e.name:
                n, ms = seen.get(label, (0, 0.0))
                seen[label] = (n + 1, ms + e.device_time_total / 1e3)
    return {label: seen[label][1] / seen[label][0] if label in seen
            else None for label in names.values()}


def roi_case_timed(spatial, name, inputs, seed, iters, backward, card):
    """One ROIPooling case checked (``roi_checked``) and timed: each call
    alone (CUDA events) beside its plain version's and its bytes bound
    (``roi_bytes`` on these inputs)."""
    data, rois, pooled, scale = inputs
    _, dy, _, fwd_err, bwd_err, bwd_scale = roi_checked(
        spatial, data, rois, pooled, scale, seed, backward)
    nb = roi_bytes(data, rois, pooled, scale)
    bound, bwd_bound, route, bwd_route = roi_bound_ms(data, rois, pooled,
                                                      scale)
    ms = cuda_ms(lambda: spatial._roi_forward_cuda(data, rois, *pooled,
                                                   scale), iters)
    plain_ms = cuda_ms(lambda: spatial.roi_pool_reference(
        data, rois, pooled, scale), 2, warmup=1)
    row = {"shape": {"data": list(data.shape), "rois": rois.shape[0],
                     "pooled": list(pooled), "scale": scale},
           "covered_share": nb["covered_share"],
           "max_abs_err": fwd_err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": "bytes", "route_ms": route,
           "library_ms": None}
    line = ("  [%s] roi_pooling %s at R=%d, %s, %s (%.1f %% of the map "
            "covered): forward %.4f ms (plain %.2f, bound %.4f, route %.4f, "
            "bytes: %.1f %% of the bound), max abs err %g"
            % (card, name, rois.shape[0], list(data.shape), list(pooled),
               100 * nb["covered_share"], ms, plain_ms, bound, route,
               100 * bound / ms, fwd_err))
    if backward:
        bwd_ms = cuda_ms(lambda: spatial.roi_pool_backward(
            dy, data, rois, scale), iters)
        bwd_plain_ms = cuda_ms(lambda: spatial.roi_pool_backward_reference(
            data, rois, dy, pooled, scale), 2, warmup=1)
        row.update(bwd_max_abs_err=bwd_err, bwd_ms=bwd_ms,
                   bwd_plain_ms=bwd_plain_ms, bwd_bound_ms=bwd_bound,
                   bwd_bound_by="bytes", bwd_route_ms=bwd_route)
        line += ("; backward %.4f ms (plain %.2f, bound %.4f, route %.4f: "
                 "%.1f %% of the bound), max abs err %g of %g, repeat "
                 "bit-identical" % (bwd_ms, bwd_plain_ms, bwd_bound,
                                    bwd_route, 100 * bwd_bound / bwd_ms,
                                    bwd_err, bwd_scale))
    log(line + "; no library call (the card has no torchvision)")
    return row


def roi_against_parent(spatial, kernels, inputs, seed, iters, card):
    """An earlier tree's ROIPooling kernels (``--parent``) on the training
    shape's inputs: its backward against this tree's bit for bit (the
    same terms summed in the same order), and both pairs timed in turns
    (parent, this, this, parent)."""
    data, rois, pooled, scale = inputs
    out, dy, dx, *_ = roi_checked(spatial, data, rois, pooled, scale, seed)
    p_out, p_count = kernels["forward"](data, rois, pooled, scale)
    p_dx = kernels["backward"](dy, data, rois, scale, p_out, p_count)
    torch.cuda.synchronize()
    same_fwd = torch.equal(p_out, out)
    same_bwd = torch.equal(p_dx.view(torch.int32), dx.view(torch.int32))
    fwd_p, fwd_t = in_turns(
        lambda: kernels["forward"](data, rois, pooled, scale),
        lambda: spatial._roi_forward_cuda(data, rois, *pooled, scale), iters)
    bwd_p, bwd_t = in_turns(
        lambda: kernels["backward"](dy, data, rois, scale, p_out, p_count),
        lambda: spatial.roi_pool_backward(dy, data, rois, scale), iters)
    row = {"forward_bits_equal": same_fwd, "backward_bits_equal": same_bwd,
           "forward_ms": {"parent": fwd_p, "this": fwd_t},
           "backward_ms": {"parent": bwd_p, "this": bwd_t}}
    log("  [%s] roi_pooling against the parent: forward bit for bit %s, "
        "backward bit for bit %s; forward ms parent %s, this %s; backward "
        "ms parent %s, this %s" % (card, same_fwd, same_bwd,
                                   [round(v, 4) for v in fwd_p],
                                   [round(v, 4) for v in fwd_t],
                                   [round(v, 4) for v in bwd_p],
                                   [round(v, 4) for v in bwd_t]))
    if not (same_fwd and same_bwd):
        raise AssertionError("roi_pooling differs from the parent's kernels: "
                             "forward %s, backward %s" % (same_fwd, same_bwd))
    return row


def roi_kernel_timed(mt, seed, card, parents=()):
    """The ROIPooling kernels against their plain version, through the
    wrapper the path calls (``roi_pool`` under autograd; ``roi_checked``),
    at the training shape, the test forward's 600 ROIs (forward only) and
    one large window; then CUDA-event ms of each call alone beside the
    plain versions' and the bytes bounds, the earlier kernels' times
    beside (``ROI_EARLIER_MS``), the
    backward's device ms by launch at the training shape, and, with
    ``--parent``, the parent's kernels in turns. Its launches are not the
    path's: the caller reads the path's counts before this runs."""
    from mxtpu_torch.ops import spatial
    cfg = ROI_TIMED
    iters = cfg["iters"]
    train = roi_inputs(seed + 16, cfg["rois"], cfg["channels"], cfg["shape"],
                       cfg["image"], cfg["pooled"])
    test = roi_inputs(seed + 17, cfg["test_rois"], cfg["channels"],
                      cfg["shape"], cfg["image"], cfg["pooled"])
    row = roi_case_timed(spatial, "training", train, seed, iters, True, card)
    row["test_forward"] = roi_case_timed(spatial, "test forward", test,
                                         seed, iters, False, card)
    row["large_window"] = roi_case_timed(
        spatial, "large window", roi_large_window_inputs(seed + 18), seed,
        iters, True, card)
    data, rois, pooled, scale = train
    dy = torch.randn((rois.shape[0], data.shape[1]) + tuple(pooled),
                     device=data.device)
    row["bwd_launch_ms"] = roi_launch_ms(
        lambda: spatial.roi_pool_backward(dy, data, rois, scale))
    row["earlier_ms"] = ROI_EARLIER_MS
    log("  [%s] roi_pooling at the training shape: forward %.4f ms (earlier "
        "%.4f), backward %.4f ms (earlier %.4f; by launch %s); %.1f %% and "
        "%.1f %% of the bytes bounds %.4f and %.4f ms"
        % (card, row["ms"], ROI_EARLIER_MS["forward"], row["bwd_ms"],
           ROI_EARLIER_MS["backward"], row["bwd_launch_ms"],
           100 * row["bound_ms"] / row["ms"],
           100 * row["bwd_bound_ms"] / row["bwd_ms"], row["bound_ms"],
           row["bwd_bound_ms"]))
    for p in parents:
        if "roi_pooling" in p.kernels:
            row.setdefault("parents", {})[p.csrc] = roi_against_parent(
                spatial, p.kernels["roi_pooling"], train, seed, iters, card)
    return row


class SweepByK:
    """Stands in for ``spatial.nms_keep`` (the name Proposal calls) and
    records the K of each call before calling the real wrapper, whose own
    count is the launch count."""

    def __init__(self, real):
        self.real = real
        self.calls = []

    def __call__(self, boxes, *args, **kwargs):
        self.calls.append(int(boxes.shape[1]))
        return self.real(boxes, *args, **kwargs)


class StageTwoLabels:
    """Wraps ``rcnn.ProposalTarget.forward`` to keep the last stage-2
    labels it assigned, for the stage-2 cross-entropy of the combined
    loss (the graph does not output them), and the host ms of each
    call."""

    def __init__(self, rcnn):
        self.cls = rcnn.ProposalTarget
        self.real = self.cls.forward
        self.labels = None
        self.ms = []
        keep = self

        def forward(op, is_train, req, in_data, out_data, aux):
            t0 = time.perf_counter()
            keep.real(op, is_train, req, in_data, out_data, aux)
            keep.ms.append((time.perf_counter() - t0) * 1e3)
            keep.labels = out_data[1].asnumpy().copy()

        self.cls.forward = forward

    def close(self):
        self.cls.forward = self.real


def rcnn_losses(outs, labels, rpn_label, cfg):
    """(RPN cross-entropy over the labelled anchors, RPN box loss,
    stage-2 cross-entropy, stage-2 box loss, the combined loss with each
    term scaled as its gradient is)."""
    prob = outs[0]  # (N, 2, A*H*W)
    lab = rpn_label.astype(np.int64)
    keep = lab >= 0
    p = np.take_along_axis(prob, np.where(keep, lab, 0)[:, None], 1)[:, 0]
    rpn_ce = float(-np.log(np.maximum(p[keep], 1e-12)).mean())
    rpn_box = float(outs[1])
    cls = outs[2]
    s2 = labels.astype(np.int64)
    cls_ce = float(-np.log(np.maximum(cls[np.arange(len(s2)), s2],
                                      1e-12)).mean())
    box = float(outs[3])
    combined = (rpn_ce + rpn_box * cfg["rpn_grad_scale"] + cls_ce
                + box / cfg["rois_per_img"])
    return rpn_ce, rpn_box, cls_ce, box, combined


def rcnn_training(mt, rcnn, spatial, contrib, seed, card):
    """The "vgg16" Faster R-CNN trained through Module on gpu(0) (module
    docstring, phase 16); returns the row and the trained module."""
    cfg = rcnn.CONFIGS[RCNN["config"]]
    n = RCNN["batch"]
    sym = rcnn.build_train_symbol(cfg)
    mod = mt.mod.Module(sym, context=mt.gpu(0), data_names=rcnn.DATA_NAMES,
                        label_names=rcnn.LABEL_NAMES,
                        fixed_param_names=rcnn.fixed_params(cfg, sym))
    mod.bind(data_shapes=rcnn.data_shapes(cfg, n),
             label_shapes=rcnn.label_shapes(cfg, n))
    np.random.seed(seed)
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": RCNN["lr"], "momentum": RCNN["momentum"],
        "wd": RCNN["wd"]})
    n_params = sum(int(v.size) for v in mod.get_params()[0].values())
    arrays = rcnn.make_batch(np.random.RandomState(seed + 16), n, cfg)
    batch = rcnn.batch_of(arrays, mt.cpu())
    labels = StageTwoLabels(rcnn)
    sweep = SweepByK(spatial.nms_keep)
    spatial.nms_keep = sweep
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        spatial.roi_pool.launches = 0
        spatial.roi_pool_backward.launches = 0
        contrib.nms_keep.launches = 0
        losses, ms = [], []
        steps = RCNN["fall_steps"] + RCNN["timed_steps"]
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.forward_backward(batch)
            mod.update()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            outs = [o.asnumpy() for o in mod.get_outputs()]
            if i < RCNN["fall_steps"]:
                losses.append(rcnn_losses(outs, labels.labels, arrays[2],
                                          cfg))
        launches = {"roi_pooling_fwd": spatial.roi_pool.launches,
                    "roi_pooling_bwd": spatial.roi_pool_backward.launches,
                    "multibox_nms": contrib.nms_keep.launches,
                    "nms_K": sorted(set(sweep.calls))}
        peak = torch.cuda.max_memory_allocated()
    finally:
        spatial.nms_keep = sweep.real
        labels.close()

    def step():
        mod.forward_backward(batch)
        mod.update()

    busy = step_kernels(step).get(0, (0, 0.0))
    timed = ms[RCNN["fall_steps"]:]
    med = float(np.median(timed))
    t_custom = labels.ms[RCNN["fall_steps"]:]
    combined = [v[4] for v in losses]
    row = {"config": RCNN["config"], "batch": n,
           "image": list(cfg["image"]),
           "parameters": n_params, "losses": losses, "combined": combined,
           "step_ms": med, "step_ms_all": ms, "launches": launches,
           "device_launches": busy[0], "device_ms": busy[1],
           "busy_share": busy[1] / med, "proposal_target_host_ms": t_custom,
           "peak_memory": int(peak)}
    log("  [%s] Faster R-CNN %s at %dx%d, B=%d, %.2f M parameters: "
        "losses (rpn CE, rpn box, rcnn CE, rcnn box, combined) by step %s"
        % (card, RCNN["config"], cfg["image"][0], cfg["image"][1], n,
           n_params / 1e6, [[round(x, 4) for x in v] for v in losses]))
    log("  [%s] step %.1f ms (median of %d; all %s); profiled step %d "
        "kernel launches, %.1f ms of device time (busy %.1f %%); "
        "proposal_target's host forward %s ms; peak memory %.2f GB; "
        "launches %s" % (card, med, len(timed),
                         [round(v, 1) for v in ms], busy[0], busy[1],
                         100 * busy[1] / med,
                         [round(v, 2) for v in t_custom], peak / 1e9,
                         launches))
    if not all(np.isfinite(v).all() for v in losses):
        raise AssertionError("rcnn: a loss is not finite: %s" % losses)
    if not combined[-1] < combined[0]:
        raise AssertionError("rcnn: the combined loss did not fall over %d "
                             "steps of one batch: %s"
                             % (len(combined), combined))
    per_step = [launches[k] for k in ("roi_pooling_fwd", "roi_pooling_bwd",
                                      "multibox_nms")]
    if per_step != [steps] * 3 or launches["nms_K"] != [cfg["pre_nms_train"]]:
        raise AssertionError("rcnn: %d training steps launched %s: one "
                             "ROIPooling forward and backward and one sweep "
                             "at K = %d a step expected"
                             % (steps, launches, cfg["pre_nms_train"]))
    return row, mod


def rcnn_test_forward(mt, rcnn, spatial, contrib, trained, seed, card):
    """The test symbol's forward on 2 images from the trained weights:
    Proposal at 6,000 / 300, so 600 ROIs; probabilities finite and summing
    to 1; one ROIPooling forward and one sweep at K = 6,000."""
    cfg = rcnn.CONFIGS[RCNN["config"]]
    n = RCNN["batch"]
    mod = mt.mod.Module(rcnn.build_test_symbol(cfg), context=mt.gpu(0),
                        data_names=rcnn.DATA_NAMES, label_names=None)
    mod.bind(data_shapes=rcnn.data_shapes(cfg, n), for_training=False)
    mod.set_params(*trained.get_params())
    x, info = rcnn.make_batch(np.random.RandomState(seed + 77), n, cfg)[:2]
    batch = mt.io.DataBatch(data=[mt.nd.array(x, ctx=mt.cpu()),
                                  mt.nd.array(info, ctx=mt.cpu())],
                            label=[], pad=0, index=None)
    sweep = SweepByK(spatial.nms_keep)
    spatial.nms_keep = sweep
    try:
        spatial.roi_pool.launches = 0
        contrib.nms_keep.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward(batch, is_train=False)
        rois, prob, deltas = [o.asnumpy() for o in mod.get_outputs()]
        ms = (time.perf_counter() - t0) * 1e3
        launches = {"roi_pooling_fwd": spatial.roi_pool.launches,
                    "multibox_nms": contrib.nms_keep.launches,
                    "nms_K": sorted(set(sweep.calls))}
    finally:
        spatial.nms_keep = sweep.real
    post = cfg["post_nms_test"]
    row = {"rois": list(rois.shape), "cls_prob": list(prob.shape),
           "bbox_pred": list(deltas.shape), "ms": ms, "launches": launches}
    log("  [%s] test forward: rois %s, cls_prob %s, bbox_pred %s in %.1f "
        "ms; launches %s" % (card, rois.shape, prob.shape, deltas.shape, ms,
                             launches))
    finite = np.isfinite(prob).all() and np.isfinite(deltas).all()
    if rois.shape != (n * post, 5) or prob.shape[0] != n * post or \
            not finite or not np.allclose(prob.sum(1), 1.0, atol=1e-5):
        raise AssertionError("rcnn test forward: rois %s, probabilities "
                             "finite %s" % (rois.shape,
                                            np.isfinite(prob).all()))
    if launches != {"roi_pooling_fwd": 1, "multibox_nms": 1,
                    "nms_K": [cfg["pre_nms_test"]]}:
        raise AssertionError("rcnn test forward launched %s" % launches)
    return row


def phase_rcnn(mt, seed, card, parents=()):
    """Phase 16 (module docstring): the Faster R-CNN trained and tested,
    then the ROIPooling kernel alone."""
    from mxtpu_torch.models import rcnn
    from mxtpu_torch.ops import contrib, spatial
    t0 = time.perf_counter()
    res = {}
    res["training"], trained = rcnn_training(mt, rcnn, spatial, contrib,
                                             seed, card)
    res["test"] = rcnn_test_forward(mt, rcnn, spatial, contrib, trained,
                                    seed, card)
    del trained
    torch.cuda.empty_cache()
    tr, te = res["training"]["launches"], res["test"]["launches"]
    res["launches"] = {
        "roi_pooling": {"rcnn_train_fwd": tr["roi_pooling_fwd"],
                        "rcnn_train_bwd": tr["roi_pooling_bwd"],
                        "rcnn_test_fwd": te["roi_pooling_fwd"]},
        "nms": {"rcnn_train_K%d" % tr["nms_K"][0]: tr["multibox_nms"],
                "rcnn_test_K%d" % te["nms_K"][0]: te["multibox_nms"]},
        "epilogue": {"rcnn": 0}}  # VGG16 has no BatchNorm
    res["roi_pooling"] = roi_kernel_timed(mt, seed, card, parents)
    res["seconds"] = time.perf_counter() - t0
    log("  [%s] rcnn phase %.1f s; launches %s"
        % (card, res["seconds"], res["launches"]))
    return res


#: the LSTM-OCR of examples/ctc/lstm_ocr.py at its defaults: 3,072
#: strips (seed 11), 90 % to train (2,764: 87 steps of B=32, the last
#: padded), two LSTMCells of 64 over T=32 steps of 32 features, 11
#: classes, the blank first, Adam at 0.01, Xavier; one epoch
CTC = dict(num_examples=3072, seed=11, num_hidden=64, batch=32, lr=0.01,
           epochs=1, window=5)
#: a speech-recognition CTC shape: 800 frames, 32 utterances, 28
#: characters and the blank, transcripts of 100-200 labels
CTC_SPEECH = dict(T=800, N=32, C=29, L=200, min_label=100)
CTC_TOL = 1e-5  # loss relative; gradient of the largest
CTC_ITERS = {"ocr": 50, "speech": 5}
#: the sparse example (examples/sparse/linear_classification.py) at its
#: defaults, and the dots at a click-through shape: 8,192 rows over
#: 1,000,000 hashed features, 20 non-zeros a row, a (1,000,000, 1) weight
SPARSE = dict(num_examples=1024, dim=256, batch=64, lr=0.5, epochs=5,
              seed=7)
CLICK = dict(rows=8192, features=1000000, nnz=20, iters=20)
SPARSE_TOL = 1e-5


def _final_cases():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import final_op_cases
    return final_op_cases


def ctc_prepared(contrib, x, lab, blank_label, dl, ll):
    """(labels, counts, data lengths, blank) as ``contrib.ctc_loss``
    prepares them for the kernels, from card tensors."""
    T, N, C = x.shape
    first = blank_label != "last"
    labs, n_lab = contrib.ctc_labels(lab, C, first, ll)
    dlen = (torch.full((N,), T, dtype=torch.int32, device=x.device)
            if dl is None else contrib.int_convert(dl).contiguous())
    return labs, n_lab, dlen, 0 if first else C - 1


def ctc_case_checked(contrib, x, lab, blank_label, dl, ll, head, label):
    """The kernel pair (through ``contrib.ctc_loss``'s autograd Function)
    against the plain version on the same card tensors: the loss within
    CTC_TOL relative (1e30 exactly where the plain version gives it), the
    gradient within CTC_TOL of the largest with NaN at the same places,
    and a second call bit-identical. Returns the errors."""
    def kernel():
        xt = x.clone().requires_grad_()
        loss = contrib.ctc_loss(xt, lab, blank_label, dl, ll)
        (g,) = torch.autograd.grad(loss, [xt], head)
        return loss.detach(), g

    labs, n_lab, dlen, blank = ctc_prepared(contrib, x, lab, blank_label,
                                            dl, ll)
    xt = x.clone().requires_grad_()
    want = contrib.ctc_loss_reference(xt, labs, n_lab, dlen, blank)
    (want_g,) = torch.autograd.grad(want, [xt], head)
    want = want.detach()
    got, got_g = kernel()
    again, again_g = kernel()
    torch.cuda.synchronize()
    big = want == 1e30
    loss_err = float(((got - want).abs() / want.abs().clamp(min=1.0))[
        ~big].max()) if bool((~big).any()) else 0.0
    nan = torch.isnan(want_g)
    scale = float(want_g[~nan].abs().max()) if bool((~nan).any()) else 1.0
    grad_err = float((got_g - want_g)[~nan].abs().max()) / max(
        scale, 1e-30) if bool((~nan).any()) else 0.0
    same = torch.equal(got, again) and torch.equal(
        torch.nan_to_num(got_g), torch.nan_to_num(again_g)) and \
        torch.equal(torch.isnan(got_g), torch.isnan(again_g))
    ok = torch.equal(got == 1e30, big) and loss_err <= CTC_TOL and \
        torch.equal(torch.isnan(got_g), nan) and grad_err <= CTC_TOL and same
    if not ok:
        raise AssertionError(
            "ctc kernels %s: loss error %g (1e30 at %s, plain %s), gradient "
            "error %g of %g, NaN same %s, repeat bit-identical %s"
            % (label, loss_err, (got == 1e30).tolist(), big.tolist(),
               grad_err, scale, torch.equal(torch.isnan(got_g), nan), same))
    return dict(case=label, loss_err=loss_err, grad_err=grad_err,
                infeasible=int(big.sum()))


def ctc_speech_inputs(seed, device="cuda"):
    """Seeded logits (T, N, C), 0-padded labels (N, L) of 100-200
    characters in [1, C) and their lengths."""
    cfg = CTC_SPEECH
    rng = np.random.RandomState(seed + 800)
    T, N, C, L = cfg["T"], cfg["N"], cfg["C"], cfg["L"]
    x = rng.randn(T, N, C).astype(np.float32)
    n = rng.randint(cfg["min_label"], L + 1, N)
    lab = rng.randint(1, C, (N, L)).astype(np.float32)
    lab[np.arange(L)[None, :] >= n[:, None]] = 0
    return (torch.from_numpy(x).to(device), torch.from_numpy(lab).to(device),
            n)


def ctc_bytes(T, N, C, L):
    """CTC's bytes at one shape. The function's least: the forward reads
    the logits and the labels (with their counts and the data lengths)
    and writes the loss; the backward reads the head gradient, the logits
    and the labels and writes the gradient. This route's: the same, with
    every step's alpha (T, N, 2L + 1) written by the forward and read by
    the backward, and the backward's per-state cotangents (the same
    shape) written by its scan and read by its frames pass."""
    small = 4 * (N * L + 3 * N)
    alpha = 4 * T * N * (2 * L + 1)
    fwd = 4 * T * N * C + small
    bwd = 2 * 4 * T * N * C + small
    return {"fwd": fwd, "bwd": bwd, "route_fwd": fwd + alpha,
            "route_bwd": bwd + 3 * alpha}


#: The dependent chain of one step of the CTC scans: (what, instructions
#: on the chain, cycles each), from Hopper's dependent-issue latencies
#: (4 cycles an FP32 add, multiply, FMA, compare or select; ~24 a warp
#: shuffle; ~16 a MUFU result). In the forward, the three expf run side
#: by side, so one is on the chain. In the backward only the adjoint
#: depends on the step before: the alpha terms (the max, the three expf,
#: the sum, the tie tests) are known ahead and off the chain.
CTC_STEP_CHAIN = {
    "fwd": [("shuffle of alpha[s - 1] from the lane below", 1, 24),
            ("XLA's NaN max, twice (compare, NaN test, select)", 6, 4),
            ("x - m", 1, 4),
            ("expf: range reduction and scale", 6, 4),
            ("expf: MUFU.EX2", 1, 16),
            ("the two adds of the three terms", 2, 4),
            ("logf: reduction and polynomial (no MUFU in its SASS)", 16,
             4),
            ("+ m, isfinite select, + logp, s_valid select", 4, 4)],
    "bwd": [("the cotangent's two selects", 2, 4),
            ("the division by the sum: Newton fix-up", 5, 4),
            ("the division: MUFU.RCP", 1, 16),
            ("the weight q e1", 1, 4),
            ("the max's share: three adds", 3, 4),
            ("the tie-share product and FMA", 2, 4),
            ("shuffle of the partials from the lane above", 1, 24),
            ("G1 + G2 + G3", 2, 4),
            ("the frozen select", 1, 4)]}


def ctc_scan_bound_ms(T, sm_mhz):
    """The route bound of a dependent scan: T - 1 steps (the forward's
    and the backward's) times the cycles of one step's dependent chain
    (CTC_STEP_CHAIN), at the SM clock ``sm_mhz``. No parallelism over
    states or sequences shortens it."""
    out = {"sm_mhz": sm_mhz}
    for k, chain in CTC_STEP_CHAIN.items():
        cycles = sum(n * c for _, n, c in chain)
        out[k + "_cycles"] = cycles
        out[k + "_ms"] = max(T - 1, 0) * cycles / (sm_mhz * 1e6) * 1e3
    return out


def sm_max_mhz():
    """The card's top SM clock (``nvidia-smi clocks.max.sm``), MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip())


def ctc_takes_scratch(src):
    """Whether the ctc_loss.cu at ``src`` has this tree's interface (the
    backward takes a per-state cotangent scratch), not the earlier one."""
    with open(src) as f:
        text = f.read()
    head = text[text.index("int ctc_loss_bwd("):]
    return "void* ct" in head[:head.index(")")]


def ctc_binding(lib, scratch):
    """ctypes bindings of a built ctc_loss library on tensors, on the
    current stream: ``fwd(logp, lab, n_lab, dlen, blank)`` -> (loss,
    alpha) and ``bwd(grad, logp, alpha, lab, n_lab, dlen, blank)`` -> dx.
    With ``scratch``, this tree's interface (the backward's (T, N, S)
    cotangent scratch); without, the earlier one."""
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    f, b = lib.ctc_loss_fwd, lib.ctc_loss_bwd
    f.argtypes = [P] * 6 + [I] * 5 + [P]
    b.argtypes = [P] * (8 if scratch else 7) + [I] * 5 + [P]
    f.restype = b.restype = I

    def check(rc, what):
        if rc != 0:
            raise AssertionError("parent ctc_loss %s launch failed (cuda "
                                 "error %d)" % (what, rc))

    def fwd(logp, lab, n_lab, dlen, blank):
        T, N, C = logp.shape
        S = 2 * lab.shape[1] + 1
        loss = logp.new_empty(N)
        alpha = logp.new_empty((T, N, S))
        args = [logp, lab, n_lab, dlen, loss, alpha]
        ints = [T, N, C, lab.shape[1], blank]
        check(f(*[t.data_ptr() for t in args], *ints,
                torch.cuda.current_stream().cuda_stream), "forward")
        return loss, alpha

    def bwd(grad, logp, alpha, lab, n_lab, dlen, blank):
        T, N, C = logp.shape
        dx = torch.empty_like(logp)
        args = [grad, logp, alpha, lab, n_lab, dlen]
        if scratch:
            args.append(torch.empty_like(alpha))
        ints = [T, N, C, lab.shape[1], blank]
        check(b(*[t.data_ptr() for t in args + [dx]], *ints,
                torch.cuda.current_stream().cuda_stream), "backward")
        return dx

    return {"fwd": fwd, "bwd": bwd}


def ctc_against_parent(kernels, contrib, prepared, logp, head, iters, card,
                       label):
    """An earlier tree's CTC kernels (``--parent``) at one shape: its loss
    against this tree's bit for bit (the forward's arithmetic is the
    same, term for term), its gradient's largest difference from this
    tree's (the class sums' order differs), and the forward, the backward
    and the two together timed in turns (parent, this, this, parent)."""
    labs, n_lab, dlen, blank = prepared
    p_loss, p_alpha = kernels["fwd"](logp, labs, n_lab, dlen, blank)
    p_dx = kernels["bwd"](head, logp, p_alpha, labs, n_lab, dlen, blank)
    loss, alpha = contrib.ctc_loss_fwd(logp, labs, n_lab, dlen, blank)
    dx = contrib.ctc_loss_bwd(head, logp, alpha, labs, n_lab, dlen, blank)
    torch.cuda.synchronize()
    same_loss = torch.equal(p_loss.view(torch.int32), loss.view(torch.int32))
    grad_diff = float((p_dx - dx).abs().max())

    def parent_pair():
        _, pa = kernels["fwd"](logp, labs, n_lab, dlen, blank)
        kernels["bwd"](head, logp, pa, labs, n_lab, dlen, blank)

    def this_pair():
        _, ta = contrib.ctc_loss_fwd(logp, labs, n_lab, dlen, blank)
        contrib.ctc_loss_bwd(head, logp, ta, labs, n_lab, dlen, blank)

    fwd_p, fwd_t = in_turns(
        lambda: kernels["fwd"](logp, labs, n_lab, dlen, blank),
        lambda: contrib.ctc_loss_fwd(logp, labs, n_lab, dlen, blank), iters)
    bwd_p, bwd_t = in_turns(
        lambda: kernels["bwd"](head, logp, p_alpha, labs, n_lab, dlen,
                               blank),
        lambda: contrib.ctc_loss_bwd(head, logp, alpha, labs, n_lab, dlen,
                                     blank), iters)
    pair_p, pair_t = in_turns(parent_pair, this_pair, iters)
    row = {"loss_bits_equal": same_loss, "grad_max_abs_diff": grad_diff,
           "fwd_ms": {"parent": fwd_p, "this": fwd_t},
           "bwd_ms": {"parent": bwd_p, "this": bwd_t},
           "pair_ms": {"parent": pair_p, "this": pair_t}}
    log("  [%s] ctc kernels at %s against the parent: loss bit for bit %s, "
        "gradient %.2e max abs apart; ms in turns (parent, this, this, "
        "parent): forward %s / %s, backward %s / %s, the two %s / %s"
        % (card, label, same_loss, grad_diff,
           [round(v, 4) for v in fwd_p], [round(v, 4) for v in fwd_t],
           [round(v, 4) for v in bwd_p], [round(v, 4) for v in bwd_t],
           [round(v, 4) for v in pair_p], [round(v, 4) for v in pair_t]))
    if not same_loss:
        raise AssertionError("ctc: the parent's loss differs at %s" % label)
    return row


def ctc_timed(contrib, x, lab, card, label, iters, parents=()):
    """The kernels alone at one shape: each launch's CUDA-event ms beside
    the plain version's (forward, and forward+backward under autograd),
    ``F.ctc_loss`` (blank 0, ``reduction="none"``: forward, and
    forward+backward, the same function where every alignment is
    feasible, as here), the bytes bound, this route's bytes
    (``ctc_bytes``) and the scan's route bound (``ctc_scan_bound_ms``);
    the kernels' loss and gradient against the plain version's on these
    inputs, and the library's against the kernels'. With ``parents``,
    each earlier tree's kernels in turns with these
    (``ctc_against_parent``). Counts these launches too: call it after
    the main path's counts are read."""
    T, N, C = x.shape
    labs, n_lab, dlen, blank = ctc_prepared(contrib, x, lab, "first", None,
                                            None)
    logp = torch.log_softmax(x, -1).contiguous()
    loss, alpha = contrib.ctc_loss_fwd(logp, labs, n_lab, dlen, blank)
    head = torch.ones(N, device=x.device)
    fwd_ms = cuda_ms(lambda: contrib.ctc_loss_fwd(logp, labs, n_lab, dlen,
                                                  blank), iters)
    bwd_ms = cuda_ms(lambda: contrib.ctc_loss_bwd(head, logp, alpha, labs,
                                                  n_lab, dlen, blank), iters)

    def pair():
        xt = x.detach().requires_grad_()
        l = contrib.ctc_loss(xt, lab)
        l.backward(head)

    def plain(grad):
        xt = x.detach().requires_grad_(grad)
        l = contrib.ctc_loss_reference(xt, labs, n_lab, dlen, blank)
        if grad:
            l.backward(head)

    def library(grad):
        xt = x.detach().requires_grad_(grad)
        l = torch.nn.functional.ctc_loss(
            torch.log_softmax(xt, -1), labs.long(), dlen.long(),
            n_lab.long(), blank=0, reduction="none")
        if grad:
            l.backward(head)
        return l, xt

    pair_ms = cuda_ms(pair, iters)
    few = max(1, iters // 5)
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: plain(False), few, warmup=1)
    plain_pair_ms = cuda_ms(lambda: plain(True), few, warmup=1)
    with torch.no_grad():
        lib_ms = cuda_ms(lambda: library(False), iters)
    lib_pair_ms = cuda_ms(lambda: library(True), iters)
    lib_loss, xt = library(True)
    xk = x.detach().requires_grad_()
    kl = contrib.ctc_loss(xk, lab)
    kl.backward(head)
    lib_loss_err = float(((lib_loss - kl) / kl.abs()).abs().max().detach())
    lib_grad_err = float((xt.grad - xk.grad).abs().max())
    xp = x.detach().requires_grad_()
    pl = contrib.ctc_loss_reference(xp, labs, n_lab, dlen, blank)
    pl.backward(head)
    err = float((kl - pl).abs().max().detach())
    bwd_err = float((xk.grad - xp.grad).abs().max())
    x64 = x.detach().double().requires_grad_()
    contrib.ctc_loss_reference(x64, labs, n_lab, dlen, blank).backward(
        head.double())
    f64_err = {"kernel": float((xk.grad.double() - x64.grad).abs().max()),
               "library": float((xt.grad.double() - x64.grad).abs().max())}
    nb = {k: v / HBM_BYTES_PER_S * 1e3
          for k, v in ctc_bytes(T, N, C, lab.shape[1]).items()}
    scan = ctc_scan_bound_ms(T, sm_max_mhz())
    prepared = (labs, n_lab, dlen, blank)
    against = [ctc_against_parent(p.kernels["ctc_loss"], contrib, prepared,
                                  logp, head, iters, card, label)
               for p in parents if "ctc_loss" in p.kernels]
    row = {"shape": [T, N, C, int(lab.shape[1])], "ms": fwd_ms,
           "bwd_ms": bwd_ms, "pair_ms": pair_ms, "plain_ms": plain_ms,
           "pair_plain_ms": plain_pair_ms, "library_ms": lib_ms,
           "pair_library_ms": lib_pair_ms, "max_abs_err": err,
           "bwd_max_abs_err": bwd_err, "bound_ms": nb["fwd"],
           "bound_by": "bytes", "route_ms": nb["route_fwd"],
           "bwd_bound_ms": nb["bwd"], "bwd_bound_by": "bytes",
           "bwd_route_ms": nb["route_bwd"], "steps": T,
           "library_loss_rel_err": lib_loss_err,
           "library_grad_max_abs_err": lib_grad_err,
           "grad_max_abs_err_f64": f64_err, "scan_bound": scan,
           "scan_bound_ms": scan["fwd_ms"],
           "bwd_scan_bound_ms": scan["bwd_ms"], "parents": against}
    log("  [%s] ctc kernels at %s %s (T, N, C, L): forward %.4f ms (plain "
        "%.3f, F.ctc_loss %.4f, bound %.5f, route %.5f), backward %.4f ms "
        "(bound %.5f, route %.5f); the pair %.4f ms through the autograd "
        "Function, plain %.2f, F.ctc_loss forward+backward %.4f; against "
        "the plain version: loss %.2e, gradient %.2e max abs; F.ctc_loss "
        "against the kernels: loss %.2e relative, gradient %.2e; gradient "
        "against the float64 plain version: the kernels %.2e, F.ctc_loss "
        "%.2e" % (card, label, row["shape"], fwd_ms, plain_ms, lib_ms,
                  row["bound_ms"], row["route_ms"], bwd_ms,
                  row["bwd_bound_ms"], row["bwd_route_ms"], pair_ms,
                  plain_pair_ms, lib_pair_ms, err, bwd_err, lib_loss_err,
                  lib_grad_err, f64_err["kernel"], f64_err["library"]))
    log("  [%s] ctc scan route bound at %s: %d steps x %d cycles (forward) "
        "and x %d (backward) at %.0f MHz: %.5f / %.5f ms"
        % (card, label, max(T - 1, 0), scan["fwd_cycles"],
           scan["bwd_cycles"], scan["sm_mhz"], scan["fwd_ms"],
           scan["bwd_ms"]))
    return row


def ctc_kernel_checks(mt, contrib, seed, card, device="cuda", parents=()):
    """The kernel pair against its plain version on the card: every case
    of ``tests/final_op_cases.CTC_CASES`` (the infeasible alignments,
    data and label lengths, the blank last, interleaved padding, labels
    >= C, NaN logits, an OCR batch) and the speech shape; then both
    shapes timed (``ctc_timed``, against ``parents``)."""
    cases = _final_cases()
    rows = []
    for name, T, N, C, labels, attrs, dl, ll, nan in cases.CTC_CASES:
        x, lab, extra, head = cases.ctc_inputs(T, N, C, labels, dl, ll, nan)
        dev = device
        it = iter(extra)
        dlt = torch.from_numpy(next(it)).to(dev) \
            if attrs.get("use_data_lengths") else None
        llt = torch.from_numpy(next(it)).to(dev) \
            if attrs.get("use_label_lengths") else None
        rows.append(ctc_case_checked(
            contrib, torch.from_numpy(x).to(dev),
            torch.from_numpy(lab).to(dev), attrs.get("blank_label", "first"),
            dlt, llt, torch.from_numpy(head).to(dev), name))
    x, lab, _ = ctc_speech_inputs(seed, device)
    head = torch.from_numpy((np.random.RandomState(seed).rand(
        x.shape[1]) + 0.5).astype(np.float32)).to(device)
    rows.append(ctc_case_checked(contrib, x, lab, "first", None, None, head,
                                 "speech"))
    infeasible = [r for r in rows if r["infeasible"]]
    log("  [%s] ctc kernels vs plain on the card: %d cases (%d with "
        "infeasible sequences at 1e30), worst loss error %.2e, gradient %.2e "
        "of the largest; speech shape loss %.2e, gradient %.2e; repeats "
        "bit-identical" % (card, len(rows), len(infeasible),
                           max(r["loss_err"] for r in rows),
                           max(r["grad_err"] for r in rows),
                           rows[-1]["loss_err"], rows[-1]["grad_err"]))
    X, Y, _, _ = ctc_ocr_split()
    B = CTC["batch"]
    ocr_x = torch.from_numpy(np.random.RandomState(seed).randn(
        X.shape[1], B, 11).astype(np.float32)).to(device)
    timed = {"ocr": ctc_timed(contrib, ocr_x, torch.from_numpy(
        Y[:B]).to(device), card, "OCR", CTC_ITERS["ocr"], parents),
             "speech": ctc_timed(contrib, x, lab, card, "speech",
                                 CTC_ITERS["speech"], parents)}
    return rows, timed


def ctc_ocr_split():
    from mxtpu_torch.models import ctc_ocr
    return ctc_ocr.example_split(CTC["num_examples"], CTC["seed"])


def ctc_training(mt, contrib, seed, card):
    """The OCR through ``Module.fit`` on gpu(0) for one epoch at the
    example's defaults (module docstring, phase 17); returns the row and
    the trained module."""
    from mxtpu_torch.models import ctc_ocr
    X, Y, Xv, Yv = ctc_ocr_split()
    B, H = CTC["batch"], CTC["num_hidden"]
    T, F = X.shape[1:]
    np.random.seed(CTC["seed"])  # NDArrayIter's shuffle, Xavier's draws
    mt.random.seed(CTC["seed"])
    it = mt.io.NDArrayIter(X, Y, batch_size=B, shuffle=True,
                           label_name="label")
    mod = mt.mod.Module(ctc_ocr.build_symbol(H, T, True),
                        context=mt.gpu(0), label_names=("label",),
                        logger=_quiet_logger())
    losses, stamps = [], []

    def on_batch(param):
        losses.append(mod.get_outputs()[0].asnumpy())  # a device sync
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    contrib.ctc_loss_fwd.launches = 0
    contrib.ctc_loss_bwd.launches = 0
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=CTC["epochs"], optimizer="adam",
            optimizer_params={"learning_rate": CTC["lr"]},
            eval_metric=mt.metric.Loss(),
            initializer=mt.initializer.Xavier(), batch_end_callback=on_batch)
    torch.cuda.synchronize()
    launches = {"fwd": contrib.ctc_loss_fwd.launches,
                "bwd": contrib.ctc_loss_bwd.launches}
    fit_s = time.perf_counter() - t0
    steps = len(losses)
    means = [float(v.mean()) for v in losses]
    w = CTC["window"]
    first, last = float(np.mean(means[:w])), float(np.mean(means[-w:]))
    gaps = np.diff([t0] + stamps) * 1e3
    med = float(np.median(gaps[w:]))
    batch = next(iter(mt.io.NDArrayIter(X[:B], Y[:B], batch_size=B,
                                        label_name="label")))

    def step():
        mod.forward_backward(batch)
        mod.update()

    busy = step_kernels(step).get(0, (0, 0.0))
    row = {"train_strips": len(X), "steps": steps, "batch": B,
           "num_hidden": H, "T": int(T), "features": int(F),
           "loss_first": first, "loss_last": last,
           "loss_by_step": means, "fit_s": fit_s, "step_ms": med,
           "device_launches": busy[0], "device_ms": busy[1],
           "busy_share": busy[1] / med, "launches": launches}
    log("  [%s] OCR (2 LSTMCells of %d over T=%d, B=%d) one epoch of %d "
        "strips through Module.fit: %d steps in %.1f s, CTC loss (mean of "
        "the first / last %d steps) %.3f -> %.3f; step %.2f ms (median); "
        "profiled step %d kernel launches, %.2f ms of device time (busy "
        "%.1f %%); ctc launches %s"
        % (card, H, T, B, len(X), steps, fit_s, w, first, last, med, busy[0],
           busy[1], 100 * busy[1] / med, launches))
    if not all(np.isfinite(v).all() for v in losses):
        raise AssertionError("ctc: a loss is not finite")
    if not last < first:
        raise AssertionError("ctc: the loss did not fall over the epoch: "
                             "%.4f -> %.4f" % (first, last))
    if launches != {"fwd": steps, "bwd": steps} or steps != -(-len(X) // B):
        raise AssertionError("ctc: %d steps launched %s: one forward and one "
                             "backward a step expected" % (steps, launches))
    row["eval"] = ctc_eval(mt, ctc_ocr, mod, Xv, Yv, card)
    return row, mod


def ctc_eval(mt, ctc_ocr, mod, Xv, Yv, card):
    """The prediction module on gpu(0), sharing the trained weights: the
    greedy-decode accuracy on the held-out strips (probabilities finite,
    each frame's summing to 1); then the trained graph's CTC loss on one
    held-out batch on gpu(0) against a cpu() Module with the same
    weights (the plain version)."""
    B, H = CTC["batch"], CTC["num_hidden"]
    T, F = Xv.shape[1:]
    pmod = mt.mod.Module(ctc_ocr.build_symbol(H, T, False),
                         context=mt.gpu(0), label_names=None,
                         logger=_quiet_logger())
    pmod.bind(data_shapes=[("data", (B, T, F))], for_training=False)
    args, auxs = mod.get_params()
    pmod.set_params(args, auxs, allow_missing=False)
    correct = total = 0
    worst_sum = 0.0
    for batch in mt.io.NDArrayIter(Xv, Yv, batch_size=B, label_name="label"):
        pmod.forward(batch, is_train=False)
        probs = pmod.get_outputs()[0].asnumpy()
        if not np.isfinite(probs).all():
            raise AssertionError("ctc eval: probabilities not finite")
        worst_sum = max(worst_sum, float(np.abs(probs.sum(-1) - 1).max()))
        c, n = ctc_ocr.decode_accuracy(probs, batch.label[0].asnumpy(),
                                       B - batch.pad)
        correct += c
        total += n
    acc = correct / max(total, 1)
    vb = mt.io.DataBatch([mt.nd.array(Xv[:B], ctx=mt.cpu())],
                         [mt.nd.array(Yv[:B], ctx=mt.cpu())])
    twin = mt.mod.Module(ctc_ocr.build_symbol(H, T, True),
                         context=mt.cpu(), label_names=("label",),
                         logger=_quiet_logger())
    twin.bind(data_shapes=[("data", (B, T, F))],
              label_shapes=[("label", (B, ctc_ocr.MAX_LABEL))],
              for_training=False)
    twin.set_params(args, auxs)
    twin.forward(vb, is_train=False)
    mod.forward(vb, is_train=False)
    want = twin.get_outputs()[0].asnumpy()
    got = mod.get_outputs()[0].asnumpy()
    twin_err = float((np.abs(got - want) / np.maximum(1, np.abs(want))).max())
    log("  [%s] OCR held-out: %d strips, greedy-decode whole-sequence "
        "accuracy %.4f; frame sums within %.1e of 1; the trained CTC loss "
        "on gpu(0) vs cpu() %.2e relative"
        % (card, total, acc, worst_sum, twin_err))
    if not worst_sum <= 1e-4 or not twin_err <= 1e-4:
        raise AssertionError("ctc eval: frame sums %g, gpu vs cpu %g"
                             % (worst_sum, twin_err))
    return {"strips": total, "accuracy": acc, "frame_sum_err": worst_sum,
            "gpu_vs_cpu_loss_err": twin_err}


def ctc_gluon_step(mt, contrib, seed, card):
    """One step of Gluon's ``CTCLoss`` under ``autograd.record`` on
    gpu(0): predictions (N, T, C) of the OCR's shape, the loss and its
    gradient against the plain version on the CPU; launches counted."""
    X, Y, _, _ = ctc_ocr_split()
    B = CTC["batch"]
    x = np.random.RandomState(seed + 1).randn(B, X.shape[1], 11).astype(
        np.float32)
    loss_fn = mt.gluon.loss.CTCLoss()
    contrib.ctc_loss_fwd.launches = 0
    contrib.ctc_loss_bwd.launches = 0
    with mt.gpu(0):
        p = mt.nd.array(x)
        p.attach_grad()
        with mt.autograd.record():
            loss = loss_fn(p, mt.nd.array(Y[:B]))
        loss.backward()
        got, got_g = loss.asnumpy(), p.grad.asnumpy()
    launches = {"fwd": contrib.ctc_loss_fwd.launches,
                "bwd": contrib.ctc_loss_bwd.launches}
    xt = torch.from_numpy(x).requires_grad_()
    want = contrib.ctc_loss(xt.transpose(0, 1), torch.from_numpy(Y[:B]))
    want.backward(torch.ones(B))
    err = float(np.abs(got - want.detach().numpy()).max() /
                np.abs(want.detach().numpy()).max())
    gerr = float(np.abs(got_g - xt.grad.numpy()).max() /
                 np.abs(xt.grad.numpy()).max())
    log("  [%s] Gluon CTCLoss step on gpu(0): loss %.2e, gradient %.2e "
        "against the CPU's plain version; launches %s"
        % (card, err, gerr, launches))
    if launches != {"fwd": 1, "bwd": 1} or not err <= 1e-5 or \
            not gerr <= 1e-4:
        raise AssertionError("ctc gluon: launches %s, loss %g, grad %g"
                             % (launches, err, gerr))
    return {"loss_err": err, "grad_err": gerr, "launches": launches}


def phase_ctc(mt, seed, card, parents=()):
    """Phase 17 (module docstring): the OCR trained with CTC, Gluon's
    CTCLoss, then the kernel pair alone (with ``parents``, against
    earlier trees' in turns)."""
    from mxtpu_torch.ops import contrib
    t0 = time.perf_counter()
    res = {}
    res["training"], trained = ctc_training(mt, contrib, seed, card)
    del trained
    res["gluon"] = ctc_gluon_step(mt, contrib, seed, card)
    tr, gl = res["training"]["launches"], res["gluon"]["launches"]
    res["launches"] = {"ocr_fit_fwd": tr["fwd"], "ocr_fit_bwd": tr["bwd"],
                       "gluon_ctc_fwd": gl["fwd"], "gluon_ctc_bwd": gl["bwd"]}
    res["cases"], res["timed"] = ctc_kernel_checks(mt, contrib, seed, card,
                                                   parents=parents)
    res["seconds"] = time.perf_counter() - t0
    log("  [%s] ctc phase %.1f s; launches %s"
        % (card, res["seconds"], res["launches"]))
    return res


def sparse_flow(mt, card):
    """The sparse example's flow at its defaults with the port on gpu(0):
    LibSVMIter's csr batches, row_sparse pulls from a local kvstore whose
    weight lives on the card, a row_sparse gradient pushed through the
    store's SGD; train accuracy must rise over the epochs. Then the same
    flow on cpu(), printed beside."""
    import tempfile
    from mxtpu_torch.models import sparse_linear
    cfg = SPARSE
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.libsvm")
        sparse_linear.synth_libsvm(path, cfg["num_examples"], cfg["dim"],
                                   np.random.RandomState(cfg["seed"]))
        it = mt.io.LibSVMIter(data_libsvm=path, data_shape=(cfg["dim"],),
                              batch_size=cfg["batch"])
        first = it.next().data[0]
        store = mt.kv.create("local")
        with mt.gpu(0):
            store.init("w", mt.nd.sparse.zeros("row_sparse", (cfg["dim"], 1)))
            out = mt.nd.sparse.zeros("row_sparse", (cfg["dim"], 1))
            store.row_sparse_pull("w", out=out, row_ids=mt.nd.array(
                np.array([3.0, 1.0, 3.0])))
        on_card = out.data._data.device == mt.gpu(0).torch_device and \
            out.indices.asnumpy().tolist() == [1, 3]
        t0 = time.perf_counter()
        with mt.gpu(0):
            accs = sparse_linear.train(
                path, epochs=cfg["epochs"], dim=cfg["dim"],
                batch_size=cfg["batch"], lr=cfg["lr"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with mt.cpu():
            cpu_accs = sparse_linear.train(
                path, epochs=cfg["epochs"], dim=cfg["dim"],
                batch_size=cfg["batch"], lr=cfg["lr"])
    log("  [%s] sparse example on gpu(0): %s batches of %d, train accuracy "
        "by epoch %s (cpu() %s), %.2f s for %d epochs; the store's rows "
        "pulled on the card %s"
        % (card, type(first).__name__, cfg["batch"],
           [round(a, 4) for a in accs], [round(a, 4) for a in cpu_accs],
           secs, cfg["epochs"], on_card))
    if not isinstance(first, mt.nd.CSRNDArray) or not on_card or \
            not accs[-1] > accs[0]:
        raise AssertionError("sparse flow: batch %s, on card %s, accuracy "
                             "%s" % (type(first).__name__, on_card, accs))
    return {"accuracy": accs, "cpu_accuracy": cpu_accs, "seconds": secs}


def sparse_dot_bytes(nnz, rows, unique, transpose):
    """The least bytes of csr·dense (values, column ids and row offsets
    read, the weight rows the ids touch read, the output written) and of
    csrᵀ·dense (the same components, the dense rows read, the unique
    rows' values and ids written)."""
    comps = 8 * nnz + 4 * (rows + 1)
    if transpose:
        return comps + 4 * rows + 8 * unique
    return comps + 4 * unique + 4 * rows


def sparse_dots(mt, seed, card):
    """csr·dense and csrᵀ·dense on the card at the click-through shape
    (CLICK): each against the float64 product of the same components on
    the host (scipy), within SPARSE_TOL of the largest; timed beside the
    bytes bound. Then csr + csr (the batch with itself) and the retain of
    every other row of the csrᵀ·dense result, on the card: their
    components stay there and equal the host's (scipy's canonical sum
    within SPARSE_TOL, the retained rows exactly); timed."""
    import scipy.sparse as sps
    cfg = CLICK
    rows, feats, k = cfg["rows"], cfg["features"], cfg["nnz"]
    rng = np.random.RandomState(seed + 1000)
    cols = np.sort(rng.randint(0, feats, (rows, k)), axis=1).ravel()
    vals = rng.randn(rows * k).astype(np.float32)
    indptr = np.arange(0, rows * k + 1, k)
    w = rng.randn(feats, 1).astype(np.float32)
    e = rng.randn(rows, 1).astype(np.float32)
    ref = sps.csr_matrix((vals.astype(np.float64), cols, indptr),
                         shape=(rows, feats))
    with mt.gpu(0):
        csr = mt.nd.sparse.csr_matrix((vals, cols, indptr),
                                      shape=(rows, feats))
        wd, ed = mt.nd.array(w), mt.nd.array(e)
        out = mt.nd.dot(csr, wd).asnumpy()
        rsp = mt.nd.dot(csr, ed, transpose_a=True)
        ids, data = rsp.indices.asnumpy(), rsp.data.asnumpy()
        fwd_ms = cuda_ms(lambda: mt.nd.dot(csr, wd), cfg["iters"])
        t_ms = cuda_ms(lambda: mt.nd.dot(csr, ed, transpose_a=True),
                       cfg["iters"])
        keep = mt.nd.array(ids[::2].astype(np.float64))
        summed = mt.nd.sparse.add(csr, csr)
        kept = mt.nd.sparse_retain(rsp, keep)
        on_card = all(c.device == mt.gpu(0).torch_device
                      for a in (summed, kept) for c in a._components())
        sp, sc, sd = [c.asnumpy() for c in (summed.indptr, summed.indices,
                                            summed.data)]
        kept_ids, kept_data = kept.indices.asnumpy(), kept.data.asnumpy()
        add_ms = cuda_ms(lambda: mt.nd.sparse.add(csr, csr), cfg["iters"])
        retain_ms = cuda_ms(lambda: mt.nd.sparse_retain(rsp, keep),
                            cfg["iters"])
    want = ref @ w.astype(np.float64)
    want_t = ref.T @ e.astype(np.float64)
    uniq = np.unique(cols)
    err = float(np.abs(out - want).max() / max(1.0, np.abs(want).max()))
    same_ids = ids.tolist() == uniq.tolist()
    err_t = float(np.abs(data - want_t[uniq]).max() /
                  max(1.0, np.abs(want_t).max())) if same_ids else \
        float("inf")
    twice = ref.copy()
    twice.sum_duplicates()
    twice = twice * 2.0
    same_add = sp.tolist() == twice.indptr.tolist() and \
        sc.tolist() == twice.indices.tolist()
    err_add = float(np.abs(sd - twice.data).max() / max(
        1.0, np.abs(twice.data).max())) if same_add else float("inf")
    same_kept = kept_ids.tolist() == ids[::2].tolist() and \
        np.array_equal(kept_data, data[::2])
    b = sparse_dot_bytes(rows * k, rows, len(uniq), False) / \
        HBM_BYTES_PER_S * 1e3
    bt = sparse_dot_bytes(rows * k, rows, len(uniq), True) / \
        HBM_BYTES_PER_S * 1e3
    row = {"rows": rows, "features": feats, "nnz": rows * k,
           "unique_columns": int(len(uniq)), "dot_ms": fwd_ms,
           "dot_bound_ms": b, "dot_err": err, "dot_t_ms": t_ms,
           "dot_t_bound_ms": bt, "dot_t_err": err_t,
           "dot_t_rows": int(len(ids)), "add_ms": add_ms,
           "add_err": err_add, "add_nnz": int(len(sd)),
           "retain_ms": retain_ms, "retain_rows": int(len(kept_ids))}
    log("  [%s] sparse dots at %d x %d, %d non-zeros (%d columns touched): "
        "csr.dense %.4f ms (bound %.5f, bytes), error %.2e of the float64 "
        "product; csr^T.dense -> row_sparse of %d rows %.4f ms (bound %.5f), "
        "error %.2e" % (card, rows, feats, rows * k, len(uniq), fwd_ms, b,
                        err, len(ids), t_ms, bt, err_t))
    log("  [%s] csr + csr -> csr of %d non-zeros %.4f ms, error %.2e of "
        "the float64 sum; retain of %d of %d rows %.4f ms, rows exact %s; "
        "components on the card %s" % (card, len(sd), add_ms, err_add,
                                       len(kept_ids), len(ids), retain_ms,
                                       same_kept, on_card))
    if not err <= SPARSE_TOL or not err_t <= SPARSE_TOL or not same_ids \
            or not err_add <= SPARSE_TOL or not same_kept or not on_card:
        raise AssertionError(
            "sparse ops: dots %g, %g, ids same %s; add %g; retain exact "
            "%s; on the card %s" % (err, err_t, same_ids, err_add,
                                    same_kept, on_card))
    return row


def final_ops_on_card(mt, card, device="cuda"):
    """Every case of ``tests/final_op_cases.py``'s LINALG_CASES and
    CONTRIB_CASES (linalg.py's 18 names; quantize, dequantize, fft, ifft,
    count_sketch) on CUDA tensors against cpu(): the same dtypes and NaN
    positions, integers equal, floats within 1e-5 (forward) and 1e-4
    (gradient) of the largest; gelqf's Q and L from cuSOLVER held to
    LAPACK's on the host by the same forward gate."""
    cases = _final_cases()

    def run(name, arrays, attrs, diff, outs, device):
        xs = [torch.from_numpy(a.copy()).to(device) for a in arrays]
        for i in diff:
            xs[i].requires_grad_()
        op = mt.ops.registry.get_op(name)
        res = op.apply(op.parse_attrs(dict(attrs)), xs, device)
        grads = []
        if diff:
            rng = np.random.RandomState(7)
            heads = [torch.from_numpy(rng.randn(*res[k].shape).astype(
                np.float32)).to(device) for k in outs]
            grads = list(torch.autograd.grad([res[k] for k in outs],
                                             [xs[i] for i in diff], heads))
        return [t.detach().cpu() for t in list(res) + grads], len(res)

    def err(got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            return float("inf")
        if not want.is_floating_point():
            return 0.0 if torch.equal(got, want) else float("inf")
        g, w = got.double(), want.double()
        nan = torch.isnan(w)
        if not torch.equal(torch.isnan(g), nan):
            return float("inf")
        if not bool((~nan).any()):
            return 0.0
        return float((g[~nan] - w[~nan]).abs().max()) / max(
            1.0, float(w[~nan].abs().max()))

    worst = {"forward": 0.0, "gradient": 0.0}
    all_cases = cases.LINALG_CASES + cases.CONTRIB_CASES
    for name, arrays, attrs, diff, outs in all_cases:
        got, n_out = run(name, arrays, attrs, diff, outs, device)
        torch.cuda.synchronize()
        want, _ = run(name, arrays, attrs, diff, outs, "cpu")
        for j, (g, w) in enumerate(zip(got, want)):
            kind = "forward" if j < n_out else "gradient"
            e = err(g, w)
            worst[kind] = max(worst[kind], e)
            if not e <= (1e-5 if kind == "forward" else 1e-4):
                raise AssertionError("%s %s on the card: %s %d error %g"
                                     % (name, attrs, kind, j, e))
    log("  [%s] linalg and contrib ops: %d cases on CUDA tensors vs cpu: "
        "worst forward error %.3e, gradient %.3e (of the largest)"
        % (card, len(all_cases), worst["forward"], worst["gradient"]))
    return dict(cases=len(all_cases),
                **{"worst_%s" % k: v for k, v in worst.items()})


def phase_sparse(mt, seed, card):
    """Phase 18 (module docstring): the sparse example's flow, the sparse
    dots at a click-through shape, then the linalg and contrib ops."""
    t0 = time.perf_counter()
    res = {"flow": sparse_flow(mt, card), "dots": sparse_dots(mt, seed, card),
           "ops": final_ops_on_card(mt, card)}
    res["seconds"] = time.perf_counter() - t0
    log("  [%s] sparse phase %.1f s" % (card, res["seconds"]))
    return res


def kv_mlp(mt, seed):
    """The dist_async phase's mlp, its seeded start ({name: numpy}) and
    its seeded images and labels."""
    sym = mt.models.mlp.get_symbol(10)
    rng = np.random.RandomState(seed)
    shapes = dict(zip(sym.list_arguments(),
                      sym.infer_shape(data=(1, 784))[0]))
    w0 = {}
    for k in sorted(shapes):
        if k in ("data", "softmax_label"):
            continue
        scale = np.sqrt(3.0 / shapes[k][-1]) if k.endswith("_weight") \
            else 0.0
        w0[k] = rng.uniform(-scale, scale, shapes[k]).astype(np.float32)
    n = KV_ASYNC["examples"]
    x = rng.rand(n, 784).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.float32)
    return sym, w0, x, y


def kv_worker(mode, seed, out):
    """One process of the dist_async phase (``--kv-worker``): ``async``
    (a rank of a torch.distributed job from env://, the mlp on its half
    of the rows through ``fit(kvstore="dist_async")``), ``sync`` (a
    worker under ``MXTPU_ROLE=worker``, its half of every batch through
    ``fit(kvstore="dist_sync")``) or ``one`` (one process on the whole
    batch); writes its weights (``.npz``) and a JSON row beside them."""
    import mxtpu_torch as mt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sym, w0, x, y = kv_mlp(mt, seed)
    b = KV_ASYNC["batch"]
    row = {"mode": mode}
    kv = "local"
    if mode != "one":
        kv = mt.kv.create("dist_async" if mode == "async" else "dist_sync")
        r, nw = kv.rank, kv.num_workers
        row.update(rank=r, workers=nw)
        # each worker its half of every global batch
        idx = np.concatenate([np.arange(s + r * b // nw,
                                        s + (r + 1) * b // nw)
                              for s in range(0, len(x), b)])
        x, y, b = x[idx], y[idx], b // nw
    if mode == "async":
        # rank 1 pushes and pulls a key while rank 0 waits at a barrier:
        # its pull sees its own push without the other worker
        kv.init("probe", mt.nd.zeros((4,), ctx=mt.gpu(0)))
        seen = []
        if r == 1:
            for i in range(3):
                kv.push("probe", mt.nd.ones((4,), ctx=mt.gpu(0)) * (i + 1))
                got = mt.nd.zeros((4,), ctx=mt.gpu(0))
                kv.pull("probe", out=got)
                seen.append(float(got.asnumpy()[0]))
        kv.barrier()
        row["probe_seen"] = seen
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    clock = StepClock(1)
    torch.cuda.synchronize()
    start = time.perf_counter()
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=b),
            num_epoch=KV_ASYNC["epochs"], kvstore=kv, optimizer="sgd",
            optimizer_params={"learning_rate": KV_ASYNC["lr"]},
            arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                        for k, v in w0.items()},
            batch_end_callback=clock)
    row["step_ms"] = clock.ms(start)
    w = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    row["finite"] = bool(all(np.isfinite(v).all() for v in w.values()))
    row["moved"] = float(max(np.abs(w[k] - w0[k]).max() for k in w0))
    np.savez(out + ".npz", **w)
    if mode != "one":
        kv.barrier()  # every push applied
        snap = mt.telemetry.json_snapshot(mt.telemetry.registry())["mxtpu"]
        row["telemetry"] = {k: v for k, v in snap.items() if k.startswith(
            ("fault_injected", "retry_", "kvstore_push", "kvstore_pull"))}
        if mode == "async" and r == 0:
            row["versions"] = {str(k): v for k, v in
                               kv._server.versions.items()}
        kv.close()
        if mode == "async":
            import torch.distributed as dist
            dist.destroy_process_group()
    with open(out + ".json", "w") as f:
        json.dump(row, f)
    return 0


def run_procs(procs, timeout):
    """Wait for every process within ``timeout`` seconds in all; kill any
    still running (a hung worker fails the phase): their return codes."""
    deadline = time.monotonic() + timeout
    rcs = []
    try:
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(1.0, deadline
                                              - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs


def phase_dist_async(mt, seed, card):
    """Phase 19: ``dist_async`` over env:// with rank 0 hosting the async
    server, then the launch form (``python -m
    mxtpu_torch.kvstore_server`` and two ``MXTPU_ROLE=worker``
    processes on ``dist_sync``) against one process."""
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_kv_")
    me = [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
          "--kv-worker"]
    out = {}
    try:
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            me + ["async", "--out", os.path.join(tmp, "async%d" % r)],
            cwd=here, env=dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                               MASTER_ADDR="127.0.0.1",
                               MASTER_PORT=str(port)))
            for r in range(2)]
        rcs = run_procs(procs, KV_ASYNC["timeout"])
        wall = time.perf_counter() - t0
        if rcs != [0, 0]:
            raise AssertionError("dist_async workers: rcs %s" % rcs)
        rows = []
        for r in range(2):
            with open(os.path.join(tmp, "async%d.json" % r)) as f:
                rows.append(json.load(f))
        steps = KV_ASYNC["epochs"] * KV_ASYNC["examples"] // \
            KV_ASYNC["batch"]
        versions = rows[0]["versions"]
        counted = {k: v for k, v in versions.items() if k != "probe"}
        log("  [%s] dist_async, 2 workers on gpu(0) from env://, rank 0 "
            "serving: rank 1's pulls after its own pushes %s (rank 0 at a "
            "barrier); weights finite %s, moved %s; the server's versions "
            "of the %d weights %s (want %d: every push of %d steps by 2 "
            "workers); step ms by rank %s; %.1f s wall with the processes' "
            "start" % (card, rows[1]["probe_seen"],
                       [r["finite"] for r in rows],
                       [round(r["moved"], 4) for r in rows], len(counted),
                       sorted(set(counted.values())), 2 * steps, steps,
                       [[round(v, 2) for v in r["step_ms"]] for r in rows],
                       wall))
        trained = all(r["finite"] and r["moved"] > 1e-3 for r in rows)
        if rows[1]["probe_seen"] != [1.0, 2.0, 3.0] or not trained or \
                versions.get("probe") != 3 or len(counted) != 6 or \
                set(counted.values()) != {2 * steps}:
            raise AssertionError("dist_async: %s" % rows)
        out["async"] = dict(step_ms=[r["step_ms"] for r in rows],
                            wall_s=wall, versions=versions)
        # the launch form on dist_sync, and one process on the whole batch
        port = free_port()
        kv_env = dict(os.environ, MXTPU_ROOT_URI="127.0.0.1",
                      MXTPU_ROOT_PORT=str(port), MXTPU_NUM_WORKERS="2")
        t0 = time.perf_counter()
        server = subprocess.Popen(
            [sys.executable, "-m", "mxtpu_torch.kvstore_server"], cwd=here,
            env=dict(kv_env, MXTPU_ROLE="server"))
        procs = [subprocess.Popen(
            me + ["sync", "--out", os.path.join(tmp, "sync%d" % r)],
            cwd=here, env=dict(kv_env, MXTPU_ROLE="worker",
                               MXTPU_WORKER_ID=str(r))) for r in range(2)]
        procs.append(subprocess.Popen(
            me + ["one", "--out", os.path.join(tmp, "one")], cwd=here,
            env=dict(os.environ)))
        rcs = run_procs(procs + [server], KV_ASYNC["timeout"])
        wall = time.perf_counter() - t0
        if rcs != [0, 0, 0, 0]:
            raise AssertionError("the launch form: rcs (workers, one "
                                 "process, server) %s" % rcs)
        w = [np.load(os.path.join(tmp, "sync%d.npz" % r)) for r in range(2)]
        one = np.load(os.path.join(tmp, "one.npz"))
        same = all(np.array_equal(w[0][k], w[1][k]) for k in one.files)
        dist = max(float(np.abs(w[0][k] - one[k]).max()) for k in one.files)
        rows = []
        for name in ("sync0", "sync1", "one"):
            with open(os.path.join(tmp, name + ".json")) as f:
                rows.append(json.load(f))
        log("  [%s] the launch form: python -m mxtpu_torch.kvstore_server "
            "and 2 MXTPU_ROLE=worker processes on dist_sync (the optimizer "
            "on the server): workers bit-identical %s, max |w - w_one| "
            "%.3e against one process on the whole batch (gate 1e-6); step "
            "ms worker 0 %s, one process %s; %.1f s wall" % (
                card, same, dist,
                [round(v, 2) for v in rows[0]["step_ms"]],
                [round(v, 2) for v in rows[2]["step_ms"]], wall))
        if not same or dist > 1e-6 or rows[2]["moved"] < 1e-3:
            raise AssertionError("the launch form: bit-identical %s, %.3e "
                                 "from one process" % (same, dist))
        out["launch"] = dict(step_ms=[r["step_ms"] for r in rows],
                             wall_s=wall, max_abs_to_one=dist)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _metric_counts(tel):
    """{(name, labels): value or count} of every series of the
    process-wide registry (counters by value, histograms by count)."""
    out = {}
    for m in tel.registry().series():
        key = (m.name, tuple(sorted(m.labels.items())))
        out[key] = m.count if isinstance(m, tel.Histogram) else m.value
    return out


def _delta(before, after, name, labels=()):
    key = (name, tuple(sorted(labels)))
    return after.get(key, 0) - before.get(key, 0)


def http_get(url, accept=None):
    """(body text, content type) of a GET on the local server."""
    import urllib.request
    req = urllib.request.Request(url, headers={"Accept": accept}
                                 if accept else {})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read().decode(), r.headers.get("Content-Type")


def scaffold_served(mt, att, seed, card):
    """Step 1 of phase 20: the LM of phase 4 served by ServingSession behind
    its HTTP server; the requests go in process (an answer is T x vocab
    probabilities, 1024 x 50257, too large a JSON body), the metrics are
    scraped over HTTP."""
    tel = mt.telemetry
    sym = mt.models.get_transformer_lm(**LM)
    params = lm_params(sym, seed)
    rng = np.random.default_rng(seed + 20)
    n = SCAFFOLD["requests"]
    requests = [rng.integers(0, LM["vocab_size"], (1, LM["seq_len"]))
                .astype(np.float32) for _ in range(n)]
    session = mt.serving.ServingSession(
        sym.tojson(), params, {"data": (1, LM["seq_len"])}, buckets=BUCKETS,
        contexts=[mt.gpu(0)], warmup=True)
    server = mt.serving.ServingHTTPServer(session, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    finished = []
    errors = []
    try:
        before = _metric_counts(tel)
        tel.tracing.set_span_sink(finished.append)
        att.flash_attention.launches = 0  # count the main path alone

        def client(idx):
            try:
                for r in range(idx, n, SCAFFOLD["clients"]):
                    out = session.predict({"data": requests[r]})[0]
                    if out.shape != (LM["seq_len"], LM["vocab_size"]) or \
                            not np.isfinite(out).all():
                        raise AssertionError("answer %d: %s" % (r,
                                                                out.shape))
            except Exception as exc:  # re-raised on the main thread below
                errors.append(exc)
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SCAFFOLD["clients"])]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        launches = att.flash_attention.launches
        tel.tracing.set_span_sink(None)
        after = _metric_counts(tel)
        v1 = json.loads(http_get(server.endpoint + "/v1/metrics")[0])
        full = json.loads(http_get(server.endpoint + "/metrics",
                                   accept="application/json")[0])
        text, ctype = http_get(server.endpoint + "/metrics")
    finally:
        tel.tracing.set_span_sink(None)
        server.shutdown()
    if errors:
        raise errors[0]
    batches = v1["batches_dispatched"]
    batch_spans = {k[1][0][1]: _delta(before, after, *k[:1], k[1])
                   for k in after if k[0] == "span_ms" and
                   k[1][0][1].startswith("batch[")}
    batch_spans = {k: v for k, v in batch_spans.items() if v}
    req_spans = {s.span_id: s for s in finished
                 if s.name == "serving.request"}
    bspans = [s for s in finished if s.name.startswith("batch[")]
    orphans = [s for s in bspans if s.parent_id not in req_spans or
               s.trace_id != req_spans[s.parent_id].trace_id]
    engine_series = sorted(k for k in full["mxtpu"]
                           if k.startswith("engine_"))
    log("  [%s] %d requests in %d batches served behind the HTTP server: "
        "/v1/metrics requests_received %d, requests_completed %d, "
        "batches_dispatched %d; /metrics (%s) span_ms of the batches %s, "
        "serving.request %d; engine series %s; batch spans %d, each the "
        "child of one of its requests' %d spans: %s; flash launches %d "
        "(want %d layers x %d batches)"
        % (card, n, batches, v1["requests_received"],
           v1["requests_completed"], batches, ctype, batch_spans,
           _delta(before, after, "span_ms", [("span", "serving.request")]),
           engine_series, len(bspans), len(req_spans), not orphans,
           launches, LM["num_layers"], batches))
    want_engine = {"engine_ops_completed", "engine_ops_dispatched",
                   "engine_queue_depth", "engine_queue_wait_ms",
                   "engine_worker_busy_ms", "engine_workers"}
    if v1["requests_received"] != n or v1["requests_completed"] != n or \
            batches < 1 or sum(batch_spans.values()) != batches or \
            _delta(before, after, "span_ms",
                   [("span", "serving.request")]) != n or \
            len(req_spans) != n or len(bspans) != batches or orphans or \
            not want_engine <= set(engine_series) or \
            ctype != tel.PROMETHEUS_CONTENT_TYPE or \
            "mxtpu_serving_requests_completed %d" % n not in text or \
            launches != LM["num_layers"] * batches:
        raise AssertionError("scaffolding: served metrics disagree with "
                             "what was sent")
    return dict(requests=n, batches=batches, launches=launches,
                batch_spans=batch_spans, engine_series=engine_series,
                request_latency_ms=v1["request_latency_ms"])


class StampedBatches(RepeatBatch):
    """phase 6's repeated batch, stamping the host clock at each fetch and
    calling ``hook(i)`` before handing out batch ``i`` (fit fetches batch
    i + 1 right after it dispatches step i)."""

    def __init__(self, mt, x, y, n, hook=None):
        super().__init__(mt, x, y, n)
        self.stamps = []
        self.hook = hook

    def __next__(self):
        if self.hook is not None:
            self.hook(self._i)
        self.stamps.append(time.perf_counter())
        return super().__next__()


def scaffold_fit(mt, att, sym, w0, x, y, on, tuned=None, hook=None):
    """One fit of phase 6's LM settings from the weights ``w0`` with
    telemetry ``on`` or off, through ``tuned`` (an artifact path) or the
    same knobs given explicitly: (module, the fit's series deltas, flash
    launches (fwd, bwd), mean step ms after the warm-up, weights)."""
    tel = mt.telemetry
    steps = TRAIN["steps"]
    knobs = {} if tuned else dict(max_in_flight=SCAFFOLD["max_in_flight"],
                                  metric_sync=SCAFFOLD["metric_sync"])
    tel.set_enabled(on)
    try:
        mod = mt.mod.Module(sym, context=mt.gpu(0), logger=_quiet_logger())
        it = StampedBatches(mt, x, y, steps, hook=hook)
        torch.cuda.synchronize()
        before = _metric_counts(tel)
        att.flash_attention.launches = 0  # count the main path alone
        att.flash_attention_backward.launches = 0
        mod.fit(it, num_epoch=1, eval_metric="ce", optimizer="adam",
                optimizer_params={"learning_rate": TRAIN["lr"]},
                arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                            for k, v in w0.items()},
                tuned=tuned, **knobs)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        after = _metric_counts(tel)
    finally:
        tel.set_enabled(True)
    launches = (att.flash_attention.launches,
                att.flash_attention_backward.launches)
    w = TRAIN["warmup"]
    step_ms = (t_end - it.stamps[w]) * 1e3 / (steps - w)
    deltas = {k: after[k] - before.get(k, 0) for k in after
              if k[0].startswith("fit_") or
              k == ("span_ms", (("span", "fit.step"),))}
    weights = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return mod, deltas, launches, step_ms, weights


def scaffold_trained(mt, att, seed, card, tmp):
    """Steps 2, 3 and 5 of phase 20: the LM trained through
    ``Module.fit(tuned=...)``, in turns with telemetry on and off; then a
    fifth fit with the engine chain pushed mid-fit and the profiler around
    two steps."""
    tel = mt.telemetry
    cfg = dict(LM)
    sym = mt.models.get_transformer_lm(**cfg)
    w0 = {k[4:]: v for k, v in lm_params(sym, seed).items()}
    x, y = lm_batch(seed, TRAIN["batch"], cfg["seq_len"], cfg["vocab_size"])
    path = os.path.join(tmp, "fit_tuned.json")
    mt.tune.TunedConfig(
        values={"fit.max_in_flight": SCAFFOLD["max_in_flight"],
                "fit.metric_sync": SCAFFOLD["metric_sync"]},
        provenance=[{"event": "chip_smoke", "phase": "scaffolding"}]
    ).save(path)
    steps = TRAIN["steps"]
    want_knobs = {"fit.max_in_flight": SCAFFOLD["max_in_flight"],
                  "fit.metric_sync": SCAFFOLD["metric_sync"],
                  "fit.device_metrics": True, "fit.device_prefetch": False}
    want_launches = (cfg["num_layers"] * steps,) * 2
    # the cadence syncs (every metric_sync batches and the last) and the
    # pacer's waits (one a step once max_in_flight are queued)
    n_syncs = len([i for i in range(steps) if i == steps - 1 or
                   (i and i % SCAFFOLD["metric_sync"] == 0)])
    n_waits = steps - SCAFFOLD["max_in_flight"]
    want_on = {("fit_step_ms", ()): steps, ("fit_dispatch_ms", ()): steps,
               ("span_ms", (("span", "fit.step"),)): steps,
               ("fit_samples", ()): steps * TRAIN["batch"],
               ("fit_epochs", ()): 1, ("fit_metric_sync_ms", ()): n_syncs,
               ("fit_sync_wait_ms", ()): n_waits}
    turns, ref_w = [], None
    for i, on in enumerate(SCAFFOLD["turns"]):
        mod, deltas, launches, ms, w = scaffold_fit(
            mt, att, sym, w0, x, y, on, tuned=path if i % 2 == 0 else None)
        same = ref_w is None or all(np.array_equal(w[k], ref_w[k])
                                    for k in ref_w)
        ref_w = ref_w or w
        got = {k: deltas.get(k, 0) for k in want_on}
        counted = got == (want_on if on else dict.fromkeys(want_on, 0))
        turns.append(dict(telemetry=on, tuned=i % 2 == 0, step_ms=ms,
                          launches=list(launches), knobs=mod._fit_knobs,
                          series=counted, bit_identical=same))
        log("  [%s] turn %d: telemetry %s, %s: step ms %.3f, flash "
            "launches fwd %d bwd %d, _fit_knobs %s, fit series %s%s, "
            "weights bit-identical to turn 0: %s"
            % (card, i, "on" if on else "off",
               "tuned=TunedConfig" if i % 2 == 0 else "explicit knobs", ms,
               launches[0], launches[1], mod._fit_knobs,
               {k[0] if not k[1] else "span_ms{fit.step}": v
                for k, v in got.items()},
               "" if counted else " (want %s)" % (
                   "the steps" if on else "none"), same))
        del mod
        torch.cuda.empty_cache()
        if turns[-1]["knobs"] != want_knobs or not same or \
                not counted or tuple(launches) != want_launches:
            raise AssertionError("scaffolding: turn %d %s" % (i, turns[-1]))
    on_ms = [t["step_ms"] for t in turns if t["telemetry"]]
    off_ms = [t["step_ms"] for t in turns if not t["telemetry"]]
    log("  [%s] LM step ms with telemetry on %s (mean %.3f, spread %.3f), "
        "off %s (mean %.3f, spread %.3f), in turns on, off, off, on; "
        "printed, not gated"
        % (card, [round(v, 3) for v in on_ms], float(np.mean(on_ms)),
           max(on_ms) - min(on_ms), [round(v, 3) for v in off_ms],
           float(np.mean(off_ms)), max(off_ms) - min(off_ms)))

    # the fifth fit: the engine chain mid-fit, the profiler around steps
    eng = mt.engine.get()
    a, b = eng.new_variable(), eng.new_variable()
    ran = []
    pushed = {}
    op_s = SCAFFOLD["engine_op_s"]

    def op(name):
        def body():
            t0 = time.perf_counter()
            time.sleep(op_s)
            ran.append((name, t0, time.perf_counter(),
                        tel.current_span().trace_id))
        return body

    first, last = SCAFFOLD["profiled_steps"]
    trace = os.path.join(tmp, "scaffold_profile.json")
    mt.profiler.set_config(mode="api", filename=trace)

    def hook(i):
        if i == SCAFFOLD["engine_step"]:
            with tel.span("scaffold.engine_push") as sp:
                pushed["trace_id"] = sp.trace_id
                eng.push(op("w1"), mutable_vars=[a])
                eng.push(op("r1"), const_vars=[a])
                eng.push(op("r2"), const_vars=[a])
                eng.push(op("w2"), mutable_vars=[a, b])
        # synchronized at both ends, so that the torch.profiler session
        # holds the kernels of the profiled steps and of no other
        if i == first:
            torch.cuda.synchronize()
            mt.profiler.set_state("run")
        if i == last + 1:
            torch.cuda.synchronize()
            mt.profiler.set_state("stop")

    completed = tel.registry().counter("engine_ops_completed")
    n0 = completed.value
    mod, deltas, launches, ms, w = scaffold_fit(mt, att, sym, w0, x, y, True,
                                                tuned=path, hook=hook)
    mt.profiler.set_state("stop")
    # waitall drains the engine and the card: a slow op and a long kernel
    # launched just before it are both done when it returns
    eng.push(op("slow"), mutable_vars=[b])
    torch.cuda._sleep(int(5e8))
    spun = torch.cuda.Event()
    spun.record()
    t0 = time.perf_counter()
    mt.nd.waitall()
    wait_ms = (time.perf_counter() - t0) * 1e3
    drained = spun.query() and len(ran) == 5
    by = {r[0]: r for r in ran}
    ordered = by["w1"][2] <= min(by["r1"][1], by["r2"][1]) and \
        max(by["r1"][2], by["r2"][2]) <= by["w2"][1]
    traced = all(by[k][3] == pushed["trace_id"]
                 for k in ("w1", "r1", "r2", "w2"))
    mt.profiler.dump_profile()
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for ev in events:
        if ev["ph"] == "B" and "trace_id" in ev.get("args", {}):
            spans.setdefault(ev["name"], set()).add(ev["args"]["trace_id"])
    with open(mt.profiler.torch_trace_path()) as f:
        tev = json.load(f)["traceEvents"]
    kernels = {}
    for ev in tev:
        name = str(ev.get("name", ""))
        if ev.get("cat") == "kernel" and "flash_" in name:
            kern = "flash_fwd" if "flash_fwd" in name else "flash_bwd"
            kernels[kern] = kernels.get(kern, 0) + 1
    same = all(np.array_equal(w[k], ref_w[k]) for k in ref_w)
    mt.profiler.clear()
    log("  [%s] engine chain pushed at step %d (trace id %d) on %d native "
        "workers: ran %s in dependency order %s, every dispatch span in the "
        "pusher's trace %s, engine_ops_completed +%d; nd.waitall() after a "
        "slow op and a long kernel: %.1f ms, drained %s"
        % (card, SCAFFOLD["engine_step"], pushed["trace_id"],
           eng.num_workers, [r[0] for r in ran], ordered, traced,
           completed.value - n0, wait_ms, drained))
    log("  [%s] profiler around steps %d-%d: chrome trace spans with trace "
        "ids %s; torch.profiler kernels %s; fifth fit's flash launches %s, "
        "weights bit-identical to turn 0: %s"
        % (card, first, last,
           {k: len(v) for k, v in sorted(spans.items())}, kernels,
           list(launches), same))
    n_prof = last - first + 1
    if not ordered or not traced or not drained or \
            completed.value - n0 != 5 or \
            len(spans.get("fit.step", ())) != n_prof or \
            not spans.get("executor.forward") or \
            not spans.get("executor.backward") or \
            not spans["executor.forward"] <= spans["fit.step"] or \
            kernels.get("flash_fwd", 0) < n_prof * cfg["num_layers"] or \
            kernels.get("flash_bwd", 0) < n_prof * cfg["num_layers"] or \
            tuple(launches) != want_launches or not same:
        raise AssertionError("scaffolding: engine/profiler step failed")
    del mod
    torch.cuda.empty_cache()
    fwd = sum(t["launches"][0] for t in turns) + launches[0]
    bwd = sum(t["launches"][1] for t in turns) + launches[1]
    return dict(turns=turns, on_ms=on_ms, off_ms=off_ms,
                fwd_launches=fwd, bwd_launches=bwd, engine_order=ordered,
                waitall_ms=wait_ms, profiled_spans=sorted(spans),
                profiled_kernels=kernels)


def scaffold_faults(mt, seed, card, tmp):
    """Step 4 of phase 20: phase 19's launch form (the server and two
    ``MXTPU_ROLE=worker`` processes on ``dist_sync``, the mlp) bare, then
    under the phase's MXTPU_FAULTS with retries."""
    here = os.path.dirname(os.path.abspath(__file__))
    me = [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
          "--kv-worker", "sync"]
    runs = {}
    for label, extra in (("bare", {}), ("faulted", {
            "MXTPU_FAULTS": SCAFFOLD["faults"],
            "MXTPU_KVSTORE_RETRIES": str(SCAFFOLD["retries"])})):
        port = free_port()
        kv_env = dict(os.environ, MXTPU_ROOT_URI="127.0.0.1",
                      MXTPU_ROOT_PORT=str(port), MXTPU_NUM_WORKERS="2")
        t0 = time.perf_counter()
        server = subprocess.Popen(
            [sys.executable, "-m", "mxtpu_torch.kvstore_server"], cwd=here,
            env=dict(kv_env, MXTPU_ROLE="server"))
        procs = [subprocess.Popen(
            me + ["--out", os.path.join(tmp, "%s%d" % (label, r))],
            cwd=here, env=dict(kv_env, MXTPU_ROLE="worker",
                               MXTPU_WORKER_ID=str(r), **extra))
            for r in range(2)]
        rcs = run_procs(procs + [server], KV_ASYNC["timeout"])
        wall = time.perf_counter() - t0
        if rcs != [0, 0, 0]:
            raise AssertionError("scaffolding: %s launch form rcs (workers, "
                                 "server) %s" % (label, rcs))
        rows = []
        for r in range(2):
            with open(os.path.join(tmp, "%s%d.json" % (label, r))) as f:
                rows.append(json.load(f))
        runs[label] = dict(
            weights=[np.load(os.path.join(tmp, "%s%d.npz" % (label, r)))
                     for r in range(2)],
            rows=rows, wall_s=wall)
    bare, faulted = runs["bare"], runs["faulted"]
    same = all(np.array_equal(fw[k], bw[k])
               for fw, bw in zip(faulted["weights"], bare["weights"])
               for k in bw.files)

    def total(row, prefix):
        return sum(v for k, v in row["telemetry"].items()
                   if k.startswith(prefix) and isinstance(v, (int, float)))
    fired = [total(r, "fault_injected") for r in faulted["rows"]]
    retried = [total(r, "retry_attempts") for r in faulted["rows"]]
    exhausted = [total(r, "retry_exhausted") for r in faulted["rows"]]
    clean = [total(r, "fault_injected") + total(r, "retry_attempts")
             for r in bare["rows"]]
    log("  [%s] the launch form under MXTPU_FAULTS=%r, "
        "MXTPU_KVSTORE_RETRIES=%d: fault_injected by worker %s, "
        "retry_attempts %s, retry_exhausted %s (bare run: %s); weights "
        "bit-identical to the bare run's %s; step ms worker 0 bare %s, "
        "faulted %s; %.1f s and %.1f s wall"
        % (card, SCAFFOLD["faults"], SCAFFOLD["retries"], fired, retried,
           exhausted, clean, same,
           [round(v, 2) for v in bare["rows"][0]["step_ms"]],
           [round(v, 2) for v in faulted["rows"][0]["step_ms"]],
           bare["wall_s"], faulted["wall_s"]))
    if not same or min(fired) <= 0 or min(retried) <= 0 or any(exhausted) \
            or any(clean):
        raise AssertionError("scaffolding: faulted launch form %s %s %s"
                             % (same, fired, retried))
    return dict(fault_injected=fired, retry_attempts=retried,
                bit_identical=same,
                step_ms={k: v["rows"][0]["step_ms"] for k, v in runs.items()},
                wall_s={k: v["wall_s"] for k, v in runs.items()})


def phase_scaffolding(mt, att, seed, card):
    """Phase 20: telemetry, tune, the engine, the profiler and the fault
    injection on the served and trained GPT-2-small LM and the TCP
    parameter server."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_scaffold_")
    try:
        t0 = time.perf_counter()
        out = {"served": scaffold_served(mt, att, seed, card)}
        torch.cuda.empty_cache()
        out["trained"] = scaffold_trained(mt, att, seed, card, tmp)
        out["faults"] = scaffold_faults(mt, seed, card, tmp)
        out["wall_s"] = time.perf_counter() - t0
        log("  phase wall %.1f s" % out["wall_s"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def compile_resnet_module(mt, sym, params, batch):
    """A ResNet-50 Module bound for inference at ``batch`` on gpu(0) with
    ``params`` (resnet_params' "arg:"/"aux:" dict)."""
    args, auxs = compile_split(mt, params)
    mod = mt.mod.Module(sym, context=mt.gpu(0), logger=_quiet_logger())
    mod.bind(data_shapes=[("data", (batch,) + RESNET["image_shape"])],
             label_shapes=[("softmax_label", (batch,))], for_training=False)
    mod.set_params(args, auxs)
    return mod


def compile_split(mt, params):
    """(arg_params, aux_params) NDArrays on cpu() of resnet_params'."""
    return mt.model.split_params(
        {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params.items()}, "")


def compile_iter(mt, x):
    """An NDArrayIter over ``x`` with zero labels, one batch."""
    return mt.io.NDArrayIter(x, np.zeros(len(x), np.float32),
                             batch_size=len(x))


def compile_turns(paths, rounds, iters):
    """ms of each named path's call, taken in turns: (a, b, b, a) per
    round, each turn ``warm`` once then ``cuda_ms`` over ``iters`` calls;
    ``paths`` maps a name to (enter, call) where ``enter()`` returns the
    context the turn runs in. Returns {name: [turn ms]}."""
    names = list(paths)
    order = (names + names[::-1]) * rounds
    out = {n: [] for n in names}
    for n in order:
        enter, call = paths[n]
        with enter():
            call()
            out[n].append(cuda_ms(call, iters, warmup=0))
    return out


#: kernel-name fragments by the category compile_profile sums them into
COMPILE_KINDS = (("flash", ("flash_",)), ("epilogue", ("rows_kernel",
                                                      "planes_kernel")),
                 ("conv", ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                           "implicit_gemm", "winograd")),
                 ("gemm", ("gemm", "cutlass", "cublas")),
                 ("batchnorm", ("batch_norm", "bn_")),
                 ("cast/copy", ("copy", "cast", "convert")),
                 ("reduce", ("reduce",)))


def compile_profile(call, label):
    """Device ms of one ``call()`` under torch.profiler, summed by kernel
    category (COMPILE_KINDS, first match; "other" for the rest), and the
    heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile as _prof
    call()
    torch.cuda.synchronize()
    with _prof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    total = sum(e.device_time_total for e in events) / 1e3
    kinds = {}
    for e in events:
        key = e.key.lower()
        kind = next((k for k, frags in COMPILE_KINDS
                     if any(f in key for f in frags)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.device_time_total / 1e3
    top = sorted(events, key=lambda e: -e.device_time_total)[:6]
    log("  profiled %s: %.3f ms of device time; by kind %s; top %s"
        % (label, total, {k: round(v, 3) for k, v in sorted(
            kinds.items(), key=lambda kv: -kv[1])},
           [(e.key[:48], round(e.device_time_total / 1e3, 3))
            for e in top]))
    return {"device_ms": total, "by_kind_ms": kinds,
            "top_ms": {e.key: e.device_time_total / 1e3 for e in top}}


def compile_predict(mt, epi, seed, card, sym, params, profile=False):
    """ResNet-50 v2 through Module.predict under pipeline_scope((layout,
    bf16)): every one of the 50 BatchNorm->ReLU sites is one epilogue
    launch with a bf16 side, on the rows path (channels last), each equal
    bit for bit to the plain epilogue on its own inputs; outputs against
    the f32 predict; times in turns."""
    from mxtpu_torch.ops import nn as nn_ops
    b = COMPILE["batch"]
    mod = compile_resnet_module(mt, sym, params, b)
    rng = np.random.default_rng(seed + 5)
    x = rng.standard_normal((b,) + RESNET["image_shape"], dtype=np.float32)
    it = compile_iter(mt, x)
    pipe = ("layout", "bf16")
    sites = []
    real = nn_ops.bn_apply_relu_add

    def spy(xx, scale, shift, residual=None, block_m=1024, axis=-1,
            out_dtype=None):
        y = real(xx, scale, shift, residual, block_m, axis, out_dtype)
        sites.append((xx.clone(), scale.clone(), shift.clone(), axis,
                      out_dtype, y.clone()))
        return y

    f32_out = mod.predict(it).asnumpy()
    it.reset()
    with mt.compile.pipeline_scope(pipe):
        nn_ops.bn_apply_relu_add = spy
        try:
            epi.bn_apply_relu_add.launches = 0  # count the main path alone
            out = mod.predict(it).asnumpy()
            torch.cuda.synchronize()
            launches = epi.bn_apply_relu_add.launches
        finally:
            nn_ops.bn_apply_relu_add = real
        ex = mod._exec_group.execs[0]
        report = ex.pipeline_report
    kinds = {}
    worst = 0.0
    for xx, scale, shift, axis, odt, y in sites:
        key = "%s->%s" % (str(xx.dtype)[6:], str(y.dtype)[6:])
        kinds[key] = kinds.get(key, 0) + 1
        outer, c, inner = epi._layout(tuple(xx.shape), axis)
        if inner != 1 or not xx.is_contiguous():
            raise AssertionError("an epilogue site took the planes path: "
                                 "%s axis %d" % (tuple(xx.shape), axis))
        want = epi.bn_apply_relu_add_reference(xx, scale, shift, None,
                                               axis, odt)
        worst = max(worst, bit_err(y, want))
    del sites
    low = sum(v for k, v in kinds.items() if "bfloat16" in k)
    log("  ResNet-50 v2 predict B=%d under %s: applied %s, epilogue "
        "launches %d (%s), every one on the rows path; kernel vs plain "
        "max abs err %g" % (b, pipe, report.applied if report else None,
                            launches, kinds, worst))
    if report is None or report.applied != list(pipe):
        raise AssertionError("the pipeline did not apply %s: %s"
                             % (pipe, report and report.render()))
    if launches != RESNET_SITES or low != RESNET_SITES or worst != 0.0:
        raise AssertionError("epilogue under %s: %d launches, %d with a "
                             "bf16 side, err %g (want %d, %d, 0)"
                             % (pipe, launches, low, worst, RESNET_SITES,
                                RESNET_SITES))
    if out.shape != f32_out.shape or not np.isfinite(out).all():
        raise AssertionError("bf16 predict output %s not finite"
                             % (out.shape,))
    diff = float(np.abs(out - f32_out).max())
    top1 = float((out.argmax(1) == f32_out.argmax(1)).mean())
    log("  bf16 vs f32 probabilities: max abs diff %.3e (largest %.3e); "
        "top-1 agreement %.3f" % (diff, float(f32_out.max()), top1))
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=mt.gpu(0))],
                         label=[mt.nd.zeros((len(x),), ctx=mt.gpu(0))])

    def call():
        mod.forward(db, is_train=False)
        mod.get_outputs()[0]._data.sum().item()

    turns = compile_turns(
        {"f32": (lambda: mt.compile.pipeline_scope(()), call),
         "layout,bf16": (lambda: mt.compile.pipeline_scope(pipe), call)},
        COMPILE["rounds"], COMPILE["iters"])
    med = {k: float(np.median(v)) for k, v in turns.items()}
    prof = {}
    if profile:
        for name, cfg in (("f32", ()), ("layout,bf16", pipe)):
            with mt.compile.pipeline_scope(cfg):
                prof[name] = compile_profile(
                    call, "ResNet-50 forward B=%d %s" % (b, name))
    log("  [%s] forward B=%d, turns of %d calls: f32 %s ms, layout,bf16 "
        "%s ms; median %.2f vs %.2f ms (%.2fx)"
        % (card, b, COMPILE["iters"], [round(v, 2) for v in turns["f32"]],
           [round(v, 2) for v in turns["layout,bf16"]], med["f32"],
           med["layout,bf16"], med["f32"] / med["layout,bf16"]))
    del mod
    torch.cuda.empty_cache()
    return dict(launches=launches, site_types=kinds, kernel_err=worst,
                max_abs_diff_vs_f32=diff, top1_vs_f32=top1,
                turns_ms=turns, median_ms=med, profile=prof)


def compile_lm(mt, att, seed, card, profile=False):
    """The LM of phase 6 trained through Module.fit under bf16 from the
    same weights as an f32 fit: 12 x steps flash forward and backward
    launches, every one bf16, the first of each held to its plain
    version; cross-entropy falls and stays near the f32 fit's; then
    single steps of the two modules timed in turns."""
    cfg = dict(LM)
    sym = mt.models.get_transformer_lm(**cfg)
    b, t, steps = TRAIN["batch"], cfg["seq_len"], TRAIN["steps"]
    x, y = lm_batch(seed, b, t, cfg["vocab_size"])
    want = cfg["num_layers"] * steps
    mods, ce, launches, caught, casts = {}, {}, {}, {}, {}
    init = None
    real_fwd, real_bwd = att._flash_forward, att._flash_bwd_cuda
    from mxtpu_torch.analysis import dataflow as _dataflow
    tables = (_dataflow._sensitive_tables, _dataflow._BF16_COMPUTE)
    # the control: a bf16 plan with no f32 island but the loss head (the
    # residual stream and every LayerNorm in bf16), to show what a plan
    # that left out its islands does to the cross-entropy
    for name, pipe in (("f32", ()), ("bf16", ("bf16",)),
                       ("bf16_no_islands", ("bf16",))):
        if name == "bf16_no_islands":
            _dataflow._sensitive_tables = set
            _dataflow._BF16_COMPUTE = tables[1] | {"Embedding"}
        mod = mt.mod.Module(sym, context=mt.gpu(0))
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", y.shape)])
        if init is None:
            np.random.seed(seed)
            mod.init_params(mt.init.Xavier())
            init = mod.get_params()
        else:
            mod.init_params(arg_params=init[0], aux_params=init[1])
        losses, dtypes = [], set()

        def record(param, losses=losses):
            losses.append(param.eval_metric.get()[1])
            param.eval_metric.reset()

        def fwd(q, k, v, causal, scale, want_lse=False, name=name):
            res = real_fwd(q, k, v, causal, scale, want_lse)
            if q.device.type == "meta":  # shape inference
                return res
            dtypes.add(q.dtype)
            if name not in caught:
                caught[name] = {"fwd": (q.clone(), k.clone(), v.clone(),
                                        causal, scale,
                                        res[0].clone() if want_lse
                                        else res.clone())}
            return res

        def bwd(q, k, v, out, dout, lse, causal, scale, name=name):
            res = real_bwd(q, k, v, out, dout, lse, causal, scale)
            if "bwd" not in caught[name]:
                caught[name]["bwd"] = (
                    tuple(z.clone() for z in (q, k, v, out, dout, lse)),
                    causal, scale, tuple(g.clone() for g in res))
            return res

        att._flash_forward, att._flash_bwd_cuda = fwd, bwd
        try:
            with mt.compile.pipeline_scope(pipe):
                att.flash_attention.launches = 0  # the main path alone
                att.flash_attention_backward.launches = 0
                mod.fit(RepeatBatch(mt, x, y, steps), num_epoch=1,
                        eval_metric="ce", optimizer="adam",
                        optimizer_params={"learning_rate": TRAIN["lr"]},
                        initializer=None, batch_end_callback=record,
                        metric_sync=1)
                torch.cuda.synchronize()
                launches[name] = (att.flash_attention.launches,
                                  att.flash_attention_backward.launches)
        finally:
            att._flash_forward, att._flash_bwd_cuda = real_fwd, real_bwd
            _dataflow._sensitive_tables, _dataflow._BF16_COMPUTE = tables
        report = mod._fused.pipeline_report
        log("  LM %s fit: applied %s; flash launches fwd %d bwd %d (want "
            "%d); attention dtypes %s; cross-entropy %s"
            % (name, report.applied if report else [], launches[name][0],
               launches[name][1], want, sorted(str(d) for d in dtypes),
               [round(v, 4) for v in losses]))
        if launches[name] != (want, want):
            raise AssertionError("LM %s flash launches %s != %d each"
                                 % (name, launches[name], want))
        wdt = torch.bfloat16 if pipe else torch.float32
        if dtypes != {wdt}:
            raise AssertionError("LM %s attention ran in %s" % (name,
                                                                dtypes))
        if len(losses) != steps or not np.all(np.isfinite(losses)) or \
                not losses[-1] < losses[0]:
            raise AssertionError("LM %s cross-entropy did not fall: %s"
                                 % (name, losses))
        ce[name] = losses
        casts[name] = sum(1 for n in mod._fused._graph_symbol._topo()
                          if not n.is_variable and n.op.name == "Cast")
        if name == "bf16_no_islands":
            del mod
        else:
            mods[name] = mod
    control_launches = launches.pop("bf16_no_islands")
    rel = [abs(a - b_) / b_ for a, b_ in zip(ce["bf16"], ce["f32"])]
    ctrl = [abs(a - b_) / b_ for a, b_ in zip(ce["bf16_no_islands"],
                                              ce["f32"])]
    log("  bf16 vs f32 cross-entropy, relative by step: %s (gate %g); the "
        "control with no f32 islands (%d Casts against bf16's %d): %s"
        % ([round(v, 6) for v in rel], COMPILE["lm_ce_rtol"],
           casts["bf16_no_islands"], casts["bf16"],
           [round(v, 6) for v in ctrl]))
    if max(rel) > COMPILE["lm_ce_rtol"]:
        raise AssertionError("bf16 cross-entropy strays from f32: %s" % rel)
    if not max(ctrl) > COMPILE["lm_ce_rtol"]:
        raise AssertionError("the control with no f32 islands stays within "
                             "the gate, which so cannot see one left out: "
                             "%s" % ctrl)
    errs = {}
    for name, got in caught.items():
        q, k, v, causal, scale, out = got["fwd"]
        ref = att.flash_attention_reference(q, k, v, causal=causal,
                                            sm_scale=scale)
        errs[name] = {"fwd": float((out.float() - ref.float()).abs().max())}
        ins, causal, scale, grads = got["bwd"]
        wants = att.flash_attention_backward_reference(
            *ins, causal=causal, sm_scale=scale)
        errs[name]["bwd"] = max(
            float(((g.float() - w.float()).abs()
                   / w.float().abs().max().clamp(min=1)).max())
            for g, w in zip(grads, wants))
        dt = ins[0].dtype
        if errs[name]["fwd"] > TOL[dt] or errs[name]["bwd"] > BWD_TOL[dt]:
            raise AssertionError("LM %s flash kernels vs plain: %s"
                                 % (name, errs[name]))
    log("  the first flash forward/backward of each fit vs the plain "
        "versions on its own inputs: %s" % errs)
    del caught
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=mt.cpu())],
                         label=[mt.nd.array(y, ctx=mt.cpu())])
    calls = {}
    for name, mod in mods.items():
        def call(mod=mod):
            for _ in range(COMPILE["lm_turn_steps"]):
                mod.forward_backward(db)
                mod.update()
        calls[name] = (lambda: mt.compile.pipeline_scope(()), call)
    turns = compile_turns(calls, COMPILE["rounds"], 1)
    med = {k: float(np.median(v)) / COMPILE["lm_turn_steps"]
           for k, v in turns.items()}
    prof = {}
    if profile:
        for name, mod in mods.items():
            def one(mod=mod):
                mod.forward_backward(db)
                mod.update()
            prof[name] = compile_profile(one, "LM training step %s" % name)
    log("  [%s] LM training step, turns of %d steps: f32 %.2f ms, bf16 "
        "%.2f ms (%.2fx)" % (card, COMPILE["lm_turn_steps"], med["f32"],
                             med["bf16"], med["f32"] / med["bf16"]))
    update = compile_update(mt, card, mods["f32"], "LM Adam")
    del mods
    torch.cuda.empty_cache()
    return dict(launches={k: list(v) for k, v in launches.items()},
                control_launches=list(control_launches), ce=ce,
                ce_rel=rel, control_ce_rel=ctrl, casts=casts, kernel_err=errs,
                step_ms=med, turns_ms=turns, profile=prof, update=update)


def compile_remat(mt, seed, card, sym, params):
    """ResNet-50 v2 trained COMPILE["remat_steps"] SGD steps at B=
    COMPILE["remat_batch"] without rematerialization (cuDNN deterministic,
    then not: the f32 path's own distance), with fit.remat=auto under
    remat_reuse and with fit.remat=block (deterministic): peak memory of
    each, and the remat weights within the gate (ROADMAP ops notes: a
    relative gate, the other f32 path's own distance); the steps timed in
    turns; then the fused step's update (compile_update)."""
    b, steps = COMPILE["remat_batch"], COMPILE["remat_steps"]
    rng = np.random.default_rng(seed + 7)
    x = rng.standard_normal((b,) + RESNET["image_shape"], dtype=np.float32)
    y = rng.integers(0, RESNET["num_classes"], b).astype(np.float32)
    runs, mods = {}, {}
    for name, pipe, remat, det in (
            ("none", (), None, True), ("none_nondet", (), None, False),
            ("remat_auto", ("remat_reuse",), "auto", True),
            ("remat_block", (), "block", True)):
        torch.backends.cudnn.deterministic = det
        if remat:
            os.environ["MXTPU_REMAT"] = remat
        mod = mt.mod.Module(sym, context=mt.gpu(0), logger=_quiet_logger())
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", y.shape)])
        mod.set_params(*compile_split(mt, params))
        db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=mt.cpu())],
                             label=[mt.nd.array(y, ctx=mt.cpu())])
        try:
            with mt.compile.pipeline_scope(pipe):
                mod.init_optimizer(optimizer="sgd", optimizer_params={
                    "learning_rate": COMPILE["lr"],
                    "momentum": COMPILE["momentum"],
                    "rescale_grad": 1.0 / b})
            mode = mod._fused._remat_mode
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = []
            for _ in range(steps):
                t0 = time.perf_counter()
                mod.forward_backward(db)
                mod.update()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() - base
        finally:
            os.environ.pop("MXTPU_REMAT", None)
            torch.backends.cudnn.deterministic = False
        w = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        runs[name] = dict(mode=mode, peak=int(peak), step_ms=ms, w=w)
        log("  ResNet-50 B=%d %s (remat mode %s): peak over the steps "
            "%.3f GB, step ms %s" % (b, name, mode, peak / 1e9,
                                     [round(v, 1) for v in ms]))
        if name != "none_nondet":
            mods[name] = (mod, db)
        del mod
        torch.cuda.empty_cache()

    def dist(a, b_):
        return max(float(np.abs(a[k] - b_[k]).max()
                         / max(np.abs(b_[k]).max(), 1e-12)) for k in a)

    d_nd = dist(runs["none_nondet"]["w"], runs["none"]["w"])
    gate = max(2 * d_nd, 1e-6)
    if runs["remat_auto"]["mode"] != "annotated":
        raise AssertionError("remat_reuse annotated nothing")
    d_rm = {}
    for name in ("remat_auto", "remat_block"):
        d_rm[name] = dist(runs[name]["w"], runs["none"]["w"])
        saved = 1 - runs[name]["peak"] / max(runs["none"]["peak"], 1)
        log("  %s vs none: peak %.3f vs %.3f GB (%.1f%% less); weights "
            "relative %.3e, the nondeterministic f32 path's own %.3e, gate "
            "%.3e" % (name, runs[name]["peak"] / 1e9,
                      runs["none"]["peak"] / 1e9, 100 * saved, d_rm[name],
                      d_nd, gate))
        if not runs[name]["peak"] < runs["none"]["peak"]:
            raise AssertionError("%s did not lower the peak memory" % name)
        if d_rm[name] > gate:
            raise AssertionError("%s weights %g from the plain fit (gate "
                                 "%g)" % (name, d_rm[name], gate))
    saved = 1 - runs["remat_auto"]["peak"] / max(runs["none"]["peak"], 1)
    calls = {}
    for name, (mod, db) in mods.items():
        def call(mod=mod, db=db):
            mod.forward_backward(db)
            mod.update()
        calls[name] = (contextlib.nullcontext, call)
    per_turn = COMPILE["remat_turn_steps"]
    turns = compile_turns(calls, COMPILE["remat_rounds"], per_turn)
    med = {k: float(np.median(v)) for k, v in turns.items()}
    log("  [%s] ResNet-50 B=%d training step, turns of %d steps: %s; "
        "median %s ms"
        % (card, b, per_turn, {k: [round(v, 2) for v in t]
                               for k, t in turns.items()},
           {k: round(v, 2) for k, v in med.items()}))
    update = compile_update(mt, card, mods["none"][0],
                            "ResNet-50 B=%d SGD" % b)
    del mods, calls
    torch.cuda.empty_cache()
    return {k: dict(mode=v["mode"], peak_bytes=v["peak"],
                    step_ms=v["step_ms"]) for k, v in runs.items()} | dict(
        weights_rel=d_rm["remat_auto"], block_weights_rel=d_rm["remat_block"],
        nondet_rel=d_nd, peak_saved=saved, turns_ms=turns, median_ms=med,
        update=update)


def compile_update(mt, card, mod, label):
    """The fused step's update on the card: its foreach form over its
    update lists against the optimizer's single-tensor update functions a
    parameter at a time (the chain the Updater runs), from the same
    weights, gradients and state: bit for bit after one update, then each
    timed in turns (device ms by cuda_ms, and host-clock ms of one update
    to a device sync)."""
    from mxtpu_torch import optimizer as topt
    fs = mod._fused
    o = fs.optimizer
    kind = type(o).__name__
    names = fs.trainable
    grads = fs._sums[0]
    lr, wd = 1e-3, 1e-4
    clip = o.clip_gradient or -1.0
    mom = float(getattr(o, "momentum", 0.0) or 0.0)

    def copy(v):
        return tuple(copy(x) for x in v) if isinstance(v, tuple) else \
            (None if v is None else v.clone())

    def fresh():
        return ({n: fs._targets[0][n].clone() for n in names},
                {n: copy(fs.opt_state[0][n]) for n in names})

    def chain(ps, ss):
        for n in names:
            if kind == "Adam":
                topt.adam_update_(ps[n], grads[n], ss[n][0], ss[n][1], lr,
                                  wd, o.rescale_grad, clip, o.beta1,
                                  o.beta2, o.epsilon)
            elif mom:
                topt.sgd_mom_update_(ps[n], grads[n], ss[n], lr, wd,
                                     o.rescale_grad, clip, mom)
            else:
                topt.sgd_update_(ps[n], grads[n], lr, wd, o.rescale_grad,
                                 clip)

    def lists(ps, ss):
        for group in fs._update_lists:
            fs._apply([ps[n] for n in group], [grads[n] for n in group],
                      [ss[n] for n in group], [lr] * len(group),
                      [wd] * len(group))

    forms = {"per_parameter": chain, "foreach": lists}
    state = {k: fresh() for k in forms}
    with torch.no_grad():
        for k, fn in forms.items():
            fn(*state[k])
        torch.cuda.synchronize()

        def leaves(v):
            return [x for y in v for x in leaves(y)] if \
                isinstance(v, tuple) else ([] if v is None else [v])
        a, b_ = state["per_parameter"], state["foreach"]
        same = all(torch.equal(a[0][n], b_[0][n]) and all(
            torch.equal(x, y) for x, y in zip(leaves(a[1][n]),
                                               leaves(b_[1][n])))
            for n in names)
        dev = {k: [] for k in forms}
        host = {k: [] for k in forms}
        iters = COMPILE["update_iters"]
        for k in (list(forms) + list(forms)[::-1]) * COMPILE["rounds"]:
            call = functools.partial(forms[k], *state[k])
            dev[k].append(cuda_ms(call, iters, warmup=1))
            walls = []
            for _ in range(iters):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            host[k].append(float(np.median(walls)))
    med = {k: (float(np.median(dev[k])), float(np.median(host[k])))
           for k in forms}
    log("  [%s] %s update of %d parameters in %d list(s): foreach bit for "
        "bit the per-parameter chain %s; device ms per-parameter %.3f, "
        "foreach %.3f; host-clock ms to a sync per-parameter %.3f, foreach "
        "%.3f (turns: device %s, host %s)"
        % (card, label, len(names), len(fs._update_lists), same,
           med["per_parameter"][0], med["foreach"][0],
           med["per_parameter"][1], med["foreach"][1],
           {k: [round(v, 3) for v in t] for k, t in dev.items()},
           {k: [round(v, 3) for v in t] for k, t in host.items()}))
    if not same:
        raise AssertionError("%s: the foreach update differs from the "
                             "per-parameter chain" % label)
    del state
    return dict(bit_identical=same, params=len(names),
                lists=len(fs._update_lists), device_ms=dev, host_ms=host,
                median_device_ms={k: v[0] for k, v in med.items()},
                median_host_ms={k: v[1] for k, v in med.items()})


def compile_quant(mt, epi, seed, card, sym, params):
    """int8 post-training quantization of ResNet-50 v2: a calibration
    forward at B=COMPILE["calib_batch"] (the recorder armed), then the
    quantized predict at B=COMPILE["batch"] on `__q8` weights (the
    epilogue sites still fused), top-1 agreement with f32 on the same
    batch, times in turns."""
    from mxtpu_torch.compile import quant as _quant
    b, cb = COMPILE["batch"], COMPILE["calib_batch"]
    rng = np.random.default_rng(seed + 9)
    calib = rng.standard_normal((cb,) + RESNET["image_shape"],
                                dtype=np.float32)
    x = rng.standard_normal((b,) + RESNET["image_shape"], dtype=np.float32)
    import tempfile
    corpus = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    prev = os.environ.get("MXTPU_CORPUS_DIR")
    os.environ["MXTPU_CORPUS_DIR"] = corpus
    try:
        cmod = compile_resnet_module(mt, sym, params, cb)
        t0 = time.perf_counter()
        with _quant.calibration_scope() as rec:
            cmod.predict(compile_iter(mt, calib))
        # the capture persisted to the measurement corpus and replayed
        # by the rewrite (through the quant.calibration_load fault point)
        if not _quant.persist_calibration(rec):
            raise AssertionError("the calibration was not persisted")
        calib_s = time.perf_counter() - t0
        del cmod
        mod = compile_resnet_module(mt, sym, params, b)
        f32 = mod.predict(compile_iter(mt, x)).asnumpy()
        with mt.compile.pipeline_scope(("quant",)):
            epi.bn_apply_relu_add.launches = 0
            out = mod.predict(compile_iter(mt, x)).asnumpy()
            launches = epi.bn_apply_relu_add.launches
            ex = mod._exec_group.execs[0]
            report = ex.pipeline_report
            q8 = sorted(ex._prepared_args)
            int8 = [v[2] for v in ex._prep_cache.values()]
    finally:
        if prev is None:
            os.environ.pop("MXTPU_CORPUS_DIR", None)
        else:
            os.environ["MXTPU_CORPUS_DIR"] = prev
        shutil.rmtree(corpus, ignore_errors=True)
    acts = sum(1 for f in report.findings() if "quantizes per-tensor" in
               f.message) if report is not None else 0
    top1 = float((out.argmax(1) == f32.argmax(1)).mean())
    diff = float(np.abs(out - f32).max())
    log("  calibration forward B=%d: %d samples over %d activations in "
        "%.1f s; quantized predict B=%d: applied %s, %d __q8 weights "
        "(int8 on the card: %s), %d activation quantize pairs, epilogue "
        "launches %d; vs f32: top-1 agreement %.3f, max abs diff %.3e"
        % (cb, rec.n_samples, len(rec.stats()), calib_s, b,
           report.applied if report else None, len(q8),
           all(t.dtype == torch.int8 and t.is_cuda for t in int8), acts,
           launches, top1, diff))
    if report is None or report.applied != ["quant"] or not q8 or \
            len(int8) != len(q8) or launches != RESNET_SITES or not acts:
        raise AssertionError("the quantized forward did not run on __q8 "
                             "weights with the fused sites")
    if not np.isfinite(out).all():
        raise AssertionError("quantized output not finite")
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=mt.gpu(0))],
                         label=[mt.nd.zeros((len(x),), ctx=mt.gpu(0))])

    def call():
        mod.forward(db, is_train=False)
        mod.get_outputs()[0]._data.sum().item()

    turns = compile_turns(
        {"f32": (lambda: mt.compile.pipeline_scope(()), call),
         "quant": (lambda: mt.compile.pipeline_scope(("quant",)), call)},
        COMPILE["rounds"], COMPILE["iters"])
    med = {k: float(np.median(v)) for k, v in turns.items()}
    log("  [%s] forward B=%d: f32 %.2f ms, quant %.2f ms" % (
        card, b, med["f32"], med["quant"]))
    del mod
    torch.cuda.empty_cache()
    return dict(q8_weights=len(q8), act_pairs=acts, launches=launches,
                top1_vs_f32=top1, max_abs_diff_vs_f32=diff,
                calib_samples=rec.n_samples, calib_s=calib_s,
                median_ms=med, turns_ms=turns)


def phase_compile(mt, att, epi, seed, card, profile=False):
    """Phase 21: the compile pipeline on the card: ResNet-50 v2 predicted
    under (layout, bf16) on the bf16 epilogue's rows path, the GPT-2-small
    LM trained under bf16 on the bf16 flash pair, ResNet-50 trained with
    fit.remat=auto under remat_reuse, and the quantized ResNet-50 after a
    calibration pass. With ``profile``, one ResNet-50 forward and one LM
    step in f32 and under the pipeline, each under torch.profiler."""
    t0 = time.perf_counter()
    sym = mt.models.get_resnet(**RESNET)
    params = resnet_params(sym, seed)
    out = {"resnet": compile_predict(mt, epi, seed, card, sym, params,
                                     profile)}
    out["lm"] = compile_lm(mt, att, seed, card, profile)
    out["remat"] = compile_remat(mt, seed, card, sym, params)
    out["quant"] = compile_quant(mt, epi, seed, card, sym, params)
    out["wall_s"] = time.perf_counter() - t0
    log("  phase wall %.1f s" % out["wall_s"])
    return out



# phase 22, observability: the LM of phase 6 trained `steps` steps through
# Module.fit at `metric_sync`, health off and on from one init, f32 and
# bf16 (Adam at `lr`), and in f32 once more with a default-stat Monitor
# of `monitor_interval` over `monitor_pattern` (the attention outputs);
# the health rows of step `capture_step` held to a float64 recomputation
# from that step's gradients and weights within `stat_rtol` (relative;
# each row is an f32 sum of squares over up to 3.9e7 elements, summed as
# a tree: its rounding stays below ~30 ulps, 2e-6, so 1e-4 is loose for
# the arithmetic and tight for any wrong term: a missing member or a
# bf16 operand errs by >= 4e-3); `turns` rounds of `turn_steps` steps of
# the on and off modules in turns. ResNet-50 v2 fit `resnet_steps` steps
# at B=`resnet_batch` with health on; the fit's untracked bytes (the CUDA
# allocator's requested bytes minus the ledger's, after the fit less
# before it, cuBLAS workspaces cleared both times) at most
# `reconcile_slack`: the fit leaves no device tensor outside the ledger
# but scalars freed with it, and the smallest tensor it keeps (a BN
# gamma, 256 B) must show. The LR bomb: the mlp at `bomb_lr` from step
# `bomb_step` (metric_sync 1). The watchdog: `wait_s` deadline, sampled
# every `interval_s`, one `latency_ms` injected wait in the mlp fit at
# max_in_flight 1. Serving: `requests` requests from `clients` threads.
OBS = dict(steps=8, metric_sync=4, lr=5e-4, monitor_interval=4,
           monitor_pattern=".*_attn_output", capture_step=5,
           stat_rtol=1e-4, turns=3, turn_steps=3, resnet_batch=256,
           resnet_steps=3, resnet_lr=0.1, reconcile_slack=0,
           monitor_batch=64, mlp_batch=64, mlp_steps=6, mlp_lr=0.1,
           bomb_step=3, bomb_lr=float("inf"), wait_s=0.25, interval_s=0.05,
           latency_ms=1500, requests=4, clients=2, tune_steps=8)


def obs_capture(mt, step):
    """Wrap FusedTrainStep.update to keep, at call ``step``, the health
    rows and float64 copies of the weights before and after and of the
    summed gradients; returns (the dict it fills, restore)."""
    ft = mt.module.fused.FusedTrainStep
    real = ft.update
    calls, cap = [0], {}

    def update(self):
        k = calls[0]
        calls[0] += 1
        if k != step or self._h is None:
            return real(self)
        names = self._h["names"]
        cap["old"] = [self._targets[0][n].double() for n in names]
        real(self)
        cap["new"] = [self._targets[0][n].double() for n in names]
        cap["grad"] = [self._sums[0][n].double() for n in names]
        cap["rows"] = {k_: self.last_health[k_].clone()
                       for k_ in ("sums", "max")}
        cap["classes"] = self._health_classes

    ft.update = update

    def restore():
        ft.update = real
    return cap, restore


def obs_stats_gate(cap, label):
    """The captured step's rows against float64 sums of its tensors."""
    want_s, want_m = [], []
    i = 0
    for _lbl, members in cap["classes"]:
        g2 = w2 = u2 = nf = 0.0
        gm = 0.0
        for _ in members:
            g, w, o = cap["grad"][i], cap["new"][i], cap["old"][i]
            g2 += float((g * g).sum())
            w2 += float((w * w).sum())
            u2 += float(((w - o) ** 2).sum())
            nf += float((~torch.isfinite(g)).sum()
                        + (~torch.isfinite(w)).sum())
            gm = max(gm, float(g.abs().max()))
            i += 1
        want_s.append((g2, w2, u2, nf))
        want_m.append(gm)
    got_s = cap["rows"]["sums"].double().cpu().numpy()
    got_m = cap["rows"]["max"].double().cpu().numpy()
    want_s, want_m = np.array(want_s), np.array(want_m)
    # relative to each class's value, floored at 1e-6 of the column's
    # largest: a class whose exact value is 0 (the attention's key bias
    # has no gradient: softmax ignores a shift of every score) holds
    # only the rounding noise of its own computation
    floor = 1e-6 * want_s[:, :3].max(axis=0, keepdims=True)
    rel = np.abs(got_s[:, :3] - want_s[:, :3]) / np.maximum(
        want_s[:, :3], np.maximum(floor, 1e-30))
    worst = float(rel.max())
    log("  %s health rows of step %d: %d classes; vs float64 worst "
        "relative error of the sums %.3e (gate %g), max-abs exact %s, "
        "nonfinite %d (want 0)"
        % (label, OBS["capture_step"], len(want_s), worst,
           OBS["stat_rtol"], bool((got_m == want_m).all()),
           int(got_s[:, 3].sum())))
    if not worst <= OBS["stat_rtol"] or not (got_m == want_m).all() or \
            got_s[:, 3].any() or want_s[:, 3].any():
        raise AssertionError("%s health rows disagree with float64: %g"
                             % (label, worst))
    return worst


def obs_lm_fit(mt, att, sym, init, x, y, pipe, health, monitor=None,
               capture=False):
    """One LM fit from ``init``: (module, its results)."""
    mod = mt.mod.Module(sym, context=mt.gpu(0), logger=_quiet_logger())
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mod.init_params(arg_params=init[0], aux_params=init[1])
    syncs, dtypes = [], set()
    real_fwd = att._flash_forward

    def fwd(q, k, v, causal, scale, want_lse=False):
        if q.device.type != "meta":
            dtypes.add(q.dtype)
        return real_fwd(q, k, v, causal, scale, want_lse)

    def record(param):
        acc = param.eval_metric._device_accum
        syncs.append(acc.syncs)

    cap, restore = obs_capture(mt, OBS["capture_step"]) if capture \
        else ({}, lambda: None)
    hist = mt.telemetry.histogram("fit_step_ms")
    n0, s0 = hist.count, hist.mean * hist.count
    att._flash_forward = fwd
    try:
        with mt.compile.pipeline_scope(pipe):
            _zero_flash_counts(att)
            mod.fit(RepeatBatch(mt, x, y, OBS["steps"]), num_epoch=1,
                    eval_metric="ce", optimizer="adam",
                    optimizer_params={"learning_rate": OBS["lr"]},
                    initializer=None, batch_end_callback=record,
                    metric_sync=OBS["metric_sync"], health=health,
                    monitor=monitor)
            torch.cuda.synchronize()
            launches = (att.flash_attention.launches,
                        att.flash_attention_backward.launches)
    finally:
        att._flash_forward = real_fwd
        restore()
    step_ms = (hist.mean * hist.count - s0) / (hist.count - n0)
    return mod, dict(launches=launches, syncs=syncs[-1], dtypes=dtypes,
                     step_ms=step_ms, capture=cap)


def obs_turns(mt, mods, x, y):
    """Steps of each module in turns (on, off, off, on, ...): the median
    ms of a step over `turns` rounds of `turn_steps` steps."""
    batch = mt.io.DataBatch(data=[mt.nd.array(x, ctx=mt.cpu())],
                            label=[mt.nd.array(y, ctx=mt.cpu())], pad=0)
    out = {k: [] for k in mods}
    order = list(mods)
    for r in range(OBS["turns"]):
        for k in (order if r % 2 == 0 else order[::-1]):
            mod = mods[k]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(OBS["turn_steps"]):
                mod.forward_backward(batch)
                mod.update()
            torch.cuda.synchronize()
            out[k].append((time.perf_counter() - t0) * 1e3
                          / OBS["turn_steps"])
    return {k: float(np.median(v)) for k, v in out.items()}


def obs_lm(mt, att, seed, card):
    """Step 1 of phase 22: the LM's health fits, f32 and bf16."""
    cfg = dict(LM)
    sym = mt.models.get_transformer_lm(**cfg)
    x, y = lm_batch(seed, TRAIN["batch"], cfg["seq_len"], cfg["vocab_size"])
    mod = mt.mod.Module(sym, context=mt.gpu(0), logger=_quiet_logger())
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    np.random.seed(seed)
    mod.init_params(mt.init.Xavier())
    init = mod.get_params()
    del mod
    want = cfg["num_layers"] * OBS["steps"]
    rows = {}
    for name, pipe in (("f32", ()), ("bf16", ("bf16",))):
        wdt = torch.bfloat16 if pipe else torch.float32
        off, r_off = obs_lm_fit(mt, att, sym, init, x, y, pipe, False)
        on, r_on = obs_lm_fit(mt, att, sym, init, x, y, pipe, True,
                              capture=True)
        w_off, w_on = off.get_params(), on.get_params()
        same = all(torch.equal(w_on[i][k]._data, w_off[i][k]._data)
                   for i in (0, 1) for k in w_off[i])
        worst = obs_stats_gate(r_on["capture"], "LM %s" % name)
        panel = on._health_session.panel_snapshot()
        with mt.compile.pipeline_scope(pipe):
            turns = obs_turns(mt, {"health_on": on, "health_off": off}, x,
                              y)
        log("  [%s] LM %s fits of %d steps: flash launches off %s on %s "
            "(want %d each); attention %s; metric syncs off %d on %d; "
            "weights bit for bit %s; health panel: %d classes, %d "
            "cadences, anomalies %s; fit step ms off %.2f on %.2f; in "
            "turns off %.2f on %.2f"
            % (card, name, OBS["steps"], r_off["launches"],
               r_on["launches"], want,
               sorted(str(d) for d in r_off["dtypes"] | r_on["dtypes"]),
               r_off["syncs"], r_on["syncs"], same, len(panel["classes"]),
               panel["cadences"], panel["anomalies"], r_off["step_ms"],
               r_on["step_ms"], turns["health_off"], turns["health_on"]))
        if r_off["launches"] != (want, want) or \
                r_on["launches"] != (want, want):
            raise AssertionError("LM %s flash launches %s / %s != %d"
                                 % (name, r_off["launches"],
                                    r_on["launches"], want))
        if r_off["dtypes"] | r_on["dtypes"] != {wdt}:
            raise AssertionError("LM %s attention ran in %s" % (
                name, r_off["dtypes"] | r_on["dtypes"]))
        if r_on["syncs"] != r_off["syncs"] or not same:
            raise AssertionError("LM %s: syncs %d vs %d, weights same %s"
                                 % (name, r_on["syncs"], r_off["syncs"],
                                    same))
        if panel["anomalies"] or any(c["nonfinite"]
                                     for c in panel["classes"]):
            raise AssertionError("LM %s health: %s" % (name, panel))
        rows[name] = dict(launches=r_on["launches"],
                          off_launches=r_off["launches"],
                          syncs=r_on["syncs"], stat_rel_err=worst,
                          fit_step_ms_off=r_off["step_ms"],
                          fit_step_ms_on=r_on["step_ms"],
                          turn_step_ms=turns, classes=len(panel["classes"]))
        del off, on, r_on, r_off
        torch.cuda.empty_cache()
    # the Monitor adapter over the attention outputs, in a health fit
    mon = mt.monitor.Monitor(OBS["monitor_interval"],
                             pattern=OBS["monitor_pattern"])
    tocs = []
    real_toc = mon.toc

    def toc():
        res = real_toc()
        if res:
            tocs.append(res)
        return res
    mon.toc = toc
    mod, r = obs_lm_fit(mt, att, sym, init, x, y, (), True, monitor=mon)
    names = sorted({k for res in tocs for _, k, _ in res})
    vals = [float(v.split()[0]) for res in tocs for _, _, v in res]
    sampled = -(-OBS["steps"] // OBS["monitor_interval"])
    log("  [%s] LM f32 health fit with a Monitor adapter over %s: %d "
        "sampled steps, %d stats each (%s...), all finite and positive "
        "%s; fused step armed %s; flash launches %s; metric syncs %d"
        % (card, OBS["monitor_pattern"], len(tocs),
           len(tocs[0]) if tocs else 0, names[:2],
           bool(vals) and all(np.isfinite(v) and v > 0 for v in vals),
           mod._fused is not None, r["launches"], r["syncs"]))
    if len(tocs) != sampled or any(len(t) != cfg["num_layers"]
                                   for t in tocs) or \
            mod._fused is None or mon._adapter is not mod or \
            r["launches"] != (want, want) or \
            not all(np.isfinite(v) and v > 0 for v in vals):
        raise AssertionError("the LM's Monitor adapter: %d tocs, fused %s"
                             % (len(tocs), mod._fused is not None))
    rows["monitor"] = dict(launches=r["launches"], sampled=len(tocs),
                           stats=len(tocs[0]), syncs=r["syncs"])
    del mod
    torch.cuda.empty_cache()
    return rows


def obs_monitor_step(mt, seed, card, per_op=None):
    """A sampled ResNet-50 step with the default-stat Monitor (the
    adapter: taps on the fused step) against an unsampled step of the
    same module and against the per-op path's sampled step (phase 12's
    row, or measured here), B=`monitor_batch`, cuDNN deterministic: the
    stats are every visible op output's, the fused step stays armed and
    the weights are bit for bit an unmonitored module's."""
    if per_op is None:
        per_op = surface_monitor_step(mt, seed, card)
    sym = mt.models.get_resnet(**RESNET)
    params = resnet_params(sym, seed)
    args, auxs = mt.model.split_params(
        {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params.items()}, "")
    b = OBS["monitor_batch"]
    rng = np.random.default_rng(seed + 22)
    batch = mt.io.DataBatch(
        [mt.nd.array(rng.standard_normal((b,) + RESNET["image_shape"],
                                         dtype=np.float32), ctx=mt.cpu())],
        [mt.nd.array(rng.integers(0, RESNET["num_classes"], b)
                     .astype(np.float32), ctx=mt.cpu())])
    internals = sym.get_internals().list_outputs()
    expect = len(internals) - len(sym.list_inputs())
    res = {}
    with DeterministicCudnn():
        for monitored in (False, True):
            mod = mt.mod.Module(sym, context=mt.gpu(0),
                                logger=_quiet_logger())
            _train_modules(mt, mod, args, auxs, b)
            mon = mt.monitor.Monitor(2) if monitored else None
            if mon is not None:
                mod.install_monitor(mon)
            ms, stats = [], []
            for _ in range(2):  # sampled, then unsampled
                if mon is not None:
                    mon.tic()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mod.forward_backward(batch)
                mod.update()
                stats.append(mon.toc() if mon else [])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            res[monitored] = dict(ms=ms, stats=[len(s) for s in stats],
                                  fused=mod._fused is not None,
                                  params=mod.get_params())
            del mod
    plain, ad = res[False], res[True]
    same_w = all(torch.equal(ad["params"][i][k]._data,
                             plain["params"][i][k]._data)
                 for i in (0, 1) for k in plain["params"][i])
    log("  [%s] Monitor adapter on a ResNet-50 step at B=%d: %d stats on "
        "the sampled step, %d on the unsampled; fused step armed %s; "
        "weights bit for bit the unmonitored module's %s; sampled step "
        "%.1f ms, unsampled %.1f ms (unmonitored %.1f, %.1f); the per-op "
        "path's sampled step %.1f ms (unmonitored %.1f)"
        % (card, b, ad["stats"][0], ad["stats"][1], ad["fused"], same_w,
           ad["ms"][0], ad["ms"][1], plain["ms"][0], plain["ms"][1],
           per_op["monitored_ms"], per_op["unmonitored_ms"]))
    if ad["stats"] != [expect, 0] or not ad["fused"] or not same_w:
        raise AssertionError("Monitor adapter: stats %s (want [%d, 0]), "
                             "fused %s, weights %s" % (
                                 ad["stats"], expect, ad["fused"], same_w))
    return dict(stats=ad["stats"][0], sampled_ms=ad["ms"][0],
                unsampled_ms=ad["ms"][1],
                unmonitored_ms=plain["ms"][1],
                per_op_sampled_ms=per_op["monitored_ms"],
                per_op_unmonitored_ms=per_op["unmonitored_ms"])


def obs_quiescent(mt):
    """The ledger's reconcile at a quiescent point: the card idle,
    garbage collected, cuBLAS workspaces released."""
    import gc
    torch.cuda.synchronize()
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    return mt.diagnostics.reconcile()


def obs_resnet(mt, epi, seed, card):
    """Step 2 of phase 22: ResNet-50 v2 fit with health on at
    B=`resnet_batch`: the ledger by origin, its reconcile, the
    evaluation forward's epilogue launches bit for bit the plain
    epilogue, and liveness_ledger_check on its graph."""
    sym = mt.models.get_resnet(**RESNET)
    params = resnet_params(sym, seed)
    args, auxs = mt.model.split_params(
        {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params.items()}, "")
    b = OBS["resnet_batch"]
    rng = np.random.default_rng(seed + 23)
    x = rng.random((b,) + RESNET["image_shape"], dtype=np.float32)
    y = rng.integers(0, RESNET["num_classes"], b).astype(np.float32)
    before = obs_quiescent(mt)
    mod = mt.mod.Module(sym, context=mt.gpu(0), logger=_quiet_logger())
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mod.init_params(arg_params=args, aux_params=auxs)
    t0 = time.perf_counter()
    mod.fit(RepeatBatch(mt, x, y, OBS["resnet_steps"]), num_epoch=1,
            eval_metric="ce", optimizer="sgd",
            optimizer_params={"learning_rate": OBS["resnet_lr"],
                              "momentum": 0.9},
            initializer=None, metric_sync=1, health=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    after = obs_quiescent(mt)
    snap = mt.diagnostics.ledger().snapshot()
    ctx = "gpu(0)"
    d0 = before["by_ctx"][ctx]["drift_bytes"] if before["allocator"] \
        and ctx in before["by_ctx"] else None
    d1 = after["by_ctx"][ctx]
    fit_drift = d1["drift_bytes"] - (d0 or 0)
    panel = mod._health_session.panel_snapshot()
    ex = mod._exec_group.execs[0]
    findings = mt.analysis.dataflow.liveness_ledger_check(ex)
    origins = {k: v for k, v in snap["live_bytes"].items()
               if k.startswith(ctx)}
    log("  [%s] ResNet-50 v2 fit(health=True) B=%d, %d steps in %.1f s: "
        "%d health classes, %d cadences, anomalies %s; ledger by origin %s"
        % (card, b, OBS["resnet_steps"], fit_s, len(panel["classes"]),
           panel["cadences"], panel["anomalies"], origins))
    log("  reconcile at a quiescent point: ledger %d B, allocator "
        "requested %d B (allocated %d, rounding %d B in %d blocks): drift "
        "%d B; before the module %s B; the fit's untracked bytes %d "
        "(slack %d); liveness_ledger_check findings %s"
        % (d1["ledger_bytes"], d1["requested_bytes"],
           d1["allocated_bytes"], d1["rounding_bytes"], d1["blocks"],
           d1["drift_bytes"], d0, fit_drift, OBS["reconcile_slack"],
           [f.message for f in findings]))
    if panel["cadences"] != OBS["resnet_steps"] or panel["anomalies"] or \
            any(c["nonfinite"] for c in panel["classes"]):
        raise AssertionError("ResNet-50 health: %s" % panel)
    if abs(fit_drift) > OBS["reconcile_slack"] or findings:
        raise AssertionError("ResNet-50 ledger: untracked %d B (slack %d), "
                             "findings %s" % (fit_drift,
                                              OBS["reconcile_slack"],
                                              findings))
    data = mt.nd.array(x, ctx=mt.gpu(0))
    batch = mt.io.DataBatch([data], [mt.nd.array(y, ctx=mt.gpu(0))])

    def forward():
        mod.forward(batch, is_train=False)
        return mod.get_outputs()[0]._data

    gate = eval_forward_gate(epi, forward, lambda: ex.fused_sites,
                             "ResNet-50 health fit's evaluation forward")
    if gate["eval_max_abs_err"] != 0.0:
        raise AssertionError("the evaluation forward is not bit for bit "
                             "the plain epilogue's: %g"
                             % gate["eval_max_abs_err"])
    row = dict(gate, origins=origins, reconcile=d1, drift_before=d0,
               fit_untracked_bytes=fit_drift, fit_s=fit_s,
               classes=len(panel["classes"]))
    del mod, ex, data, batch
    torch.cuda.empty_cache()
    return row


def obs_mlp(mt, seed, n=None):
    """The mlp (784-128-64-10) and `mlp_steps` seeded batches."""
    n = n or OBS["mlp_steps"]
    rng = np.random.RandomState(seed)
    b = OBS["mlp_batch"]
    x = rng.rand(b * n, 784).astype(np.float32)
    y = rng.randint(0, 10, b * n).astype(np.float32)
    return mt.models.get_mlp(10), x, y


def obs_mlp_fit(mt, sym, init, x, y, **kw):
    mod = mt.mod.Module(sym, context=mt.gpu(0), logger=_quiet_logger())
    mod.bind(data_shapes=[("data", (OBS["mlp_batch"], 784))],
             label_shapes=[("softmax_label", (OBS["mlp_batch"],))])
    mod.init_params(arg_params=init[0], aux_params=init[1])
    kw.setdefault("optimizer_params", {"learning_rate": OBS["mlp_lr"]})
    mod.fit(mt.io.NDArrayIter(x, y, OBS["mlp_batch"]), num_epoch=1,
            optimizer="sgd", initializer=None, **kw)
    torch.cuda.synchronize()
    return mod


def obs_init(mt, sym, seed, shape):
    mod = mt.mod.Module(sym, context=mt.gpu(0), logger=_quiet_logger())
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", shape[:1])])
    np.random.seed(seed)
    mod.init_params(mt.init.Xavier())
    return mod.get_params()


def obs_counter(mt, name, **labels):
    return mt.telemetry.registry().counter(name, labels=labels).value


def obs_bomb(mt, seed, card, corpus_dir, lr=None):
    """Step 3 of phase 22: the LR bomb. The mlp's lr jumps to `bomb_lr`
    (or ``lr``) after step `bomb_step` - 1: that step's fresh weights are
    nonfinite, and health_anomalies{kind=divergence} fires at its cadence
    (corpus row `bomb_step` + 1), with exactly one postmortem. At an lr
    past the f32 range (1e39, phase 23) the fused update rounds it to inf
    on the host, as mxtpu's f32 arithmetic does, and the fit runs on."""
    lr = OBS["bomb_lr"] if lr is None else lr
    sym, x, y = obs_mlp(mt, seed)
    init = obs_init(mt, sym, seed, (OBS["mlp_batch"], 784))
    div0 = obs_counter(mt, "health_anomalies", kind="divergence")
    pm0 = obs_counter(mt, "diag_postmortems", source="health")

    def bomb(param):
        if param.nbatch == OBS["bomb_step"] - 1:
            param.locals["self"]._optimizer.lr = lr
    mt.obs.corpus.reset()
    os.environ["MXTPU_CORPUS_DIR"] = corpus_dir
    try:
        mod = obs_mlp_fit(mt, sym, init, x, y, eval_metric="ce",
                          metric_sync=1, health=True,
                          batch_end_callback=bomb)
    finally:
        del os.environ["MXTPU_CORPUS_DIR"]
        mt.obs.corpus.reset()
    rows = [r for r in mt.obs.corpus.load(corpus_dir)
            if r["row"] == "health"]
    fired = [r["cadence"] for r in rows if r.get("anomalies")
             and "divergence" in r["anomalies"]]
    div = obs_counter(mt, "health_anomalies", kind="divergence") - div0
    pms = obs_counter(mt, "diag_postmortems", source="health") - pm0
    pm = mt.diagnostics.last_postmortem()
    log("  [%s] LR bomb (lr %g from step %d): divergence at cadences %s "
        "(want [%d]); health_anomalies{kind=divergence} +%d, health "
        "postmortems +%d: %s"
        % (card, lr, OBS["bomb_step"], fired,
           OBS["bomb_step"] + 1, div, pms, pm["reason"][:90]))
    if fired != [OBS["bomb_step"] + 1] or div != 1 or pms != 1 or \
            pm["source"] != "health":
        raise AssertionError("LR bomb: fired %s, divergence +%d, "
                             "postmortems +%d" % (fired, div, pms))
    del mod
    return dict(lr=lr, fired_cadence=fired[0], divergence=div,
                postmortems=pms)


def obs_watchdog(mt, seed, card):
    """Step 4 of phase 22: one `latency_ms` wait injected at
    executor.device_wait inside the mlp fit (max_in_flight 1), the
    watchdog's deadline `wait_s`: exactly one postmortem naming the
    wait, with the flight ring, the engine state and the ledger; the fit
    ends bit for bit the bare fit."""
    diag = mt.diagnostics
    sym, x, y = obs_mlp(mt, seed)
    init = obs_init(mt, sym, seed, (OBS["mlp_batch"], 784))
    bare = obs_mlp_fit(mt, sym, init, x, y, max_in_flight=1)
    saved = {k: os.environ.get(k) for k in ("MXTPU_WATCHDOG_WAIT_S",
                                            "MXTPU_WATCHDOG_INTERVAL_S")}
    diag.stop_watchdog()
    os.environ["MXTPU_WATCHDOG_WAIT_S"] = str(OBS["wait_s"])
    os.environ["MXTPU_WATCHDOG_INTERVAL_S"] = str(OBS["interval_s"])
    pm0 = obs_counter(mt, "diag_postmortems", source="watchdog")
    t0 = time.perf_counter()
    try:
        with mt.faults.scope("executor.device_wait:latency_ms=%d,times=1,"
                             "after=2" % OBS["latency_ms"]):
            faulted = obs_mlp_fit(mt, sym, init, x, y, max_in_flight=1)
        time.sleep(4 * OBS["interval_s"])
    finally:
        diag.stop_watchdog()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    fit_s = time.perf_counter() - t0
    pms = obs_counter(mt, "diag_postmortems", source="watchdog") - pm0
    pm = diag.last_postmortem()
    wb, wf = bare.get_params(), faulted.get_params()
    same = all(torch.equal(wb[i][k]._data, wf[i][k]._data)
               for i in (0, 1) for k in wb[i])
    keys = sorted(k for k in ("flight", "engine", "ledger", "waits",
                              "programs") if k in pm)
    log("  [%s] watchdog (deadline %.2f s, one %d ms injected wait): "
        "watchdog postmortems +%d, reason %r, with %s (flight %d events, "
        "engine %s, ledger %d B live); the faulted fit %.1f s, weights "
        "bit for bit the bare fit's %s"
        % (card, OBS["wait_s"], OBS["latency_ms"], pms, pm["reason"],
           keys, len(pm.get("flight", ())), pm.get("engine", {}).get("type"),
           pm.get("ledger", {}).get("live_bytes_total", 0), fit_s, same))
    if pms != 1 or pm["source"] != "watchdog" or \
            "device_wait" not in pm["reason"] or \
            not {"flight", "engine", "ledger"} <= set(keys) or \
            not pm["flight"] or not same:
        raise AssertionError("watchdog: postmortems +%d (%s), weights %s"
                             % (pms, pm.get("reason"), same))
    return dict(postmortems=pms, reason=pm["reason"], fit_s=fit_s)


def obs_served(mt, att, seed, card, corpus_dir):
    """Step 5 of phase 22: the LM served behind the HTTP server with the
    span ring armed and the corpus on: /debug/state with mxtpu's keys
    and the serving pool's ledger origin, /debug/trace a Chrome trace of
    the requests' spans, the corpus's service rows."""
    mt.obs.trace.install()
    ring = mt.obs.trace.ring()
    ring.clear()
    sym = mt.models.get_transformer_lm(**LM)
    params = lm_params(sym, seed)
    rng = np.random.default_rng(seed + 22)
    n = OBS["requests"]
    requests = [rng.integers(0, LM["vocab_size"], (1, LM["seq_len"]))
                .astype(np.float32) for _ in range(n)]
    mt.obs.corpus.reset()
    os.environ["MXTPU_CORPUS_DIR"] = corpus_dir
    session = server = None
    errors = []
    try:
        session = mt.serving.ServingSession(
            sym.tojson(), params, {"data": (1, LM["seq_len"])},
            buckets=BUCKETS, contexts=[mt.gpu(0)], warmup=True)
        server = mt.serving.ServingHTTPServer(session, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        att.flash_attention.launches = 0

        def client(idx):
            try:
                for r in range(idx, n, OBS["clients"]):
                    out = session.predict({"data": requests[r]})[0]
                    if not np.isfinite(out).all():
                        raise AssertionError("answer %d not finite" % r)
            except Exception as exc:  # re-raised on the main thread
                errors.append(exc)
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(OBS["clients"])]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        launches = att.flash_attention.launches
        state = json.loads(http_get(server.endpoint + "/debug/state")[0])
        trace = json.loads(http_get(server.endpoint + "/debug/trace")[0])
        batches = session.stats()["batches_dispatched"]
    finally:
        if server is not None:
            server.shutdown()
        elif session is not None:
            session.close()
        del os.environ["MXTPU_CORPUS_DIR"]
        mt.obs.corpus.reset()
    if errors:
        raise errors[0]
    svc = [r for r in mt.obs.corpus.load(corpus_dir)
           if r["row"] == "service" and r["source"] == "serving"]
    slices = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    req = [e for e in slices if e["name"] == "serving.request"]
    bat = [e for e in slices if e["name"].startswith("batch[")]
    want_keys = {"time", "pid", "ledger", "programs", "flight", "engine",
                 "waits", "concurrency", "trace", "serving"}
    if torch.cuda.is_available():
        want_keys.add("reconcile")  # the allocator's drift check
    origin = state["ledger"]["live_bytes"].get(
        "%s/serving_pool" % mt.gpu(0), 0)
    log("  [%s] %d requests served in %d batches behind the HTTP server: "
        "/debug/state keys %s, serving_pool %d B live; /debug/trace %d "
        "events, %d serving.request and %d batch slices; corpus service "
        "rows %d; flash launches %d"
        % (card, n, batches, sorted(state), origin,
           len(trace["traceEvents"]), len(req), len(bat), len(svc),
           launches))
    if not want_keys <= set(state) or origin <= 0 or len(req) != n or \
            len(bat) != batches or len(svc) != batches or \
            launches != LM["num_layers"] * batches:
        raise AssertionError("served LM debug surface: keys %s, origin %d, "
                             "request slices %d, batch slices %d, rows %d"
                             % (sorted(state), origin, len(req), len(bat),
                                len(svc)))
    return dict(batches=batches, launches=launches, keys=sorted(state),
                serving_pool_bytes=origin, trace_events=len(
                    trace["traceEvents"]), corpus_rows=len(svc))


def obs_tune(mt, seed, card, tmp):
    """Step 6 of phase 22: `python -m mxtpu_torch.tune search` with its
    probes on the card writes a TunedConfig; an mlp fit(tuned=...) loads
    and applies its fit knobs; an OnlineController attached to that fit,
    stepped after every batch, keeps fit.max_in_flight inside its
    certified range, every move counted in tune_adjustments{knob}."""
    import subprocess
    path = os.path.join(tmp, "tuned.json")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mxtpu_torch.tune",
                           "search", "--out", path, "--ctx", "gpu"],
                          capture_output=True, text=True, timeout=600)
    search_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError("tune search failed: %s" % proc.stderr[-2000:])
    cfg = mt.tune.TunedConfig.load(path, strict=True)
    probes = [e for e in cfg.evidence if e.get("stage") == "probe"]
    knob = mt.tune.get_knob("fit.max_in_flight")
    lo, hi = knob.safe_range
    sym, x, y = obs_mlp(mt, seed, OBS["tune_steps"])
    init = obs_init(mt, sym, seed, (OBS["mlp_batch"], 784))
    ctl = mt.tune.OnlineController(artifact=cfg).activate()
    adj0 = obs_counter(mt, "tune_adjustments", knob="fit.max_in_flight")
    seen, moves = [], []

    def step(param):
        # the live signals each batch; at batch 2 also a reading of no
        # memory headroom, which must back the window off one step
        moves.extend(ctl.step())
        if param.nbatch == 2:
            moves.extend(ctl.step(signals={"mem_headroom_frac": 0.0}))
        b = ctl._bound.get("fit.max_in_flight")
        if b is not None:
            seen.append(b.get())
    try:
        mod = obs_mlp_fit(mt, sym, init, x, y, tuned=path,
                          batch_end_callback=step)
    finally:
        ctl.deactivate()
    adj = obs_counter(mt, "tune_adjustments",
                      knob="fit.max_in_flight") - adj0
    events = [e for e in cfg.provenance if e.get("event") == "online-adjust"]
    applied = {k: mod._fit_knobs[k] for k in ("fit.max_in_flight",
                                              "fit.device_prefetch")}
    log("  [%s] tune search on the card in %.1f s: %d probes, values %s; "
        "the tuned fit's knobs %s; the online controller's window %s "
        "(certified %s..%s), %d moves, tune_adjustments +%d, provenance "
        "events %d"
        % (card, search_s, len(probes), cfg.values, applied, seen, lo, hi,
           len(moves), adj, len(events)))
    if not probes or any(applied[k] != cfg.values[k] for k in applied) or \
            len(seen) != OBS["tune_steps"] or not moves or \
            not all(lo <= v <= hi for v in seen) or \
            adj != len(moves) or len(events) != len(moves):
        raise AssertionError("tune: probes %d, knobs %s vs %s, window %s, "
                             "moves %d, counter +%d"
                             % (len(probes), applied, cfg.values, seen,
                                len(moves), adj))
    return dict(search_s=search_s, probes=len(probes), values=cfg.values,
                window=seen, moves=len(moves))


def phase_observability(mt, att, epi, seed, card, per_op=None):
    """Phase 22: A.10 on the card (see OBS)."""
    import tempfile
    t0 = time.perf_counter()
    out = {"lm": obs_lm(mt, att, seed, card)}
    out["monitor_step"] = obs_monitor_step(mt, seed, card, per_op)
    out["resnet"] = obs_resnet(mt, epi, seed, card)
    with tempfile.TemporaryDirectory() as tmp:
        out["bomb"] = obs_bomb(mt, seed, card, os.path.join(tmp, "bomb"))
        out["watchdog"] = obs_watchdog(mt, seed, card)
        out["served"] = obs_served(mt, att, seed, card,
                                   os.path.join(tmp, "served"))
        out["tune"] = obs_tune(mt, seed, card, tmp)
    out["launches"] = {
        "flash_fwd": {"lm_training_health_f32": out["lm"]["f32"]["launches"][0]
                      + out["lm"]["f32"]["off_launches"][0],
                      "lm_training_health_bf16":
                      out["lm"]["bf16"]["launches"][0]
                      + out["lm"]["bf16"]["off_launches"][0],
                      "lm_training_monitor_adapter":
                      out["lm"]["monitor"]["launches"][0],
                      "lm_serving_debug": out["served"]["launches"]},
        "flash_bwd": {"lm_training_health_f32": out["lm"]["f32"]["launches"][1]
                      + out["lm"]["f32"]["off_launches"][1],
                      "lm_training_health_bf16":
                      out["lm"]["bf16"]["launches"][1]
                      + out["lm"]["bf16"]["off_launches"][1],
                      "lm_training_monitor_adapter":
                      out["lm"]["monitor"]["launches"][1]},
        "epilogue": {"resnet_health_eval": out["resnet"]["eval_launches"]}}
    out["phase_s"] = time.perf_counter() - t0
    log("  phase 22 took %.1f s" % out["phase_s"])
    return out


# phase 23, continuous serving (A.11): the LM of phase 4 at K=`inflight`
# batches in flight, `requests` requests from `clients` threads; burst and
# continuous in `turns`, `turn_requests` requests from `turn_clients`
# threads a turn, after two untimed rounds each (PyTorch's caching host
# allocator then holds the pinned blocks); a hot-swap while `clients`
# threads send until `swap_settle_s` after swap_model returns (at most
# `swap_max_requests` each); ResNet-50 v2 at RESNET_BUCKETS from
# `resnet_clients` threads, `resnet_requests` requests; the HTTP taxonomy
# on the mlp fixture with `max_queue` and a burst of `overload` requests
CONT = dict(inflight=2, requests=16, clients=4,
            turns=("burst", "continuous", "continuous", "burst"),
            turn_requests=32, turn_clients=8, swap_settle_s=0.3,
            swap_max_requests=64, resnet_requests=48, resnet_clients=8,
            max_queue=8, overload=24, respawn_s=60.0)


def lm_seeded(mt, seed):
    """The phase-4 LM's graph and seeded weights."""
    sym = mt.models.get_transformer_lm(**LM)
    return sym, sym.tojson(), lm_params(sym, seed)


class ServedBatches:
    """Record every batch a session answers: its bucket, the version its
    replica serves, the padded inputs, its items, the host ms of its
    replica's ``dispatch``, and on the card its device ms (input copy to
    last kernel) and answer-copy ms (events of the pool's handle)."""

    def __init__(self, mt):
        self.srv = mt.serving.server.ServingSession
        self.rep = mt.serving.pool._Replica
        self.real_answer = self.srv._answer
        self.real_dispatch = self.rep.dispatch
        self.rows = []
        self.dispatch_ms = []
        rows, dms = self.rows, self.dispatch_ms
        real_answer, real_dispatch = self.real_answer, self.real_dispatch

        def answer(sess, batch, rep, handle):
            real_answer(sess, batch, rep, handle)
            rows.append(dict(bucket=batch.bucket, version=rep.version_tag,
                             inputs=batch.inputs, items=list(batch.items),
                             device_ms=handle.device_ms(),
                             copy_ms=handle.copy_ms(),
                             t=time.perf_counter()))

        def dispatch(rep, inputs):
            t0 = time.perf_counter()
            try:
                return real_dispatch(rep, inputs)
            finally:
                dms.append((time.perf_counter() - t0) * 1e3)

        self.srv._answer = answer
        self.rep.dispatch = dispatch

    def close(self):
        self.srv._answer = self.real_answer
        self.rep.dispatch = self.real_dispatch


def digest(a):
    import hashlib
    return hashlib.sha1(np.ascontiguousarray(a).view(np.uint8)).hexdigest()


def direct_identity(mt, sym_json, params_by_version, rows, answers):
    """Every served batch against a direct Predictor on the same card at
    its bucket's shape, on the same padded inputs, with the weights of the
    version its replica served: each request's answer (an array, or its
    ``digest``) bit for bit the direct rows. Returns (batches checked,
    worst max abs err; inf for a digest that differs)."""
    preds = {}
    worst = 0.0
    for row in rows:
        key = (row["version"], row["bucket"])
        if key not in preds:
            preds[key] = mt.Predictor(
                sym_json, params_by_version[row["version"]],
                ctx=mt.gpu(0), input_shapes={
                    k: v.shape for k, v in row["inputs"].items()})
        p = preds[key]
        p.forward(**row["inputs"])
        out = p.get_outputs()[0]
        per = out.shape[0] // row["bucket"]
        r0 = 0
        for it in row["items"]:
            want = out[r0 * per:(r0 + it.n) * per]
            got = answers[id(it)]
            if isinstance(got, str):
                if got != digest(want):
                    worst = float("inf")
            elif got.shape != want.shape:
                raise AssertionError("answer shape %s != direct %s"
                                     % (got.shape, want.shape))
            elif not np.array_equal(got, want):
                worst = max(worst, float(np.abs(got - want).max()))
            r0 += it.n
    return len(rows), worst


def cont_lm(mt, att, seed, card):
    """23.1: the LM served continuously at K=2, byte-identical to direct
    Predictors; then burst and continuous in turns."""
    sym, sym_json, params = lm_seeded(mt, seed)
    shapes = {"data": (1, LM["seq_len"])}
    rng = np.random.default_rng(seed + 23)
    n = CONT["requests"]
    requests = [rng.integers(0, LM["vocab_size"], (1, LM["seq_len"]))
                .astype(np.float32) for _ in range(n)]
    t0 = time.perf_counter()
    sess = mt.serving.ServingSession(
        sym_json, params, shapes, buckets=BUCKETS, contexts=[mt.gpu(0)],
        mode="continuous", max_in_flight=CONT["inflight"],
        version_tag="lm-a")
    log("  session up in %.2f s; warmup batch ms %s; cost rows %s"
        % (time.perf_counter() - t0, sess.warmup_ms,
           sess.pool.bucket_costs()))
    rec = ServedBatches(mt)
    answers, errors = {}, []

    def client(idx):
        try:
            for r in range(idx, n, CONT["clients"]):
                fut = sess.predict_async({"data": requests[r]})
                answers[id(fut)] = fut.wait(600)[0]
        except Exception as exc:  # re-raised on the main thread below
            errors.append(exc)
    try:
        att.flash_attention.launches = 0  # count the main path alone
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(CONT["clients"])]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = att.flash_attention.launches
        batches = sess.metrics.counter("batches_dispatched").value
        stats = sess.stats()
    finally:
        rec.close()
    if errors:
        sess.close()
        raise errors[0]
    if len(answers) != n:
        sess.close()
        raise AssertionError("%d of %d requests answered" % (len(answers),
                                                             n))
    checked, worst = direct_identity(mt, sym_json, {"lm-a": params},
                                     rec.rows, answers)
    # a request alone at bucket 1 against its row in a served bucket-4
    # batch: does cuBLAS make a row depend on its batch? (printed)
    alone = mt.Predictor(sym_json, params, ctx=mt.gpu(0),
                         input_shapes=shapes)
    row_dep = []
    for row in rec.rows:
        if row["bucket"] != 1:
            it = row["items"][0]
            alone.forward(data=it.inputs["data"])
            a = alone.get_outputs()[0]
            row_dep.append(float(np.abs(a - answers[id(it)]).max()))
            break
    del alone
    dev = [r["device_ms"] for r in rec.rows]
    copy = [r["copy_ms"] for r in rec.rows]
    log("  [%s] LM continuous K=%d: %d requests in %d batches (%.3f "
        "requests/s); flash launches %d (want %d x %d); %d batches held "
        "to a direct Predictor at their bucket on gpu(0): max abs err %g "
        "(want 0); a bucket-4 row against the request alone at bucket 1: "
        "max abs err %s; rep.dispatch host ms mean %.3f max %.3f against "
        "the batch's device ms mean %.3f; answer copy ms mean %.3f"
        % (card, CONT["inflight"], n, batches, n / wall, launches,
           LM["num_layers"], batches, checked, worst, row_dep,
           np.mean(rec.dispatch_ms), np.max(rec.dispatch_ms),
           np.mean(dev), np.mean(copy)))
    if launches != LM["num_layers"] * batches or batches < 1:
        sess.close()
        raise AssertionError("flash launches %d != %d x %d" % (
            launches, LM["num_layers"], batches))
    if worst != 0.0:
        sess.close()
        raise AssertionError("continuous answers differ from the direct "
                             "Predictor: %g" % worst)
    ring = mt.serving.pool.host_pinned_bytes()
    log("  pinned host bytes held by PyTorch's caching host allocator "
        "(staging and answer tensors; host memory, outside the device "
        "ledger): %s" % ring)
    out = dict(requests=n, batches=batches, launches=launches,
               requests_per_s=n / wall, direct_batches=checked,
               pinned_ring_bytes=ring,
               row_dependence=row_dep,
               dispatch_host_ms=list(rec.dispatch_ms), device_ms=dev,
               copy_ms=copy, stats=stats)
    out["turns"] = cont_turns(mt, sess, sym_json, params, shapes, rng,
                              card)
    out["swap"] = cont_swap(mt, att, sess, sym, sym_json, params, shapes,
                            seed, card)
    sess.close()
    return out


def lm_load(mt, sess, n, clients, rng):
    """``n`` LM requests from ``clients`` threads, each sending its next
    once answered, the answers dropped; returns the wall seconds."""
    reqs = [rng.integers(0, LM["vocab_size"], (1, LM["seq_len"]))
            .astype(np.float32) for _ in range(n)]
    errors = []

    def client(idx):
        try:
            for r in range(idx, n, clients):
                sess.predict({"data": reqs[r]}, timeout=600)
        except Exception as exc:  # re-raised below
            errors.append(exc)
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return wall


def cont_turns(mt, cont, sym_json, params, shapes, rng, card):
    """Burst against continuous in turns (the burst session adopts the
    continuous one's warm predictor), after two untimed rounds each:
    requests/s, dispatch_idle_gap_ms, refill_latency_ms, batch_exec_ms,
    the host ms of ``rep.dispatch`` against the batch's device ms, and
    the answer copy's ms. Printed, not claimed."""
    b0 = mt.compile.pipeline.program_build_count()
    burst = mt.serving.ServingSession(
        sym_json, params, shapes, buckets=BUCKETS, contexts=[mt.gpu(0)],
        mode="burst", version_tag="lm-a")
    built = mt.compile.pipeline.program_build_count() - b0
    n, clients = CONT["turn_requests"], CONT["turn_clients"]
    sessions = {"burst": burst, "continuous": cont}
    rows = []
    hists = ("dispatch_idle_gap_ms", "refill_latency_ms", "batch_exec_ms")
    try:
        for _ in range(2):
            for sess in sessions.values():
                lm_load(mt, sess, n, clients, rng)
        for mode in CONT["turns"]:
            sess = sessions[mode]
            m = sess.metrics
            before = {h: (m.histogram(h).count,
                          m.histogram(h).mean * m.histogram(h).count)
                      for h in hists}
            rec = ServedBatches(mt)
            try:
                wall = lm_load(mt, sess, n, clients, rng)
            finally:
                rec.close()
            row = {"mode": mode, "requests_per_s": n / wall,
                   "batches": len(rec.rows),
                   "dispatch_host_ms": float(np.mean(rec.dispatch_ms)),
                   "device_ms": float(np.mean([r["device_ms"]
                                               for r in rec.rows])),
                   "copy_ms": float(np.mean([r["copy_ms"]
                                             for r in rec.rows]))}
            for h, (c0, s0) in before.items():
                hh = m.histogram(h)
                c = hh.count - c0
                row[h] = (hh.mean * hh.count - s0) / c if c else None
            rows.append(row)
            log("  [%s] turn %s: %d requests from %d clients, %.3f "
                "requests/s, %d batches; dispatch_idle_gap_ms %s, "
                "refill_latency_ms %s, batch_exec_ms %s; rep.dispatch host "
                "ms %.3f, device ms %.3f, answer copy ms %.3f"
                % (card, mode, n, clients, row["requests_per_s"],
                   row["batches"], _fmt(row["dispatch_idle_gap_ms"]),
                   _fmt(row["refill_latency_ms"]),
                   _fmt(row["batch_exec_ms"]), row["dispatch_host_ms"],
                   row["device_ms"], row["copy_ms"]))
    finally:
        burst.close()
    log("  the burst session adopted the warm predictor: %d program "
        "builds" % built)
    return rows


def _fmt(v):
    return "none" if v is None else "%.3f" % v


def cont_swap(mt, att, sess, sym, sym_json, params_a, shapes, seed, card):
    """23.2: hot-swap to a second seeded weight set while `clients`
    threads send: no failed request, every answer one version's direct
    Predictor's (held by digest), none of the old version among requests
    sent after swap_model returned; then prewarm and a rollback to the
    first tag with zero program builds."""
    params_b = lm_params(sym, seed + 1)
    answers, sent, errors = {}, {}, []
    flipped = {}
    stop = threading.Event()
    rec = ServedBatches(mt)

    def client(idx):
        rng = np.random.default_rng(seed + 24 + idx)
        try:
            for _ in range(CONT["swap_max_requests"]):
                if stop.is_set():
                    break
                x = rng.integers(0, LM["vocab_size"], (1, LM["seq_len"])) \
                    .astype(np.float32)
                t = time.perf_counter()
                fut = sess.predict_async({"data": x})
                sent[id(fut)] = t
                answers[id(fut)] = digest(fut.wait(600)[0])
        except Exception as exc:  # counted as a failed request
            errors.append(exc)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(CONT["clients"])]
        for th in threads:
            th.start()
        time.sleep(CONT["swap_settle_s"])
        info = sess.swap_model(sym_json, params_b, version_tag="lm-b")
        flipped["t"] = time.perf_counter()
        time.sleep(CONT["swap_settle_s"])
        stop.set()
        for th in threads:
            th.join(timeout=600)
    finally:
        stop.set()
        rec.close()
    if errors:
        raise AssertionError("%d requests failed across the swap: %r"
                             % (len(errors), errors[0]))
    checked, worst = direct_identity(
        mt, sym_json, {"lm-a": params_a, "lm-b": params_b}, rec.rows,
        answers)
    by_version = {}
    stale = after = 0
    for row in rec.rows:
        by_version[row["version"]] = by_version.get(row["version"], 0) + 1
        for it in row["items"]:
            if sent[id(it)] > flipped["t"]:
                after += 1
                stale += row["version"] == "lm-a"
    log("  [%s] swap to lm-b under %d clients: %s; %d requests, 0 failed; "
        "batches by version %s; %d batches held to their version's direct "
        "Predictor (answers by sha1): max abs err %g; of the %d requests "
        "sent after swap_model returned, answered by lm-a: %d"
        % (card, CONT["clients"], info, len(answers), by_version, checked,
           worst, after, stale))
    if worst != 0.0 or stale or not after or \
            set(by_version) != {"lm-a", "lm-b"}:
        raise AssertionError("swap: err %g, stale %d of %d, versions %s"
                             % (worst, stale, after, by_version))
    b0 = mt.compile.pipeline.program_build_count()
    warmed = mt.serving.prewarm(sym_json, params_a, shapes, BUCKETS,
                                contexts=[mt.gpu(0)], version_tag="lm-a")
    back = sess.swap_model(sym_json, params_a, version_tag="lm-a")
    builds = mt.compile.pipeline.program_build_count() - b0
    rng = np.random.default_rng(seed + 24)
    x = rng.integers(0, LM["vocab_size"], (1, LM["seq_len"])) \
        .astype(np.float32)
    got = sess.predict({"data": x}, timeout=600)[0]
    ref = mt.Predictor(sym_json, params_a, ctx=mt.gpu(0),
                       input_shapes=shapes)
    ref.forward(data=x)
    same = np.array_equal(got, ref.get_outputs()[0])
    log("  prewarm of lm-a warmed %d (bucket, replica) programs; rollback "
        "%s; program builds across both %d (want 0); the rolled-back "
        "answer equals lm-a's Predictor: %s; warm_cache_adoptions %d"
        % (warmed, back, builds, same,
           sess.metrics.counter("warm_cache_adoptions").value))
    if builds or not same:
        raise AssertionError("rollback built %d programs, same %s"
                             % (builds, same))
    return dict(info=info, batches_by_version=by_version, max_abs_err=worst,
                sent_after_swap=after, stale=stale, rollback_builds=builds,
                prewarmed=warmed)


def cont_resnet(mt, epi, seed, card):
    """23.3: ResNet-50 v2 served continuously: 50 epilogue launches a
    batch, each bit for bit the plain epilogue on its own inputs."""
    from mxtpu_torch.ops import nn as nn_ops
    sym = mt.models.get_resnet(**RESNET)
    params = resnet_params(sym, seed)
    shape = (1,) + RESNET["image_shape"]
    rng = np.random.default_rng(seed + 25)
    n = CONT["resnet_requests"]
    requests = [rng.standard_normal(shape, dtype=np.float32)
                for _ in range(n)]
    sess = mt.serving.ServingSession(
        sym.tojson(), params, {"data": shape}, buckets=RESNET_BUCKETS,
        contexts=[mt.gpu(0)], mode="continuous",
        max_in_flight=CONT["inflight"], version_tag="resnet-a")
    real = nn_ops.bn_apply_relu_add
    worst = []

    def spy(xx, scale, shift, residual=None, block_m=1024, axis=-1,
            out_dtype=None):
        y = real(xx, scale, shift, residual, block_m, axis, out_dtype)
        want = epi.bn_apply_relu_add_reference(xx, scale, shift, residual,
                                               axis, out_dtype)
        worst.append(torch.where(y == want, torch.zeros_like(y),
                                 (y - want).abs().nan_to_num(
                                     float("inf"))).max())
        return y
    answers, errors = [None] * n, []

    def client(idx):
        try:
            for r in range(idx, n, CONT["resnet_clients"]):
                answers[r] = sess.predict({"data": requests[r]},
                                          timeout=600)[0]
        except Exception as exc:  # re-raised below
            errors.append(exc)
    nn_ops.bn_apply_relu_add = spy
    try:
        epi.bn_apply_relu_add.launches = 0  # count the main path alone
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(CONT["resnet_clients"])]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = epi.bn_apply_relu_add.launches
        batches = sess.metrics.counter("batches_dispatched").value
    finally:
        nn_ops.bn_apply_relu_add = real
        sess.close()
    if errors:
        raise errors[0]
    err = float(torch.stack(worst).max()) if worst else float("inf")
    finite = all(a is not None and np.isfinite(a).all() for a in answers)
    log("  [%s] ResNet-50 v2 continuous K=%d at %s: %d requests in %d "
        "batches (%.3f images/s, the plain epilogue computed beside each "
        "site); epilogue launches %d (want %d x %d); each site against "
        "the plain epilogue on its inputs: max abs err %g (want 0); "
        "answers finite %s"
        % (card, CONT["inflight"], RESNET_BUCKETS, n, batches, n / wall,
           launches, RESNET_SITES, batches, err, finite))
    if launches != RESNET_SITES * batches or len(worst) != launches or \
            err != 0.0 or not finite:
        raise AssertionError("ResNet-50 continuous: launches %d, sites "
                             "seen %d, err %g" % (launches, len(worst),
                                                  err))
    return dict(batches=batches, launches=launches, max_abs_err=err)


def http_json(method, url, body=None, headers=None, timeout=120):
    """(status, parsed JSON body) of one request."""
    import urllib.error
    import urllib.request
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=dict({"Content-Type":
                                               "application/json"},
                                              **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def cont_http(mt, seed, card):
    """23.4: the HTTP surface on the card (the mlp fixture): an overload
    past max_queue gets 429s, a deadline 504, a closed session 503;
    /healthz, /v1/version and /debug/state's three serving panels; an
    injected kill at serving.replica.collect quarantines and respawns the
    replica and the session keeps serving."""
    from mxtpu_torch.models.serving_fixtures import get_fixture
    sj, params, shapes = get_fixture("mlp", seed=seed)
    sess = mt.serving.ServingSession(
        sj, params, shapes, buckets=(1, 4), max_delay_ms=1,
        max_queue=CONT["max_queue"], contexts=[mt.gpu(0)],
        version_tag="mlp-http",
        admission=mt.serving.SignalAdmissionPolicy(
            queue_wait_budget_ms=1e9))
    server = mt.serving.ServingHTTPServer(sess, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = server.endpoint
    x = np.random.default_rng(seed).random((1, 784), dtype=np.float32)
    post = lambda body: http_json("POST", base + "/v1/predict", body)
    out = {}
    gate = threading.Event()
    try:
        first = post({"inputs": {"data": x.tolist()}})
        if first[0] != 200:
            raise AssertionError("healthy predict: %s" % (first,))
        # wedge the one worker inside dispatch
        rep = sess.pool.replicas[0]
        real = rep.dispatch
        rep.dispatch = lambda inputs: (gate.wait(30), real(inputs))[1]
        held = [sess.predict_async({"data": x})]
        deadline = time.monotonic() + 10
        while sess.batcher.depth and time.monotonic() < deadline:
            time.sleep(0.005)
        # a request whose deadline passes in the wedged queue: 504
        timed = post({"inputs": {"data": x.tolist()}, "timeout_sec": 0.2})
        # an overload burst past max_queue: 429s
        codes = []
        lock = threading.Lock()

        def burst():
            c = post({"inputs": {"data": x.tolist()}, "timeout_sec": 20})[0]
            with lock:
                codes.append(c)
        ths = [threading.Thread(target=burst)
               for _ in range(CONT["overload"])]
        for th in ths:
            th.start()
        deadline = time.monotonic() + 30
        while len(codes) < CONT["overload"] - CONT["max_queue"] and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        n429 = codes.count(429)
        gate.set()
        for th in ths:
            th.join(timeout=60)
        for h in held:
            h.wait(60)
        rep.dispatch = real
        out["overload"] = {"sent": CONT["overload"],
                           "max_queue": CONT["max_queue"],
                           "429": n429, "200": codes.count(200),
                           "shed_rate": sess.stats()["shed_rate"]}
        out["deadline_status"] = timed[0]
        h = http_json("GET", base + "/healthz")
        v = http_json("GET", base + "/v1/version")
        st = http_json("GET", base + "/debug/state")[1]
        panels = {k: k in st for k in ("serving_admission",
                                       "serving_version",
                                       "serving_warm_cache")}
        # the kill: the worker dies retiring its batch; the replica is
        # quarantined, rebuilt and re-warmed, and the session serves on
        q0 = sess.metrics.counter("replica_quarantined").value
        with mt.faults.scope("serving.replica.collect:kind=kill,times=1"):
            killed = post({"inputs": {"data": x.tolist()}})
        deadline = time.monotonic() + CONT["respawn_s"]
        while time.monotonic() < deadline and (
                sess.healthy_replicas() < 1 or sess.metrics.counter(
                    "replica_respawned", labels={"outcome": "ok"}).value
                < 1):
            time.sleep(0.05)
        after = post({"inputs": {"data": x.tolist()}})
        out["kill"] = {"status": killed[0], "error": killed[1].get("error",
                                                                   "")[:80],
                       "quarantined": sess.metrics.counter(
                           "replica_quarantined").value - q0,
                       "respawned": sess.metrics.counter(
                           "replica_respawned",
                           labels={"outcome": "ok"}).value,
                       "healthy": sess.healthy_replicas(),
                       "after_status": after[0]}
    finally:
        gate.set()
        sess.close()
    closed = post({"inputs": {"data": x.tolist()}})
    server.shutdown()
    out.update(healthz=h, version=v[1], panels=panels,
               closed_status=closed[0])
    log("  [%s] HTTP on the mlp: %d requests past max_queue %d: %d x 429, "
        "%d x 200 (shed_rate %.3f); a 0.2 s deadline in the wedged queue: "
        "%d; /healthz %d %s; /v1/version %s; /debug/state panels %s; a "
        "kill at serving.replica.collect: %s; after close: %d"
        % (card, CONT["overload"], CONT["max_queue"], n429,
           out["overload"]["200"], out["overload"]["shed_rate"],
           timed[0], h[0], h[1], v[1], panels, out["kill"], closed[0]))
    k = out["kill"]
    if n429 < 1 or timed[0] != 504 or h[0] != 200 or not all(
            panels.values()) or closed[0] != 503 or k["status"] != 500 or \
            k["quarantined"] != 1 or k["respawned"] < 1 or \
            k["healthy"] != 1 or k["after_status"] != 200:
        raise AssertionError("HTTP taxonomy / respawn: %s" % out)
    return out


def phase_continuous(mt, att, epi, seed, card):
    """Phase 23: A.11's continuous serving on the card (see CONT)."""
    import tempfile
    t0 = time.perf_counter()
    out = {"lm": cont_lm(mt, att, seed, card)}
    out["resnet"] = cont_resnet(mt, epi, seed, card)
    out["http"] = cont_http(mt, seed, card)
    with tempfile.TemporaryDirectory() as tmp:
        out["bomb_1e39"] = obs_bomb(mt, seed, card,
                                    os.path.join(tmp, "bomb"), lr=1e39)
    mt.serving.warm_cache().evict()
    out["launches"] = {
        "flash_fwd": {"lm_continuous": out["lm"]["launches"]},
        "epilogue": {"resnet_continuous": out["resnet"]["launches"]}}
    out["phase_s"] = time.perf_counter() - t0
    log("  phase 23 took %.1f s" % out["phase_s"])
    return out


# phase 24, decode (A.11): the paged attention decoder at GPT-2-small's
# widths (`vocab`, `embed`, `heads` x `head_dim`, `layers`) on a
# PagedArena of `slots` slots, `blocks_per_seq` blocks of `block` tokens
# a sequence, step buckets `buckets`, prefill chunks of `chunk` tokens;
# `requests` requests with prompts in `prompt` and new tokens in `new`,
# every other one sampled at `temperature`; a `long_prompt`-token prompt
# joining `decoding` generating sequences; the LSTM LM at config 4's
# widths (`lstm`) for `lstm_requests` requests
DECODE = dict(vocab=50257, embed=768, heads=12, head_dim=64, layers=12,
              block=16, blocks_per_seq=64, slots=8, buckets=(1, 4, 8),
              chunk=32, requests=16, prompt=(8, 512), new=(32, 64),
              temperature=0.8, long_prompt=900, long_new=16, decoding=4,
              decoding_new=64, timeout=600,
              lstm=dict(vocab_size=10000, num_embed=200, num_hidden=200,
                        num_layers=2), lstm_requests=8, lstm_new=24)


def decode_requests(seed, n, vocab):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(DECODE["prompt"][0],
                                DECODE["prompt"][1] + 1))
        out.append(dict(prompt=[int(t) for t in
                                rng.integers(0, vocab, plen)],
                        max_new_tokens=int(rng.integers(
                            DECODE["new"][0], DECODE["new"][1] + 1)),
                        seed=i, temperature=DECODE["temperature"]
                        if i % 2 else 0.0))
    return out


def decode_joined(sess, reqs):
    """Every request from its own thread at once (join and leave churn
    between steps); the tokens in request order."""
    res = [None] * len(reqs)
    errors = []

    def run(i):
        try:
            res[i] = sess.generate(timeout=DECODE["timeout"], **reqs[i])
        except Exception as exc:  # re-raised below
            errors.append(exc)
    ths = [threading.Thread(target=run, args=(i,))
           for i in range(len(reqs))]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=DECODE["timeout"])
    if errors:
        raise errors[0]
    if any(r is None for r in res):
        raise AssertionError("a generate waiter hung")
    return [r["tokens"] for r in res]


def decode_alone(sess, reqs):
    return [sess.generate(timeout=DECODE["timeout"], **r)["tokens"]
            for r in reqs]


def decode_leaks(mt, sess, base, label):
    """The arena's free lists full and the ledger's decode_kv at ``base``."""
    a = sess.arena
    live = mt.diagnostics.ledger().live_bytes(origin="decode_kv")
    ok = a.free_slots == a.capacity and a.blocks_free == a.blocks_total \
        and live == base
    if not ok:
        raise AssertionError("%s leaked: free slots %d/%d, free blocks "
                             "%d/%d, decode_kv %d B (base %d)"
                             % (label, a.free_slots, a.capacity,
                                a.blocks_free, a.blocks_total, live, base))
    return ok


def decode_gpt2(mt, seed, card):
    """24.1-24.6 and 24.8 on the GPT-2-small-width paged decoder."""
    from mxtpu_torch.serving.decode import attn_decode_fixture
    from mxtpu_torch.serving.decode import session as dsession
    t0 = time.perf_counter()
    fx = attn_decode_fixture(
        vocab_size=DECODE["vocab"], num_embed=DECODE["embed"],
        num_heads=DECODE["heads"], head_dim=DECODE["head_dim"],
        num_layers=DECODE["layers"], block_size=DECODE["block"],
        max_blocks_per_seq=DECODE["blocks_per_seq"], seed=seed)
    made_s = time.perf_counter() - t0
    led = mt.diagnostics.ledger()
    base = led.live_bytes(origin="decode_kv")
    t0 = time.perf_counter()
    sess = mt.serving.DecodeSession(
        fx["step_symbol_json"], fx["params"], fx["step_example_shapes"], [],
        buckets=DECODE["buckets"], slot_capacity=DECODE["slots"],
        arena="paged", paged=fx, prefill_chunk_tokens=DECODE["chunk"],
        contexts=[mt.gpu(0)], version_tag="gpt2-decode",
        max_queue=64)
    up_s = time.perf_counter() - t0
    a = sess.arena
    out = {}
    # 24.1: the arena's bytes; the ledger's at every block live
    want = (DECODE["slots"] * DECODE["blocks_per_seq"] * DECODE["block"]
            * DECODE["heads"] * DECODE["head_dim"] * 4 * 2
            * DECODE["layers"])
    slots = [a.allocate() for _ in range(DECODE["slots"])]
    for s in slots:
        a.ensure_tokens(s, DECODE["block"] * DECODE["blocks_per_seq"])
    full = led.live_bytes(origin="decode_kv") - base
    for s in slots:
        a.release(s)
    log("  [%s] paged decoder %s (weights made in %.1f s, session up in "
        "%.1f s); arena %d B (want %d = %d slots x %d blocks x %d tokens "
        "x %d heads x %d x 4 B x K,V x %d layers); ledger decode_kv with "
        "every block live: %d B; after release: %d B over base"
        % (card, {k: DECODE[k] for k in ("vocab", "embed", "heads",
                                          "head_dim", "layers")},
           made_s, up_s, a.state_bytes(), want, DECODE["slots"],
           DECODE["blocks_per_seq"], DECODE["block"], DECODE["heads"],
           DECODE["head_dim"], DECODE["layers"], full,
           led.live_bytes(origin="decode_kv") - base))
    if a.state_bytes() != want or full != want:
        raise AssertionError("decode arena bytes %d, ledger %d, want %d"
                             % (a.state_bytes(), full, want))
    decode_leaks(mt, sess, base, "the ledger check")
    out["arena_bytes"] = want
    # 24.2 (and 24.8): joined equals alone, timed by step bucket
    step_ms = {}
    real_step = dsession.DecodeSession._step_chunk_kv

    def timed_step(self, pool, seqs):
        t = time.perf_counter()
        real_step(self, pool, seqs)
        b = mt.serving.pick_bucket(len(seqs), self.buckets)
        step_ms.setdefault(b, []).append((time.perf_counter() - t) * 1e3)
    reqs = decode_requests(seed + 30, DECODE["requests"], DECODE["vocab"])
    dsession.DecodeSession._step_chunk_kv = timed_step
    try:
        tok0 = sess.metrics.counter("decode_tokens_total").value
        t0 = time.perf_counter()
        joined = decode_joined(sess, reqs)
        wall = time.perf_counter() - t0
        tokens = sess.metrics.counter("decode_tokens_total").value - tok0
        joined_steps = {b: list(v) for b, v in step_ms.items()}
        alone = decode_alone(sess, reqs)
    finally:
        dsession.DecodeSession._step_chunk_kv = real_step
    pre = sess.metrics.histogram("decode_prefill_chunk_ms")
    same = joined == alone
    log("  [%s] %d requests (prompts %d-%d tokens, %d-%d new, greedy and "
        "T=%g): joined %d tokens in %.2f s (%.1f tokens/s); step ms by "
        "bucket %s (joined run); prefill chunk ms mean %.3f over %d "
        "chunks; joined equals alone token for token: %s"
        % (card, len(reqs), min(len(r["prompt"]) for r in reqs),
           max(len(r["prompt"]) for r in reqs),
           min(r["max_new_tokens"] for r in reqs),
           max(r["max_new_tokens"] for r in reqs), DECODE["temperature"],
           tokens, wall, tokens / wall,
           {b: round(float(np.mean(v)), 3) for b, v in
            sorted(joined_steps.items())}, pre.mean, pre.count, same))
    if not same:
        diff = [i for i, (x, y) in enumerate(zip(joined, alone)) if x != y]
        raise AssertionError("joined != alone for requests %s" % diff)
    if sess.metrics.counter("decode_prefill_stalls").value:
        raise AssertionError("chunked prefill stalled decode")
    decode_leaks(mt, sess, base, "the joined run")
    out.update(tokens_per_s=tokens / wall, tokens=tokens,
               step_ms_by_bucket={b: float(np.mean(v))
                                  for b, v in joined_steps.items()},
               prefill_chunk_ms=pre.mean, joined_equals_alone=same)
    # 24.3: NaN in every freed block; no live lane sees it
    with torch.no_grad():
        for t in a._arrays:
            t.fill_(float("nan"))
    poisoned = decode_joined(sess, reqs[:4])
    log("  [%s] every block NaN-poisoned while free: the first 4 requests "
        "again, tokens equal the clean run: %s"
        % (card, poisoned == joined[:4]))
    if poisoned != joined[:4]:
        raise AssertionError("NaN in freed blocks reached a live lane")
    # 24.4: a long prompt joins while sequences decode
    stalls0 = sess.metrics.counter("decode_prefill_stalls").value
    idle0 = sess.metrics.counter(
        "decode_steps_with_admittable_waiting").value
    rng = np.random.default_rng(seed + 31)
    stamps = []
    items = [sess.generate_async([int(t) for t in rng.integers(
        0, DECODE["vocab"], 8)], max_new_tokens=DECODE["decoding_new"],
        timeout=DECODE["timeout"], stream=True)
        for _ in range(DECODE["decoding"])]

    def drain(item, acc):
        for ev in item.stream.events(timeout=DECODE["timeout"]):
            if "token" in ev:
                acc.append(time.perf_counter())
    readers = []
    for it in items:
        acc = []
        stamps.append(acc)
        th = threading.Thread(target=drain, args=(it, acc))
        th.start()
        readers.append(th)
    deadline = time.monotonic() + 60
    while min(len(s) for s in stamps) < 2 and time.monotonic() < deadline:
        time.sleep(0.002)
    t_join = time.perf_counter()
    chunks0 = sess.metrics.counter("decode_prefill_chunks").value
    long_item = sess.generate_async(
        [int(t) for t in rng.integers(0, DECODE["vocab"],
                                      DECODE["long_prompt"])],
        max_new_tokens=DECODE["long_new"], timeout=DECODE["timeout"],
        stream=True)
    long_first = []
    lth = threading.Thread(target=drain, args=(long_item, long_first))
    lth.start()
    for th in readers + [lth]:
        th.join(timeout=DECODE["timeout"])
    for it in items + [long_item]:
        it.wait(DECODE["timeout"])
    during = [t for s in stamps for t in s]
    gaps = [b - a_ for s in stamps for a_, b in zip(s, s[1:])
            if b > t_join and (not long_first or a_ < long_first[0])]
    stalls = sess.metrics.counter("decode_prefill_stalls").value - stalls0
    idle = sess.metrics.counter(
        "decode_steps_with_admittable_waiting").value - idle0
    chunks = sess.metrics.counter("decode_prefill_chunks").value - chunks0
    out["long_prompt"] = dict(
        max_gap_ms=max(gaps) * 1e3 if gaps else None,
        chunks=chunks, stalls=stalls,
        ttft_ms=(long_first[0] - t_join) * 1e3 if long_first else None)
    log("  [%s] a %d-token prompt joined %d decoding sequences: %d prefill "
        "chunks, prefill stalls %d (want 0), steps with admittable work "
        "waiting %d (want 0); longest gap between a decoding sequence's "
        "tokens while it prefilled %.2f ms over %d gaps; its first token "
        "%.1f ms after it joined; tokens streamed %d"
        % (card, DECODE["long_prompt"], DECODE["decoding"], chunks, stalls,
           idle, out["long_prompt"]["max_gap_ms"] or 0.0, len(gaps),
           out["long_prompt"]["ttft_ms"] or 0.0, len(during)))
    if stalls or idle or not gaps:
        raise AssertionError("long prompt: stalls %d, idle steps %d, gaps "
                             "%d" % (stalls, idle, len(gaps)))
    decode_leaks(mt, sess, base, "the long prompt")
    # 24.5: POST /v1/generate?stream=1
    server = mt.serving.ServingHTTPServer(None, port=0, decode=sess)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        body = {"prompt": reqs[1]["prompt"][:64], "max_new_tokens": 24,
                "seed": 5, "temperature": 0.8}
        import urllib.request
        req = urllib.request.Request(
            server.endpoint + "/v1/generate?stream=1",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            ctype = r.headers.get("Content-Type")
            events = [json.loads(line) for line in
                      r.read().decode().splitlines() if line.strip()]
        plain = http_json("POST", server.endpoint + "/v1/generate", body)
    finally:
        stop_socket(server)
    streamed = [e["token"] for e in events if "token" in e]
    done = events[-1].get("done", {})
    log("  [%s] POST /v1/generate?stream=1 (%s): %d events, the streamed "
        "tokens equal the terminal result: %s; the same body without "
        "stream: %d, tokens equal: %s"
        % (card, ctype, len(events), streamed == done.get("tokens"),
           plain[0], plain[1].get("tokens") == streamed))
    if streamed != done.get("tokens") or plain[0] != 200 or \
            plain[1].get("tokens") != streamed or len(streamed) != 24:
        raise AssertionError("stream events %s, result %s" % (events[-1],
                                                              plain))
    # 24.6: each serving.decode.* point once through MXTPU_FAULTS
    faults = {}
    for point in ("step", "prefill", "block_alloc", "evict"):
        os.environ["MXTPU_FAULTS"] = "serving.decode.%s:kind=raise," \
            "times=1" % point
        mt.faults.configure()
        try:
            futs = [sess.generate_async(r["prompt"][:40], max_new_tokens=8,
                                        timeout=DECODE["timeout"])
                    for r in reqs[:2]]
            got = []
            for f in futs:
                try:
                    f.wait(DECODE["timeout"])
                    got.append("ok")
                except mt.faults.FaultInjected:
                    got.append("fault")
        finally:
            del os.environ["MXTPU_FAULTS"]
            mt.faults.configure(False)
        decode_leaks(mt, sess, base, "fault at serving.decode.%s" % point)
        faults[point] = got
    log("  [%s] one fault at each serving.decode.* point through "
        "MXTPU_FAULTS: %s; free slots %d/%d, free blocks %d/%d, "
        "decode_kv back at its start after each"
        % (card, faults, a.free_slots, a.capacity, a.blocks_free,
           a.blocks_total))
    if any("fault" not in v for v in faults.values()):
        raise AssertionError("a fault point did not fire: %s" % faults)
    out["faults"] = faults
    sess.close()
    return out


def stop_socket(server):
    """Stop a ServingHTTPServer's socket without closing its sessions
    (its own ``shutdown`` drains them)."""
    from http.server import ThreadingHTTPServer
    ThreadingHTTPServer.shutdown(server)
    server.server_close()


def decode_lstm(mt, seed, card):
    """24.7: the LSTM LM's step at config 4's widths on a
    SequenceSlotArena: joined equals alone."""
    from mxtpu_torch.serving.decode import lm_decode_fixture
    sj, params, shapes, names, _ = lm_decode_fixture(seed=seed,
                                                     **DECODE["lstm"])
    base = mt.diagnostics.ledger().live_bytes(origin="decode_state")
    sess = mt.serving.DecodeSession(
        sj, params, shapes, names, buckets=DECODE["buckets"],
        slot_capacity=DECODE["slots"], contexts=[mt.gpu(0)],
        version_tag="lstm-decode")
    rng = np.random.default_rng(seed + 32)
    reqs = [dict(prompt=[int(t) for t in rng.integers(
        0, DECODE["lstm"]["vocab_size"], int(rng.integers(2, 20)))],
        max_new_tokens=DECODE["lstm_new"], seed=i,
        temperature=DECODE["temperature"] if i % 2 else 0.0)
        for i in range(DECODE["lstm_requests"])]
    try:
        live = mt.diagnostics.ledger().live_bytes(origin="decode_state") \
            - base
        t0 = time.perf_counter()
        joined = decode_joined(sess, reqs)
        wall = time.perf_counter() - t0
        alone = decode_alone(sess, reqs)
        steps = sess.metrics.histogram("decode_step_ms")
        state = sess.arena.state_bytes()
    finally:
        sess.close()
    after = mt.diagnostics.ledger().live_bytes(origin="decode_state")
    log("  [%s] LSTM LM step %s on %d slots (%d B of state; ledger "
        "decode_state %d B while it served, %d B over its start after "
        "close): %d requests joined in %.2f s, step ms mean %.3f; joined "
        "equals alone: %s"
        % (card, DECODE["lstm"], DECODE["slots"], state, live, after - base,
           len(reqs), wall, steps.mean, joined == alone))
    if joined != alone or live != state or after != base:
        raise AssertionError("LSTM decode: joined == alone %s, ledger %d "
                             "of %d, %d after close" % (
                                 joined == alone, live, state,
                                 after - base))
    return dict(joined_equals_alone=True, step_ms=steps.mean,
                state_bytes=state)


def phase_decode(mt, seed, card):
    """Phase 24: A.11's decode session on the card (see DECODE)."""
    t0 = time.perf_counter()
    out = {"gpt2": decode_gpt2(mt, seed, card)}
    out["lstm"] = decode_lstm(mt, seed, card)
    mt.serving.warm_cache().evict()
    out["phase_s"] = time.perf_counter() - t0
    log("  phase 24 took %.1f s" % out["phase_s"])
    return out


# ------------------------------------------------------------ phase 25
class FlatLabels:
    """An ``NDArrayIter`` over (N, T) labels handing each batch's labels
    on flattened to (B*T,), as the LM's SoftmaxOutput takes them; at most
    ``limit`` batches an epoch. Its cursor is the inner iterator's, so an
    elastic snapshot records and restores it."""

    def __init__(self, mt, inner, limit=None):
        self._mt, self.inner, self.limit = mt, inner, limit
        b, t = inner.provide_label[0].shape
        self.provide_data = inner.provide_data
        self.provide_label = [mt.io.DataDesc("softmax_label", (b * t,))]
        self._n = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.limit is not None and self._n >= self.limit:
            raise StopIteration
        batch = next(self.inner)
        self._n += 1
        return self._mt.io.DataBatch(
            data=batch.data, label=[batch.label[0].reshape((-1,))],
            pad=batch.pad)

    def reset(self):
        self.inner.reset()
        self._n = 0

    def checkpoint_state(self):
        return self.inner.checkpoint_state()

    def restore_state(self, state):
        return self.inner.restore_state(state)


def elastic_lm_data(seed, n, seq_len, vocab):
    """``n`` seeded token rows (n, T) and their next tokens (n, T)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (n, seq_len + 1))
    return ids[:, :-1].astype(np.float32), ids[:, 1:].astype(np.float32)


def rel_l2(a, b):
    """||a - b|| / ||b|| over every array of two weight dicts (f64)."""
    num = sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2))
              for k in b)
    den = sum(float(np.sum(b[k].astype(np.float64) ** 2)) for k in b)
    return (num / den) ** 0.5


def same_bits(a, b):
    return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                          for k in b)


def host_weights(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def fused_live(mod):
    """{generation key: numpy} of a fused module's live state: params,
    aux, the first replica's optimizer leaves."""
    from mxtpu_torch.module.fused import state_leaves
    arg, aux = mod.get_params()
    out = {"arg:%s" % k: v.asnumpy() for k, v in arg.items()}
    out.update({"aux:%s" % k: v.asnumpy() for k, v in aux.items()})
    for n, st in mod._fused.opt_state[0].items():
        for i, leaf in enumerate(state_leaves(st)):
            out["opt:%s/%d" % (n, i)] = leaf.cpu().numpy()
    return out


def generation_gate(mt, prefix, live, opt, label):
    """The newest generation at ``prefix`` holds ``live`` (and the
    optimizer's counters) bit for bit; returns its cursor."""
    snap = mt.elastic.snapshot
    man = snap.latest_manifest(prefix)
    got = snap.load_arrays(man)
    differ = [k for k in live if not np.array_equal(got.get(k), live[k])]
    counters = man["optimizer"]["num_update"] == opt.num_update and \
        {int(k): v for k, v in man["optimizer"]["index_update_count"]
         .items()} == dict(opt._index_update_count)
    dtypes = sorted({str(got[k].dtype) for k in live})
    log("  %s: generation %d (cursor %s) holds %d live arrays (%s), %d "
        "not bit for bit; optimizer counters equal: %s"
        % (label, man["_generation"], man["cursor"], len(live), dtypes,
           len(differ), counters))
    if differ or not counters:
        raise AssertionError("%s: the generation differs from the live "
                             "state at %s (counters %s)"
                             % (label, differ[:5], counters))
    return man["cursor"], dtypes


def elastic_lm_fit(mt, att, sym, params, x, y, seed, kill_at=None,
                   limit=None, **kw):
    """One LM fit on gpu(0) from ``params``: (module, flash forwards,
    flash backwards, attention dtypes, host ms of each step with the
    compute stream drained). ``kill_at`` raises from the batch callback
    after that step."""
    b = TRAIN["batch"]
    mod = mt.mod.Module(sym, context=mt.gpu(0), logger=_quiet_logger())
    np.random.seed(seed)
    mt.random.seed(seed)
    it = FlatLabels(mt, mt.io.NDArrayIter(
        x, y, batch_size=b, shuffle=True, label_name="softmax_label"),
        limit)
    dtypes, stamps = set(), []
    real_fwd = att._flash_forward

    def fwd(q, k, v, causal, scale, want_lse=False):
        if q.device.type != "meta":
            dtypes.add(str(q.dtype).replace("torch.", ""))
        return real_fwd(q, k, v, causal, scale, want_lse)

    def record(param):
        torch.cuda.current_stream().synchronize()
        stamps.append(time.perf_counter())
        if kill_at is not None and len(stamps) >= kill_at:
            raise mt.MXNetError("killed at step %d" % len(stamps))

    att._flash_forward = fwd
    att.flash_attention.launches = 0  # count the main path alone
    att.flash_attention_backward.launches = 0
    t0 = time.perf_counter()
    try:
        mod.fit(it, num_epoch=1, eval_metric="ce", optimizer="adam",
                optimizer_params={"learning_rate": TRAIN["lr"]},
                arg_params=params, initializer=None,
                batch_end_callback=record, **kw)
    except mt.MXNetError as exc:
        if kill_at is None or "killed at step" not in str(exc):
            raise
    finally:
        att._flash_forward = real_fwd
    ms = [float(v) for v in np.diff([t0] + stamps) * 1e3]
    return (mod, att.flash_attention.launches,
            att.flash_attention_backward.launches, dtypes, ms)


def elastic_lm(mt, att, seed, card, tmp):
    """25.1: the LM's repeat distance, kill and resume, in f32 and bf16."""
    cfg, el = dict(LM), ELASTIC
    sym = mt.models.get_transformer_lm(**cfg)
    n = el["lm_batches"] * TRAIN["batch"]
    x, y = elastic_lm_data(seed + 25, n, cfg["seq_len"], cfg["vocab_size"])
    params = {k[4:]: mt.nd.array(v, ctx=mt.cpu())
              for k, v in lm_params(sym, seed).items()}
    want = (el["lm_steps"] - el["kill_at"]) * cfg["num_layers"]
    out, launches = {}, {"fwd": {}, "bwd": {}}
    for name, pipe in (("f32", ()), ("bf16", ("bf16",))):
        wdt = {"f32": "float32", "bf16": "bfloat16"}[name]
        runs = []
        with mt.compile.pipeline_scope(pipe):
            for _ in range(2):
                mod, f, bk, dts, _ms = elastic_lm_fit(mt, att, sym, params,
                                                      x, y, seed)
                runs.append(host_weights(mod))
                launches["fwd"]["lm_elastic_%s_whole" % name] = \
                    launches["fwd"].get("lm_elastic_%s_whole" % name, 0) + f
                launches["bwd"]["lm_elastic_%s_whole" % name] = \
                    launches["bwd"].get("lm_elastic_%s_whole" % name, 0) + bk
                del mod
                torch.cuda.empty_cache()
            same = same_bits(runs[0], runs[1])
            dist = rel_l2(runs[1], runs[0])
            log("  [%s] LM %s: two uninterrupted fits of %d steps: "
                "bit-identical %s, relative L2 distance %.3e"
                % (card, name, el["lm_steps"], same, dist))
            prefix = os.path.join(tmp, "lm_%s" % name, "ck")
            os.makedirs(os.path.dirname(prefix))
            ecfg = mt.elastic.ElasticConfig(prefix, every_n_steps=el["every"],
                                            keep=el["keep"], sync=True)
            mod, f, bk, _d, _ms = elastic_lm_fit(
                mt, att, sym, params, x, y, seed, kill_at=el["kill_at"],
                elastic=ecfg)
            launches["fwd"]["lm_elastic_%s_killed" % name] = f
            launches["bwd"]["lm_elastic_%s_killed" % name] = bk
            cursor, dtypes = generation_gate(
                mt, prefix, fused_live(mod), mod._optimizer,
                "LM %s killed at step %d" % (name, el["kill_at"]))
            if cursor["global_step"] != el["kill_at"] or \
                    dtypes != ["float32"]:
                raise AssertionError("LM %s: generation at %s in %s"
                                     % (name, cursor, dtypes))
            del mod
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            mod, f, bk, dts, _ms = elastic_lm_fit(
                mt, att, sym, params, x, y, seed, resume=prefix,
                elastic=False)
            resume_s = time.perf_counter() - t0
            got = host_weights(mod)
            del mod
            torch.cuda.empty_cache()
        launches["fwd"]["lm_elastic_%s_resumed" % name] = f
        launches["bwd"]["lm_elastic_%s_resumed" % name] = bk
        rd = rel_l2(got, runs[0])
        exact = same_bits(got, runs[0])
        gate = "bit for bit" if same else "within %gx the repeat " \
            "distance" % el["resume_factor"]
        log("  [%s] LM %s resumed from step %d in %.1f s: flash launches "
            "forward %d, backward %d (want %d each), attention dtypes %s; "
            "against the uninterrupted fit bit for bit %s, relative L2 "
            "%.3e; gate: %s" % (card, name, el["kill_at"], resume_s, f, bk,
                                want, sorted(dts), exact, rd, gate))
        if f != want or bk != want or dts != {wdt}:
            raise AssertionError("LM %s resumed: launches %d / %d, dtypes "
                                 "%s" % (name, f, bk, dts))
        if (same and not exact) or rd > el["resume_factor"] * dist:
            raise AssertionError("LM %s resumed: %.3e from the "
                                 "uninterrupted fit (repeat %.3e, "
                                 "bit-identical %s)" % (name, rd, dist,
                                                        same))
        shutil.rmtree(os.path.dirname(prefix), ignore_errors=True)
        out[name] = dict(repeat_bit_identical=same, repeat_rel_l2=dist,
                         resumed_bit_identical=exact, resumed_rel_l2=rd,
                         gate=gate, resume_s=resume_s, resumed_fwd=f,
                         resumed_bwd=bk)
    out["launches"] = launches
    out["inputs"] = (sym, params, x, y)
    return out


def elastic_turns(mt, att, seed, card, tmp, inputs):
    """25.2: elastic off and on (every step, async) in turns."""
    el = ELASTIC
    sym, params, x, y = inputs
    reg = mt.telemetry.registry()
    snap = mt.elastic.snapshot
    writer = snap.writer()
    real_capture = snap.capture_module
    syncs, capture_ms, stall_ms = [], [], []

    def counted(*a, **k):
        """capture_module under torch's sync debug mode: each
        synchronizing operation it reaches warns once, and is counted."""
        import warnings
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                return real_capture(*a, **k)
            finally:
                capture_ms.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.set_sync_debug_mode(0)
                syncs.append(sum("called a synchronizing" in
                                 str(w.message) for w in seen))

    def stats():
        h = reg.histogram("elastic_snapshot_stall_ms")
        w = reg.histogram("elastic_snapshot_write_ms")
        return dict(stall_n=h.count, stall_sum=h.sum, write_n=w.count,
                    write_sum=w.sum,
                    bytes=reg.counter("elastic_snapshot_bytes").value,
                    written=writer.jobs_written,
                    coalesced=writer.jobs_coalesced)

    prefix = os.path.join(tmp, "turns", "ck")
    os.makedirs(os.path.dirname(prefix))
    rows, steps = {"off": [], "on": []}, {"off": [], "on": []}
    fwd = bwd = 0
    clone_bytes, drift = 0, []
    s0 = stats()
    snap.capture_module = counted
    try:
        for _ in range(el["rounds"]):
            for mode in ("off", "on"):
                ecfg = mt.elastic.ElasticConfig(
                    prefix, every_n_steps=1, keep=el["keep"],
                    sync=False) if mode == "on" else False
                mod, f, bk, _d, ms = elastic_lm_fit(
                    mt, att, sym, params, x, y, seed,
                    limit=el["turn_steps"], elastic=ecfg)
                fwd, bwd = fwd + f, bwd + bk
                rows[mode].append(float(np.mean(ms[1:])))
                steps[mode].append([round(v, 1) for v in ms])
                if mode == "on":
                    snap_bufs = mod._fused._snap or {"flats": ()}
                    clone_bytes = sum(t.numel() * t.element_size()
                                      for t in snap_bufs["flats"])
                    drift.append(mt.diagnostics.ledger().reconcile()
                                 ["drift_bytes"])
                    copy_ms = host_copy_ms(mod._fused)
                del mod
                torch.cuda.empty_cache()
    finally:
        snap.capture_module = real_capture
    s1 = stats()
    d = {k: s1[k] - s0[k] for k in s0}
    stall = d["stall_sum"] / max(1, d["stall_n"])
    cap = np.array(capture_ms)
    write_ms = d["write_sum"] / max(1, d["write_n"])
    per_gen = d["bytes"] / max(1, d["write_n"])
    mbps = d["bytes"] / 1e6 / max(1e-9, d["write_sum"] / 1e3)
    log("  [%s] LM step ms, elastic off %s, on (every step, async) %s "
        "(means of steps 2-%d of each turn); each step: off %s, on %s"
        % (card, [round(v, 2) for v in rows["off"]],
           [round(v, 2) for v in rows["on"]], el["turn_steps"],
           steps["off"], steps["on"]))
    log("  [%s] capture: %d captures, %.2f ms of the training thread each "
        "(elastic_snapshot_stall_ms: the cadence metric sync, which waits "
        "for the step, and the capture); the capture alone (clones, the "
        "copy to pinned memory enqueued, the manifest) median %.2f ms, "
        "mean %.2f, max %.2f; host syncs in the capture %s; the clones "
        "hold %.3f GB on the card; one generation's clone and copy to "
        "pinned memory, waited for: %.1f ms (%.1f GB/s); writer: %d "
        "generations written (%d coalesced), %.1f ms and %.3f GB each, "
        "%.1f MB/s; the ledger's drift from the allocator after each "
        "on-turn %s B"
        % (card, d["stall_n"], stall, np.median(cap), cap.mean(),
           cap.max(), syncs, clone_bytes / 1e9, copy_ms,
           clone_bytes / 1e6 / copy_ms, d["written"], d["coalesced"],
           write_ms, per_gen / 1e9, mbps, drift))
    if not syncs or any(syncs) or not clone_bytes:
        raise AssertionError("the capture made host syncs: %s (clones "
                             "%d B on the card)" % (syncs, clone_bytes))
    return dict(step_ms_off=rows["off"], step_ms_on=rows["on"],
                steps_ms=steps,
                captures=d["stall_n"], stall_ms=stall,
                capture_ms_median=float(np.median(cap)),
                capture_ms_mean=float(cap.mean()), copy_ms=copy_ms,
                syncs=sum(syncs),
                clone_bytes=clone_bytes, written=d["written"],
                coalesced=d["coalesced"], write_ms=write_ms,
                bytes_per_generation=per_gen, mb_per_s=mbps,
                ledger_drift_bytes=drift, fwd=fwd, bwd=bwd)


def host_copy_ms(fused):
    """Host-clock ms of one ``export_host_state`` waited for to its end
    (the clones and the copy to pinned memory), after the card is
    idle."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _p, _a, _o, ready = fused.export_host_state()
    for ev in ready:
        ev.synchronize()
    return (time.perf_counter() - t0) * 1e3


def elastic_resnet_fit(mt, sym, params, x, y, xe, ye, seed, spy,
                       module=None, **kw):
    """ResNet-50 v2 through fit on gpu(0) (``module``, or a new one) from
    ``params``, SGD, with an evaluation at each epoch end and ``spy`` in
    place of the epilogue's wrapper."""
    from mxtpu_torch.ops import nn as nn_ops
    el = ELASTIC
    b = el["resnet_batch"]
    mod = module or mt.mod.Module(sym, context=mt.gpu(0),
                                  logger=_quiet_logger())
    np.random.seed(seed)
    mt.random.seed(seed)
    real = nn_ops.bn_apply_relu_add
    nn_ops.bn_apply_relu_add = spy
    try:
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=b),
                eval_data=mt.io.NDArrayIter(xe, ye, batch_size=b),
                num_epoch=el["resnet_epochs"], eval_metric=["acc", "ce"],
                optimizer="sgd",
                optimizer_params={"learning_rate": el["resnet_lr"],
                                  "momentum": el["resnet_momentum"],
                                  "rescale_grad": 1.0 / b},
                arg_params=params[0], aux_params=params[1],
                initializer=None, **kw)
    finally:
        nn_ops.bn_apply_relu_add = real
    return mod


def elastic_resnet(mt, epi, seed, card, tmp):
    """25.3: ResNet-50 v2 preempted by SIGTERM inside Supervisor.run."""
    import signal
    el = ELASTIC
    sym = mt.models.get_resnet(**RESNET)
    raw = resnet_params(sym, seed)
    params = tuple({k[4:]: mt.nd.array(v, ctx=mt.cpu())
                    for k, v in raw.items() if k.startswith(kind)}
                   for kind in ("arg:", "aux:"))
    rng = np.random.RandomState(seed + 25)
    n, ne = el["resnet_images"], el["resnet_eval"]
    x = rng.rand(n, *RESNET["image_shape"]).astype(np.float32)
    y = rng.randint(0, RESNET["num_classes"], n).astype(np.float32)
    xe = rng.rand(ne, *RESNET["image_shape"]).astype(np.float32)
    ye = rng.randint(0, RESNET["num_classes"], ne).astype(np.float32)
    from mxtpu_torch.ops import nn as nn_ops
    real = nn_ops.bn_apply_relu_add
    worst = []

    def spy(xx, scale, shift, residual=None, block_m=1024, axis=-1,
            out_dtype=None):
        got = real(xx, scale, shift, residual, block_m, axis, out_dtype)
        want = epi.bn_apply_relu_add_reference(xx, scale, shift, residual,
                                               axis, out_dtype)
        worst.append(torch.where(got == want, torch.zeros_like(got),
                                 (got - want).abs().nan_to_num(
                                     float("inf"))).max())
        return got

    runs = []
    epi.bn_apply_relu_add.launches = 0  # count the main path alone
    for _ in range(2):
        mod = elastic_resnet_fit(mt, sym, params, x, y, xe, ye, seed,
                                 spy)
        runs.append(host_weights(mod))
        del mod
        torch.cuda.empty_cache()
    same = same_bits(runs[0], runs[1])
    dist = rel_l2(runs[1], runs[0])
    log("  [%s] ResNet-50 v2, B=%d, %d epochs: two uninterrupted fits "
        "bit-identical %s, relative L2 distance %.3e"
        % (card, el["resnet_batch"], el["resnet_epochs"], same, dist))
    prefix = os.path.join(tmp, "resnet", "ck")
    ckpt = os.path.join(tmp, "resnet", "epoch")
    os.makedirs(os.path.dirname(prefix))
    sup = mt.elastic.Supervisor(retries=0)
    ecfg = mt.elastic.ElasticConfig(prefix, supervisor=sup, keep=el["keep"])
    before = signal.getsignal(signal.SIGTERM)
    held = {}

    def fit_fn(resume):
        def cb(param):
            if param.nbatch == el["sigterm_after"] - 1 and param.epoch == 0:
                os.kill(os.getpid(), signal.SIGTERM)
        mod = mt.mod.Module(sym, context=mt.gpu(0), logger=_quiet_logger())
        held["mod"] = mod
        return elastic_resnet_fit(
            mt, sym, params, x, y, xe, ye, seed, spy, module=mod,
            batch_end_callback=cb, elastic=ecfg, resume=resume,
            epoch_end_callback=mt.callback.module_checkpoint(
                mod, ckpt, save_optimizer_states=True))

    preempted = False
    try:
        sup.run(fit_fn)
    except mt.elastic.Preempted as exc:
        preempted = str(exc)
    after = signal.getsignal(signal.SIGTERM)
    log("  [%s] SIGTERM from step %d's callback inside Supervisor.run: "
        "Preempted %r; the handler after run is the one before: %s"
        % (card, el["sigterm_after"], preempted, after is before))
    if not preempted or after is not before:
        raise AssertionError("ResNet-50: preempted %r, handler restored %s"
                             % (preempted, after is before))
    mod = held.pop("mod")
    cursor, _dt = generation_gate(mt, prefix, fused_live(mod),
                                  mod._optimizer, "ResNet-50 preempted")
    if cursor["global_step"] != el["sigterm_after"] + 1:
        raise AssertionError("ResNet-50: final generation at %s" % cursor)
    del mod
    torch.cuda.empty_cache()
    mod = mt.mod.Module(sym, context=mt.gpu(0), logger=_quiet_logger())
    mod = elastic_resnet_fit(
        mt, sym, params, x, y, xe, ye, seed, spy, module=mod,
        elastic=mt.elastic.ElasticConfig(prefix, keep=el["keep"]),
        resume=True, epoch_end_callback=mt.callback.module_checkpoint(
            mod, ckpt, save_optimizer_states=True))
    got = host_weights(mod)
    torch.cuda.synchronize()
    launches = epi.bn_apply_relu_add.launches
    _sym, ck_args, _aux = mt.model.load_checkpoint(ckpt,
                                                  el["resnet_epochs"])
    ck_same = same_bits({k: v.asnumpy() for k, v in ck_args.items()}, got)
    del mod
    torch.cuda.empty_cache()
    rd = rel_l2(got, runs[0])
    exact = same_bits(got, runs[0])
    err = float(torch.stack(worst).max()) if worst else float("inf")
    evals = 2 * el["resnet_epochs"] + el["resnet_epochs"]
    batches = evals * (el["resnet_eval"] // el["resnet_batch"])
    log("  [%s] ResNet-50 resumed to the end: against the uninterrupted "
        "fit bit for bit %s, relative L2 %.3e (gate %gx %.3e); the last "
        "module_checkpoint bit for bit the live weights %s; epilogue "
        "launches %d in %d evaluation batches (want %d a batch), each "
        "against the plain epilogue on its inputs: max abs err %g"
        % (card, exact, rd, el["resume_factor"], dist, ck_same, launches,
           batches, RESNET_SITES, err))
    if rd > el["resume_factor"] * dist or (same and not exact) or \
            not ck_same:
        raise AssertionError("ResNet-50 resumed: %.3e from the "
                             "uninterrupted fit (repeat %.3e); checkpoint "
                             "%s" % (rd, dist, ck_same))
    if launches != RESNET_SITES * batches or len(worst) != launches or \
            err != 0.0:
        raise AssertionError("ResNet-50 evaluation: launches %d, sites "
                             "seen %d, err %g" % (launches, len(worst), err))
    return dict(repeat_bit_identical=same, repeat_rel_l2=dist,
                resumed_bit_identical=exact, resumed_rel_l2=rd,
                eval_batches=batches, launches=launches, max_abs_err=err)


def elastic_wedge(mt, seed, card, tmp):
    """25.4: the mlp wedged once at executor.device_wait; the supervisor
    restores and retries."""
    el = ELASTIC
    diag, reg = mt.diagnostics, mt.telemetry.registry()
    rng = np.random.RandomState(seed + 25)
    b = el["mlp_batch"]
    x = rng.rand(b * el["mlp_steps"], 784).astype(np.float32)
    y = rng.randint(0, 10, b * el["mlp_steps"]).astype(np.float32)
    sym = mt.models.get_mlp(10)
    init = obs_init(mt, sym, seed, (b, 784))

    def fit(**kw):
        mod = mt.mod.Module(sym, context=mt.gpu(0), logger=_quiet_logger())
        mod.fit(mt.io.NDArrayIter(x, y, b), num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": el["mlp_lr"]},
                arg_params=init[0], aux_params=init[1], initializer=None,
                max_in_flight=1, **kw)
        torch.cuda.synchronize()
        return mod

    bare = host_weights(fit())
    prefix = os.path.join(tmp, "wedge", "ck")
    os.makedirs(os.path.dirname(prefix))
    sup = mt.elastic.Supervisor(retries=1, backoff_s=0.05)
    ecfg = mt.elastic.ElasticConfig(prefix, every_n_steps=1, sync=True,
                                    supervisor=sup)
    r0 = reg.counter("elastic_retries").value
    s0 = reg.counter("elastic_restores").value
    attempts, held = [], {}

    def fit_fn(resume):
        attempts.append(resume)
        held["mod"] = fit(elastic=ecfg, resume=resume)

    saved = {k: os.environ.get(k) for k in ("MXTPU_WATCHDOG_WAIT_S",
                                            "MXTPU_WATCHDOG_INTERVAL_S")}
    diag.stop_watchdog()
    os.environ["MXTPU_WATCHDOG_WAIT_S"] = str(el["wedge_wait_s"])
    os.environ["MXTPU_WATCHDOG_INTERVAL_S"] = str(el["wedge_interval_s"])
    t0 = time.perf_counter()
    try:
        with mt.faults.scope("executor.device_wait:latency_ms=%d,times=1,"
                             "after=%d" % (el["wedge_ms"],
                                           el["wedge_after"])):
            sup.run(fit_fn)
    finally:
        diag.stop_watchdog()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    secs = time.perf_counter() - t0
    retries = reg.counter("elastic_retries").value - r0
    restores = reg.counter("elastic_restores").value - s0
    same = same_bits(host_weights(held.pop("mod")), bare)
    log("  [%s] the mlp wedged once (%d ms at executor.device_wait past "
        "the watchdog's %.2f s): attempts %s, elastic_retries +%d, "
        "elastic_restores +%d, %.1f s; weights bit for bit the bare fit's "
        "%s" % (card, el["wedge_ms"], el["wedge_wait_s"], attempts, retries,
                restores, secs, same))
    if attempts != [False, True] or retries != 1 or restores != 1:
        raise AssertionError("wedge: attempts %s, retries +%d, restores "
                             "+%d" % (attempts, retries, restores))
    return dict(attempts=attempts, retries=retries, restores=restores,
                seconds=secs, bit_for_bit=same)


def phase_elastic(mt, att, epi, seed, card):
    """Phase 25: async snapshots, exact resume and the supervisor on the
    card (see the module docstring)."""
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        free = shutil.disk_usage(tmp).free
        sym = mt.models.get_transformer_lm(**LM)
        arg_shapes, _, _ = sym.infer_shape(data=(1, LM["seq_len"]))
        n_params = sum(int(np.prod(s)) for nm, s in
                       zip(sym.list_arguments(), arg_shapes)
                       if nm not in ("data", "softmax_label"))
        gen_bytes = 3 * 4 * n_params  # params and Adam's two moments
        need = ELASTIC["disk_generations"] * gen_bytes
        log("  %s: %.1f GB free; an LM generation is ~%.2f GB, %d wanted"
            % (tmp, free / 1e9, gen_bytes / 1e9,
               ELASTIC["disk_generations"]))
        if free < need:
            raise AssertionError("elastic: %.1f GB free under %s, %.1f GB "
                                 "wanted" % (free / 1e9, tmp, need / 1e9))
        parts = {}
        lm = elastic_lm(mt, att, seed, card, tmp)
        parts["lm"] = time.perf_counter() - t0
        turns = elastic_turns(mt, att, seed, card, tmp, lm.pop("inputs"))
        parts["turns"] = time.perf_counter() - t0 - sum(parts.values())
        resnet = elastic_resnet(mt, epi, seed, card, tmp)
        parts["resnet"] = time.perf_counter() - t0 - sum(parts.values())
        wedge = elastic_wedge(mt, seed, card, tmp)
        parts["wedge"] = time.perf_counter() - t0 - sum(parts.values())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t0
    log("  phase 25 (elastic): %.1f s (%s)"
        % (secs, ", ".join("%s %.1f s" % kv for kv in parts.items())))
    fwd = dict(lm["launches"]["fwd"], lm_elastic_turns=turns["fwd"])
    bwd = dict(lm["launches"]["bwd"], lm_elastic_turns=turns["bwd"])
    return dict(lm=lm, turns=turns, resnet=resnet, wedge=wedge,
                seconds=secs, parts=parts, launches={
                    "flash_fwd": fwd, "flash_bwd": bwd,
                    "epilogue": {"resnet_elastic_eval": resnet["launches"]}})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one largest-bucket forward of each "
                         "model and one training step of the LM, of "
                         "ResNet-50 through Module and through Gluon with "
                         "torch.profiler and print device time by kernel")
    ap.add_argument("--parent", metavar="CSRC", action="append", default=[],
                    help="the csrc directory of another tree (a parent "
                         "commit or a variant, unpacked outside the "
                         "commit): build its flash, ROIPooling and CTC "
                         "sources too and time its kernels in turns with "
                         "this tree's in phases 3, 3c, 12, 16 and 17 "
                         "(ROIPooling's backward and CTC's loss also "
                         "compared bit for bit); repeatable")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %s to run after the "
                         "build (for iterating on one kernel); the kernels "
                         "line and the device line are printed only when "
                         "every phase ran" % ",".join(PHASES))
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run the data-parallel paths over 4 cards instead "
                         "of the phases (raises below 4 CUDA devices)")
    ap.add_argument("--multi-phases", default=",".join(MULTI_PHASES),
                    help="with --multi-gpu, a comma-separated subset of %s "
                         "(the summary line and the device line are "
                         "printed only when every one ran)"
                    % ",".join(MULTI_PHASES))
    ap.add_argument("--dist-worker", action="store_true",
                    help=argparse.SUPPRESS)  # one rank of --multi-gpu
    ap.add_argument("--kv-worker", choices=("async", "sync", "one"),
                    help=argparse.SUPPRESS)  # one process of dist_async
    args = ap.parse_args(argv)
    if args.dist_worker:
        return dist_worker(args.seed, args.out)
    if args.kv_worker:
        return kv_worker(args.kv_worker, args.seed, args.out)
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        raise SystemExit("chip_smoke: unknown phases %s" % unknown)

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    import mxtpu_torch as mt
    from mxtpu_torch.ops import attention as att
    from mxtpu_torch.ops import epilogue as epi
    card = card_line()
    log(card)
    if args.multi_gpu:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return multi_gpu(args, card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("torch %s, CUDA %s, %s, allow_tf32 matmul=%s cudnn=%s"
        % (torch.__version__, torch.version.cuda,
           torch.cuda.get_device_name(0),
           torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32))
    log("image packages (the record pipeline decodes with cv2 and packs "
        "with PIL): %s" % image_packages())

    # 2. build: the other trees' sources start first, so that every
    # nvcc of both trees runs at once
    t0 = time.perf_counter()
    parents = [ParentKernels(mt.build, csrc, i)
               for i, csrc in enumerate(args.parent)]
    built = mt.build.build()
    log("[build] %s in %.1f s wall" % (
        {k: round(v, 1) for k, v in built.items()},
        time.perf_counter() - t0))
    for name, rec in mt.build.build_log.items():
        for inst, regs, st, ld in ptxas_instances(rec["ptxas"]):
            log("  %s: %s: %d registers, %d bytes spill stores, %d bytes "
                "spill loads" % (name, inst, regs, st, ld))
    hmma = check_flash_build(mt.build)
    parents = [p.finish(att) for p in parents]
    if parents:
        log("[build] with the other trees' sources: %.1f s wall"
            % (time.perf_counter() - t0))

    results = {"card": card, "build_s": built, "hmma": hmma,
               "parents": [{"csrc": p.csrc, "ptxas": p.ptxas,
                            "hmma": p.hmma} for p in parents]}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    # 3. kernel vs plain
    if "kernels" in phases:
        log("[kernels]")
        results["flash_timed"], worst = phase_kernels(att, gen, parents)
        results["worst_err"] = {str(k): v for k, v in worst.items()}
        results["flash_d96"] = flash_head_dim_96(att, gen)
        results["flash_wide"] = flash_wide(mt, att, gen, parents)
    if "epilogue" in phases:
        log("[epilogue]")
        results["epilogue_timed"] = phase_epilogue(epi, gen)
    if "backward" in phases:
        log("[backward]")
        results["backward_timed"], worst = phase_backward(att, gen,
                                                          parents)
        results["backward_worst_err"] = {str(k): v for k, v in worst.items()}
        results["backward_numerics"] = backward_numerics(att, gen)
    # 4. LM serving
    if "serving" in phases:
        log("[serving]")
        results["serving"] = phase_serving(mt, att, args.seed, card,
                                           profile=args.profile)
    # 5. ResNet-50 serving
    if "resnet" in phases:
        log("[resnet]")
        results["resnet"] = phase_resnet(mt, epi, args.seed, card,
                                         profile=args.profile)
    # 6. LM training
    if "training" in phases:
        log("[training]")
        results["training"] = phase_training(mt, att, args.seed, card,
                                             profile=args.profile)
    # 7. ResNet-50 training
    if "resnet_training" in phases:
        log("[resnet_training]")
        results["resnet_training"] = phase_resnet_training(
            mt, epi, args.seed, card, profile=args.profile)
    # 8. Gluon ResNet-50 training
    if "gluon" in phases:
        log("[gluon]")
        results["gluon"] = phase_gluon(mt, epi, args.seed, card,
                                       results.get("resnet_training"),
                                       profile=args.profile)
    # 9. data parallelism on one card
    if "data_parallel" in phases:
        log("[data_parallel]")
        results["data_parallel"] = phase_data_parallel(
            mt, epi, args.seed, card, results.get("resnet_training"))
    # 10. the LSTM bucketing LM (BASELINE config 4)
    if "rnn" in phases:
        log("[rnn]")
        results["rnn"] = phase_rnn(mt, args.seed, card)
    # 11. the SSD detector (BASELINE config 5)
    if "ssd" in phases:
        log("[ssd]")
        results["ssd"] = phase_ssd(mt, args.seed, card)
    # 12. the inference and inspection surface, and the head-dim-256 LM
    if "surface" in phases:
        log("[surface]")
        results["surface"] = phase_surface(mt, att, epi, args.seed, card,
                                           parents)
    # 13. the record pipeline: configs 2 and 5 fed from .rec files
    if "records" in phases:
        log("[records]")
        results["records"] = phase_records(mt, epi, args.seed, card,
                                           results.get("resnet_training"))
    # 14. the rest of the Python frontend on ResNet-50 v2 at full width
    if "frontend" in phases:
        log("[frontend]")
        results["frontend"] = phase_frontend(mt, epi, args.seed, card,
                                             results.get("resnet_training"))
    # 15. the rest of the image zoo at full width and the op tranche
    if "zoo" in phases:
        log("[zoo]")
        results["zoo"] = phase_zoo(mt, epi, args.seed, card)
    # 16. the Faster R-CNN at VGG16's widths and the ROIPooling kernel
    if "rcnn" in phases:
        log("[rcnn]")
        results["rcnn"] = phase_rcnn(mt, args.seed, card, parents)
    # 17. the LSTM-OCR trained with CTC and the CTC kernel pair
    if "ctc" in phases:
        log("[ctc]")
        results["ctc"] = phase_ctc(mt, args.seed, card, parents)
    # 18. the sparse NDArray, row_sparse_pull, linalg and contrib's rest
    if "sparse" in phases:
        log("[sparse]")
        results["sparse"] = phase_sparse(mt, args.seed, card)
    # 19. dist_async and the TCP parameter server
    if "dist_async" in phases:
        log("[dist_async]")
        results["dist_async"] = phase_dist_async(mt, args.seed, card)
    # 20. telemetry, tune, engine, profiler and faults on the LM's paths
    if "scaffolding" in phases:
        log("[scaffolding]")
        results["scaffolding"] = phase_scaffolding(mt, att, args.seed, card)
    # 21. the compile pipeline: bf16, layout, remat and quant on the card
    if "compile" in phases:
        log("[compile]")
        results["compile"] = phase_compile(mt, att, epi, args.seed, card,
                                           profile=args.profile)
    # 22. the ledger, the watchdog, health, the Monitor adapter and tune
    if "observability" in phases:
        log("[observability]")
        results["observability"] = phase_observability(
            mt, att, epi, args.seed, card,
            results.get("surface", {}).get("monitor_step"))
    # 23. continuous serving: K in flight, hot-swap, admission, HTTP
    if "continuous" in phases:
        log("[continuous]")
        results["continuous"] = phase_continuous(mt, att, epi, args.seed,
                                                 card)
    # 24. decode: the paged attention decoder and the LSTM step
    if "decode" in phases:
        log("[decode]")
        results["decode"] = phase_decode(mt, args.seed, card)
    # 25. elastic: snapshots, exact resume, preemption and the wedge
    if "elastic" in phases:
        log("[elastic]")
        results["elastic"] = phase_elastic(mt, att, epi, args.seed, card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    if phases != list(PHASES):
        log("chip_smoke: phases %s only; no kernels line, no device line"
            % phases)
        return 1

    timed = results["flash_timed"]
    epi_timed = results["epilogue_timed"]
    served, resnet = results["serving"], results["resnet"]
    trained = results["training"]
    resnet_eval = results["resnet_training"]["eval_launches"]
    gluon_eval = results["gluon"]["eval_launches"]
    dp_eval = results["data_parallel"]["eval_launches"]
    bwd_row = next(r for r in results["backward_timed"]
                   if r["dtype"] == "float32" and r["B"] == TRAIN["batch"])
    main_row = next(r for r in timed if r["dtype"] == "float32"
                    and r["B"] == max(BUCKETS))
    ssd = results["ssd"]
    nms_row = ssd["nms"]
    d96 = {r["dtype"]: r["D96"] for r in results["flash_d96"]}
    surface = results["surface"]
    surf_lm, wide_lm = surface["lm"], surface["wide_lm"]
    wide = next(r for r in results["flash_wide"]["timed"]
                if r["dtype"] == "float32")
    rec_launches = results["records"]["launches"]
    front_launches = results["frontend"]["launches"]
    zoo_launches = results["zoo"]["launches"]
    rcnn_res = results["rcnn"]
    rcnn_launches = rcnn_res["launches"]
    roi = rcnn_res["roi_pooling"]
    ctc = results["ctc"]
    ctc_ocr_row = ctc["timed"]["ocr"]
    scaffold = results["scaffolding"]
    sc_served = scaffold["served"]["launches"]
    sc_fwd = scaffold["trained"]["fwd_launches"]
    sc_bwd = scaffold["trained"]["bwd_launches"]
    comp = results["compile"]
    cp_lm = comp["lm"]["launches"]
    cp_epi = {"resnet_predict_layout_bf16": comp["resnet"]["launches"],
              "resnet_predict_quant": comp["quant"]["launches"]}
    obs = results["observability"]["launches"]
    cont = results["continuous"]["launches"]
    elastic = results["elastic"]["launches"]
    bf16_row = next(r for r in timed if r["dtype"] == "bfloat16"
                    and r["B"] == max(BUCKETS))
    bwd_bf16 = next(r for r in results["backward_timed"]
                    if r["dtype"] == "bfloat16" and r["B"] == TRAIN["batch"])

    def times(row, *keys):
        return {k: row[k] for k in keys}

    kernels = {"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "mxtpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "mxtpu/ops/attention.py:92",
        "launches": served["launches"] + trained["fwd_launches"]
        + surf_lm["flash_launches"] + sc_served + sc_fwd
        + sum(v[0] for v in cp_lm.values())
        + sum(obs["flash_fwd"].values())
        + sum(cont["flash_fwd"].values())
        + sum(elastic["flash_fwd"].values()),
        "launches_by_path": dict({
            "lm_serving": served["launches"],
            "lm_training": trained["fwd_launches"],
            "lm_predictor": surf_lm["flash_launches"],
            "lm_serving_telemetry": sc_served,
            "lm_training_tuned": sc_fwd,
            "lm_training_compile_f32": cp_lm["f32"][0],
            "lm_training_bf16": cp_lm["bf16"][0]}, **obs["flash_fwd"],
            **cont["flash_fwd"], **elastic["flash_fwd"]),
        "bf16": times(bf16_row, "max_abs_err", "ms", "plain_ms",
                      "bound_ms", "bound_by", "library_ms"),
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "d96_ms": {t: r["ms"] for t, r in d96.items()}}, {
        "name": "bn_relu_epilogue", "route": "cuda",
        "source": "mxtpu_torch/csrc/bn_relu_epilogue.cu",
        "replaces": "mxtpu/ops/epilogue.py:30",
        "launches": resnet["launches"] + resnet_eval + gluon_eval + dp_eval
        + surface["resnet"]["launches"]
        + sum(rec_launches["epilogue"].values())
        + sum(front_launches.values()) + sum(zoo_launches.values())
        + sum(rcnn_launches["epilogue"].values()) + sum(cp_epi.values())
        + sum(obs["epilogue"].values())
        + sum(cont["epilogue"].values())
        + sum(elastic["epilogue"].values()),
        "launches_by_path": dict({"resnet_serving": resnet["launches"],
                                  "resnet_training_eval": resnet_eval,
                                  "gluon_eval": gluon_eval,
                                  "data_parallel_eval": dp_eval,
                                  "resnet_predict":
                                  surface["resnet"]["launches"]},
                                 **dict(rec_launches["epilogue"],
                                        **front_launches, **zoo_launches,
                                        **rcnn_launches["epilogue"],
                                        **cp_epi, **obs["epilogue"],
                                        **cont["epilogue"],
                                        **elastic["epilogue"])),
        "bf16_rows": times(epi_timed[6], "shape", "axis", "max_abs_err",
                           "ms", "plain_ms", "bound_ms", "bound_by"),
        "bf16_to_f32_rows": times(epi_timed[7], "shape", "axis",
                                  "max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by"),
        "max_abs_err": epi_timed[0]["max_abs_err"],
        "ms": epi_timed[0]["ms"], "plain_ms": epi_timed[0]["plain_ms"],
        "bound_ms": epi_timed[0]["bound_ms"],
        "bound_by": epi_timed[0]["bound_by"], "library_ms": None}, {
        "name": "flash_attn_bwd", "route": "cuda",
        "source": "mxtpu_torch/csrc/flash_attn_bwd.cu",
        "replaces": "mxtpu/ops/attention.py:199",
        "launches": trained["bwd_launches"] + sc_bwd
        + sum(v[1] for v in cp_lm.values())
        + sum(obs["flash_bwd"].values())
        + sum(elastic["flash_bwd"].values()),
        "launches_by_path": dict({
            "lm_training": trained["bwd_launches"],
            "lm_training_tuned": sc_bwd,
            "lm_training_compile_f32": cp_lm["f32"][1],
            "lm_training_bf16": cp_lm["bf16"][1]}, **obs["flash_bwd"],
            **elastic["flash_bwd"]),
        "bf16": times(bwd_bf16, "max_abs_err", "ms", "plain_ms",
                      "bound_ms", "bound_by", "library_ms"),
        "max_abs_err": bwd_row["max_abs_err"],
        "scaled_err": bwd_row["scaled_err"],
        "ms": bwd_row["ms"], "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"], "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"],
        "d96_ms": {t: r["bwd_ms"] for t, r in d96.items()}}, {
        "name": "multibox_nms", "route": "cuda",
        "source": "mxtpu_torch/csrc/multibox_nms.cu",
        "replaces": "mxtpu/ops/contrib.py:214",
        "launches": sum(ssd["launches"].values())
        + sum(rec_launches["nms"].values())
        + sum(rcnn_launches["nms"].values()),
        "launches_by_path": dict(ssd["launches"], **rec_launches["nms"],
                                 **rcnn_launches["nms"]),
        "max_abs_err": nms_row["max_abs_err"],
        "ms": nms_row["ms"], "plain_ms": nms_row["plain_ms"],
        "bound_ms": nms_row["bound_ms"], "bound_by": nms_row["bound_by"],
        "library_ms": None, "K": nms_row["K"],
        "scratch_bytes": nms_row["scratch_bytes"],
        "all_anchors": {key: nms_row["all_anchors"][key] for key in (
            "B", "K", "live", "ms", "plain_ms", "plain_B", "bound_ms",
            "bound_by", "scratch_bytes")}}, {
        "name": "flash_attn_wide_fwd", "route": "cuda",
        "source": "mxtpu_torch/csrc/flash_attn_wide.cu",
        "replaces": "mxtpu/ops/attention.py:92",
        "launches": wide_lm["served_launches"]
        + wide_lm["trained_fwd_launches"],
        "launches_by_path": {
            "lm_d256_predictor": wide_lm["served_launches"],
            "lm_d256_training_step": wide_lm["trained_fwd_launches"]},
        "max_abs_err": wide["max_abs_err"], "ms": wide["ms"],
        "plain_ms": wide["plain_ms"], "bound_ms": wide["bound_ms"],
        "bound_by": wide["bound_by"], "library_ms": wide["library_ms"],
        "shape": [wide[k] for k in ("B", "H", "T", "D")]}, {
        "name": "flash_attn_wide_bwd", "route": "cuda",
        "source": "mxtpu_torch/csrc/flash_attn_wide.cu",
        "replaces": "mxtpu/ops/attention.py:199",
        "launches": wide_lm["trained_bwd_launches"],
        "launches_by_path": {
            "lm_d256_training_step": wide_lm["trained_bwd_launches"]},
        "max_abs_err": wide["bwd_max_abs_err"],
        "scaled_err": wide["bwd_scaled_err"], "ms": wide["bwd_ms"],
        "plain_ms": wide["bwd_plain_ms"], "bound_ms": wide["bwd_bound_ms"],
        "bound_by": wide["bwd_bound_by"],
        "library_ms": wide["bwd_library_ms"],
        "shape": [wide[k] for k in ("B", "H", "T", "D")]}, {
        "name": "roi_pooling", "route": "cuda",
        "source": "mxtpu_torch/csrc/roi_pooling.cu",
        "replaces": "mxtpu/ops/spatial.py:135",
        "launches": sum(rcnn_launches["roi_pooling"].values()),
        "launches_by_path": rcnn_launches["roi_pooling"],
        "max_abs_err": roi["max_abs_err"], "ms": roi["ms"],
        "plain_ms": roi["plain_ms"], "bound_ms": roi["bound_ms"],
        "bound_by": roi["bound_by"], "route_ms": roi["route_ms"],
        "library_ms": None,
        "bwd_max_abs_err": roi["bwd_max_abs_err"], "bwd_ms": roi["bwd_ms"],
        "bwd_plain_ms": roi["bwd_plain_ms"],
        "bwd_bound_ms": roi["bwd_bound_ms"],
        "bwd_bound_by": roi["bwd_bound_by"],
        "bwd_route_ms": roi["bwd_route_ms"], "shape": roi["shape"]}, {
        "name": "ctc_loss", "route": "cuda",
        "source": "mxtpu_torch/csrc/ctc_loss.cu",
        "replaces": "mxtpu/ops/contrib.py:355",
        "launches": sum(ctc["launches"].values()),
        "launches_by_path": ctc["launches"],
        "max_abs_err": ctc_ocr_row["max_abs_err"], "ms": ctc_ocr_row["ms"],
        "plain_ms": ctc_ocr_row["plain_ms"],
        "bound_ms": ctc_ocr_row["bound_ms"],
        "bound_by": ctc_ocr_row["bound_by"],
        "route_ms": ctc_ocr_row["route_ms"],
        "library_ms": ctc_ocr_row["library_ms"],
        "bwd_max_abs_err": ctc_ocr_row["bwd_max_abs_err"],
        "bwd_ms": ctc_ocr_row["bwd_ms"],
        "bwd_bound_ms": ctc_ocr_row["bwd_bound_ms"],
        "bwd_bound_by": ctc_ocr_row["bwd_bound_by"],
        "bwd_route_ms": ctc_ocr_row["bwd_route_ms"],
        "pair_ms": ctc_ocr_row["pair_ms"],
        "pair_plain_ms": ctc_ocr_row["pair_plain_ms"],
        "pair_library_ms": ctc_ocr_row["pair_library_ms"],
        "scan_bound_ms": ctc_ocr_row["scan_bound_ms"],
        "bwd_scan_bound_ms": ctc_ocr_row["bwd_scan_bound_ms"],
        "shape": ctc_ocr_row["shape"],
        "speech": {k: ctc["timed"]["speech"][k] for k in (
            "shape", "max_abs_err", "bwd_max_abs_err", "ms", "bwd_ms",
            "pair_ms", "plain_ms", "pair_plain_ms", "library_ms",
            "pair_library_ms", "bound_ms", "route_ms", "bwd_bound_ms",
            "bwd_route_ms", "scan_bound_ms", "bwd_scan_bound_ms")}}]}
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
