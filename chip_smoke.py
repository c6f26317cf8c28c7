#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``dgl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run it from the root of a checkout, on a machine with a CUDA card. It

1. builds the hand-written CUDA kernels from ``dgl_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together), and B1's (with its weighted
   caller), B3's, B4's and B5's sources once more with ``-Xptxas -v`` for
   their registers, shared memory and spills;
1a. holds B3 against its plain version at the edges of its CSC walk (phase
    ``bitmap_gat_fwd_edge_cases``): rows of in-degree 0, 1, 31, 32, 33
    and around the chunks of 64, 128 and 256 sources, 1,000 and more, a row
    holding every source, sink indices in the CSC (padded edges, to be
    skipped), every (nh, nf) case of its switch and layer 1's H = 1,
    O = 41; rows without an edge must get out = 0 exactly and
    lse = log(1e-30);
1b. holds B4 and B5 against their plain versions at the edges of their
    walk (phase ``bitmap_gat_bwd_edge_cases``): a dst row with more set
    bits than the walk's queue holds, empty rows both ways, rows whose
    block count is not a whole number of the walk's 2-block loads, row
    counts that are not a multiple of a thread block's 8 rows, and every
    (nh, nf) case of the kernels' switch; rows without an edge must get
    exact zeros;
1c. holds B1's weighted caller (``shell_prefix_gspmm``) against its plain
    version, exactly, on small weighted shell plans (phase
    ``shell_gspmm_edge_cases``): every op, bf16 and f32 tables, every
    broadcast ``gspmm`` hands the shell path at F = 1, 40, 128, 256, 750,
    with and without the residual's base, identity and other unrank, rows
    out in rank order and in node order (``rank``), ``div`` by a zero at
    edge 0 (inf and NaN where the plain version has them), a graph without
    an edge, and 3,001 rows whose levels end at the kernel's tile edges
    (``tiles_edges``: 32 levels, a residual, rows without an in-edge);

the GraphSAGE path (kernel B1, shell prefix sum):

2. drives it once: the ogbn-arxiv-scale zipf graph (169,343 nodes,
   1,166,243 edges, as ``bench.py`` builds it),
   ``reorder_for_spmm(num_hubs=2048, precision="int8")`` and a 3-layer
   GraphSAGE 128 -> 256 -> 256 -> 40 (mean aggregator, eval mode, weights
   drawn from seed 0) under ``torch.inference_mode()``, with the kernels'
   launch counts set to 0 just before and read just after;
3. runs two more forward passes and holds the output against the same
   model on the plain exact-f32 path (a graph without a plan) at
   rtol = 2e-2, atol = 2e-2 * max|ref| (the hub path rounds the aggregated
   rows to bf16);
4. holds the kernel against its plain PyTorch version on the card, on the
   three layers' real shell inputs (F = 128, 256, 40) and at the bench
   headline width (F = 256), at rtol = atol = 1e-5 (both sum the same f32
   values in the same order);
5. times the kernel, its plain version and
   ``torch.nn.functional.embedding_bag(mode="sum")`` over the same cold
   edges (device time, launches back to back), computes the kernel's bound
   from the bytes it must move, then times the forward pass on both paths
   and ``copy_u_sum`` at F = 256 as a caller waits for them, and breaks the
   forward's device time down by kernel with ``torch.profiler``;
6. trains the same GraphSAGE shape (dropout 0.5, ``torch.optim.Adam`` at
   1e-2, masked cross-entropy over uniform random labels, every node
   labelled): holds every parameter gradient of the fresh model (dropout
   off) against the exact f32 path at rtol = 2e-2, atol = 2e-2 * max|ref|
   (the exact path following the plan path's ReLU pattern, see
   ``check_grads``),
   drives one step with the launch counts read around it (3 B1 launches
   forward and 2 backward, over the reverse shells: layer 0 aggregates the
   input, which needs no gradient), runs four more (finite losses), holds
   B1 against its plain version on the backward's real tables, and times
   and profiles the step;
6a. drives the same GraphSAGE shape with SAGEConv's ``gcn``, ``pool`` and
    ``lstm`` aggregators on the same plan (``run_sage_aggregators``): a
    counted forward (``gcn`` 3 B1 launches, ``pool`` and ``lstm`` none:
    the max and the LSTM's mailbox take the plain branch) and a counted
    step (5, 0, 0), the output and the gradients against the graph
    without a plan (``gcn`` at the plan bound, on the plan path's ReLU
    pattern; ``pool`` and ``lstm`` at rtol = 1e-4, atol = 1e-4 *
    max|ref|), four more steps (the loss must fall), times, peak memory
    and profiles;
6b. ``LabelPropagation(k=10, alpha=0.9)`` of the 40 seeded labels, 10 %
    of the nodes labelled, on the same plan: 10 B1 launches at F = 40, the
    result against the graph without a plan at rtol = 2e-2,
    atol = 2e-2 * max|ref|, and its time beside that graph's;

the Reddit-scale GCN and GAT paths (kernels B2, bitmap SpMM, B3,
bitmap-flash GAT forward, and B4 and B5, its backward):

7. builds the synthetic Reddit stand-in at full scale (232,965 nodes, the
   SBM recipe of ``dgl_tpu/data/synthetic.py``, 602-wide features, its
   labels and 60 % train split) and ``with_spmm_plans(num_hubs=256,
   bitmap=True, bitmap_max_bytes=8 << 30)``;
8. drives GCN 602 -> 16 -> 41 once (eval, weights from seed 0, counts read
   around it: two B2 launches) and holds it against the exact-f32 path at
   rtol = 2e-2, atol = 2e-2 * max|ref| (the bitmap path rounds the
   aggregated rows to bf16);
9. drives GAT 602 -> 8 x 8 heads -> 41 once (counts read around it: two
   B3 launches, B3 walking the relation's CSC), checking the output's shape
   and finiteness (step 11 holds its values);
10. holds B2 against its plain version on both GCN layers' real tables at
    rtol = 1e-5, atol = 1e-5 * max|ref| (the same f32 terms summed in
    another order), and times it, its plain version and ``torch.sparse.mm``
    on the CSR adjacency;
11. holds B3 (over the relation's CSC) against its plain version (over
    the bits) on both GAT layers' real inputs, on 4,096 dst rows spread
    over the graph (the first and last 512-row tiles included), at
    rtol = 1e-4, atol = 1e-5 * max|ref| (exponentials and sums in another
    order); holds each layer's output on those rows (the main path's output
    for the last layer) against the layer's plain forward at the same
    tolerance; times B3 and its plain version (no PyTorch call computes
    B3), and gives B3's byte bound over the CSC, the bytes its gathers move, its
    ``ptxas`` figures, blocks per SM and gather bytes in flight per SM,
    beside its time as a bitmap walk (``prev_ms``, PERF.md's figure, not
    measured here);
12. times both forwards as a caller waits for them and breaks their device
    time down by kernel with ``torch.profiler``;
13. trains GCN (dropout 0.5): gradients against the exact f32 path as in
    step 6, one counted step (4 B2 launches: 2 forward, 2 backward over
    ``bits``, the graph being symmetric), four more (finite, falling
    losses), B2 against its plain version on the backward's real ``dz``,
    step time and profile;
14. trains GAT (no dropout): one counted step (2 launches each of B3, B4
    and B5), four more (finite, falling losses); holds B4 and B5 against
    their plain versions on both layers' real step inputs, B4 on the 4,096
    dst rows of step 11 and B5 on 4,096 source rows chosen the same way,
    at B3's tolerance; times both (no PyTorch call computes them; the plain
    versions on the check rows only) beside their times with ``dz`` in
    f32 (``prev_ms``, PERF.md's figure for them, not measured here),
    ``ptxas``'s figures, the blocks an SM holds and the bitmap bytes in
    flight per SM while those warps load; times the step and profiles it.

the hub-cache path (kernel B6, hub gather; ``benchmarks/bench_hub.py``'s
defaults: 1024 hubs, F = 256, f32):

15. on the arxiv-scale zipf graph of step 2 without a plan, builds the hub
    plan (its coverage printed), drives ``ops.hub_cache.hub_copy_u_sum``
    once per precision (``"highest"`` and ``"bf16"``) with the launch
    counts read around each call (one B6 launch each), and holds each
    output against the exact ``ops.copy_u_sum`` at rtol = 2e-4,
    atol = 2e-4 * max|ref| (``"highest"``) and max abs err
    <= 2e-2 * max|ref| (``"bf16"``), the bounds of
    ``tests/test_pallas_hub.py``;
16. holds B6 against its plain version on the path's real hub table and
    slots, for both precisions (both exact selections: max abs err 0.0),
    times it, its plain version and ``torch.nn.functional.embedding`` over
    the table with a zero row appended, gives its byte bound, and times
    ``hub_copy_u_sum`` as a caller waits for it beside plain ``copy_u_sum``
    and the ``reorder_for_spmm`` hub path (``bench_hub.py``'s comparison);

the per-edge GAT path (g-SDDMM, edge softmax, g-SpMM; no hand kernel):

17. on the same zipf graph plus one self-loop per node (1,335,586 edges, no
    plan), drives ``GAT(128, 250, 40, heads=3, num_layers=3)``, the widths
    of DGL's ogbn-arxiv GAT, once in eval mode (weights from seed 0) with
    every kernel count read around it (all must stay 0), checks the
    output's shape and finiteness and holds it against the same model on
    the CPU at rtol = 1e-4, atol = 1e-4 * max|ref| (the same f32
    operations, sums in other orders), and times and profiles the forward;
18. trains it (feat_drop 0.75, attn_drop 0.05, Adam at 1e-2, masked
    cross-entropy over uniform random labels, every node labelled): one
    counted step (every kernel count 0), four more (finite losses), step
    time, peak memory and a profile;

the weighted shell plan (B1's weighted caller; the fused and dense GAT
routes, no hand kernel), on the graph of step 17 built with
``with_spmm_plans(num_hubs=2048, weighted=True)`` (bf16 gathers; its
levels and residuals printed, ``plans_s``):

18a. weighted GCN at ogbn-arxiv widths: ``EdgeWeightNorm("both")`` over
     edge weights uniform in [0.5, 1.5) from a seed (one kernel launch,
     its ``copy_rhs`` degree sum, recorded), then three
     ``GraphConv(norm="none")`` layers 128 -> 256 -> 256 -> 40 with ReLU
     and dropout 0.5, as DGL users compose them
     (``weighted_gcn``): one counted forward (3 launches: the layers
     aggregate at 128, 256 and 40), held against the same layers on the
     graph without plans (the exact f32 path) at rtol = 2e-2,
     atol = 2e-2 * max|ref|; gradients as in step 6; one counted step (5
     launches: the backward over the reverse shells at 256 and 40, the
     input needing none), four more; the kernel against its plain version
     (exact) at each of the six recorded shapes (the five of the step and
     ``EdgeWeightNorm``'s), with its byte bound, ``torch.sparse.mm`` over
     the f32 CSR of the weights (times a ones column for the degrees),
     ``ptxas``'s figures and its occupancy; times and profiles (the
     kernel stores rows in node order: no unrank gather follows it);
18b. GAT 128-250x3-40 over the fused shell-space route: one counted
     forward (every kernel count 0, three fused layers), held against the
     per-edge route on the graph without plans at rtol = 2e-2,
     atol = 2e-2 * max|ref| and against the same fused route on the CPU
     (at most 1 element in 1000 outside 1e-4, all within 2**-8 of
     max|ref|); times, profile, peak memory; training with feat_drop 0.75
     and attn_drop 0.05 (an (E, H) mask), Adam, five steps with finite
     losses, the step time beside step 18's;
18c. dense attention at Cora's size: a seeded random graph of 2,708 nodes,
     10,556 edges (5,278 pairs) plus self-loops, 1,433 features, DGL's Cora
     GAT (8 heads of 8, 7 classes) over ``with_spmm_plans(weighted=True)``:
     both layers take the dense route in bf16 (recorded); the output and
     gradients against the per-edge route within 3e-2 L2-relative and the
     loss sum(out**2) within 1e-2, the reference's bound for that route;
     one training step with both dropouts 0.6;
18d. the conv zoo over the same graph and plans (``run_conv_zoo``):
     GATv2Conv, DotGatConv, AGNNConv, EGATConv, EdgeGATConv, GINConv
     (sum), GINEConv, EdgeConv, SGConv (k = 2), APPNPConv (k = 10),
     TAGConv, ChebConv (k = 3), GCN2Conv with and without edge weights,
     GatedGraphConv, NNConv (16 -> 16: its per-edge matrices), GMMConv
     (sum, mean, max) and CFConv, at in 128 and out 256 (4 heads of 64):
     one forward and one backward on the planned graph with the launches
     counted (the forward's B1 launches, one a ``copy_u`` sum through the
     hub plan, and B1w launches, one an other sum or mean through the
     shell plan, must be ``zoo_convs``' table) and on the graph without
     plans (none), every output and gradient held at rtol = 2e-2,
     atol = 2e-2 * max|ref| (the plain path following the planned pass's
     ReLU pattern, the max convs' also the plan's picks,
     ``following_plan_max``), and the forward's time on both; also
     PNAConv (mean, max, min, std times identity,
     amplification, attenuation) and its tower, DGNConv (mean, dir1-av,
     dir1-dx over a seeded (N, 3) eigenvector input), GatedGCNConv,
     TWIRLSConv (4 steps, attention after 2), AtomicConv (4 filters, 4
     atom types), EGNNConv and GroupRevRes of two GraphConv 64 -> 64
     (PNA's std also on the plan's roundings,
     ``following_plan_rounding``);
18e. the dense convs at Cora's size (``run_dense_convs``), 1433 -> 16:
     DenseGraphConv, DenseSAGEConv and DenseChebConv against GraphConv,
     SAGEConv (mean) and ChebConv on the same graph, outputs and
     gradients at rtol = 1e-4, atol = 1e-4 * max|ref|;
18f. the graph-transformer layers at Graphormer-base's width
     (``run_gt``: 768, 32 heads, 64 graphs padded to 51 nodes): the
     encoders, GraphormerLayer, EGTLayer and LapPosEncoder, the card
     against the CPU at rtol = 1e-4, atol = 1e-4 * max|ref|;
18g. the link scorers (EdgePredictor, TransE, TransR) and a NodeEmbedding
     of 169,343 x 128 with one sparse Adam and one sparse Adagrad update
     over ids with repeats, the card against the CPU
     (``run_link_sparse``);
18h. ``explain_gcn`` (after the conv zoo, on the same graphs): GNNExplainer
     over the weighted GCN 128-256-256-40 (eval; ``explain_gcn_fn``:
     ``EdgeWeightNorm("both")`` of the explainer's edge mask, then the
     layers): the first epoch's loss and mask gradients on the weighted
     plan against the graph without plans at rtol = 2e-2,
     atol = 2e-2 * max|ref| (on the plan pass's ReLU pattern); then
     ``explain_graph`` at 100 epochs with the launch counts read around
     it (B1w 7 an epoch: 4 forward, 3 backward, and 4 for the target
     pass), masks in [0, 1], timed; ``explain_node`` on the node with the
     most in-edges (3 hops; the subgraph carries no plan, no launch) of the graph
     without plans against its CPU copy at rtol = 1e-4,
     atol = 1e-4 * max|ref|;

the minibatch GraphSAGE paths (no hand kernel), on the zipf graph with
``bench.py``'s ogbn-products widths (100-wide f32 features, labels in
[0, 47), GraphSAGE 100 -> 256 -> 47, batch 512, fanouts [10, 10]):

19. ``sage_minibatch`` (``bench.py:388-495``): samples 4 batches of a
    seeded permutation once on the host with
    ``FixedShapeNeighborSampler`` (the first call builds
    ``csrc/host_ops.cpp`` with ``g++``; ``sample_ms`` is a batch's host
    time, C++ included), holds one step on the card (feature gather,
    forward over the 2 blocks, masked loss, backward) against the same
    step on the CPU at rtol = 1e-4, atol = 1e-5 * max|ref| (loss, logits,
    every gradient), drives one epoch of the 4 SGD steps (lr 1e-3) with
    the launch counts read around it (all must stay 0), prints
    ``ms_per_step`` (median of 5 runs of 10 epochs after a warm one),
    ``edges_per_s``, ``run_spread`` and a profile, and checks that the
    first batch's loss is finite and lower after training;
20. ``sage_minibatch_end_to_end`` (``bench.py:286-385``): holds the
    on-device sampler's picks on a part-masked batch (every unmasked pick
    an in-neighbour, rows of in-degree at most 10 taking all their
    neighbours in order, masks 0 past the degree and under masked seeds),
    then drives one epoch (``device_seed_batches`` from a CUDA generator,
    330 steps of sampling, feature gather, ``DeviceSAGE`` forward and
    backward and an Adam step at 1e-3) with the launch counts read around
    it (all 0) and any host sync an error, and prints ``bench.py``'s
    ``ms_per_step``, ``steps_per_epoch``, ``edges_per_s`` and ``epoch_s``
    (1 + 2 epochs against 1, best of 2 each), a step's profile, and the
    epochs' mean losses, which must be finite and fall;

20'. ``graphbolt_device``: the same work through GraphBolt's on-device
     backend (``ItemSampler`` -> ``DeviceNeighborSamplerStage([10, 10])``
     -> ``DeviceFeatureFetcher`` -> ``DeviceSAGE``, Adam at 1e-3, through
     ``gb.DataLoader``): the first batch's picks checked as in 20 and its
     features the table's rows, 40 steps with the launch counts read
     around them (all 0), losses finite and falling, ``ms_per_step``
     beside 20's;

the host samplers and dataloading (no hand kernel: every count must stay
0), on a graph of ogbn-products' counts (``products_graph``: 2,449,029
nodes, 61,859,140 pairs of the SBM recipe stored both ways in order,
123,718,280 edges, 100-wide features, 47 classes; a CPU copy beside it):

20a. ``products_sage_minibatch``: DGL's ``node_classification.py``,
     GraphSAGE 100-256-256-47 (mean, dropout 0.5) over
     ``NeighborSampler([10, 10, 10])`` blocks through the ``DataLoader``
     (batch 1,024, shuffled, the prefetch thread), Adam at 1e-3; the
     first batches with the thread equal to those sampled inline and to
     the CPU graph's, id for id and frame for frame; the first step's
     loss and gradients (dropout off) against the CPU at rtol = 1e-4,
     atol = 1e-4 * max|ref|, on the card pass's ReLU pattern; 5 counted
     steps with finite losses, the loader's buffered batches drained,
     3 more that each wait on the sampling thread (``ms_per_step``,
     ``edges_per_s`` over sampled edges), 2 profiled
     (``device_idle_share``); then the same with ``LaborSampler``, and
     one batch of 4,096 nodes through ``MultiLayerFullNeighborSampler(1)``
     into the first layer, against the CPU;
20b. ``products_link_prediction``: DGL's ``link_pred.py``,
     ``as_edge_prediction_sampler(NeighborSampler([15, 10, 5]),
     exclude="reverse_id", negative_sampler=Uniform(1))``, batch 512
     seed edges, a SAGE encoder 100-256-256-256 and the dot-product
     scorer, ``-log sigmoid`` of the pairs and negatives; the pair graph
     holds the seed edges, no block holds a seed edge or its reverse, the
     batches and the first step against the CPU as in 20a;
20c. ``host_samplers``: every host sampler once with the graph on the
     card and once on the CPU, the results equal, each one's time on
     each: the per-seed ones on the products graph, the rest on the arxiv
     zipf graph, PinSAGE and ``DeviceNeighborSampler.sample_from`` (its
     picks equal to ``_pick``'s on its own draws) on item -> user graphs
     of that graph's edges, and DeepWalk (dim 128, walks of 40, window 5)
     steps, their losses against the CPU at 1e-4;
20d. ``graphbolt_products``: DGL's GraphBolt ``node_classification.py``
     from disk: the graph (int64 endpoints), features, labels and train
     split written by ``gb.OnDiskDataset.write`` under ``build/`` and
     loaded back (the CSC equal to the graph's; the directory removed
     after), the features a ``DiskBasedFeature`` read by ``pread`` behind
     ``HBMFeatureCache.from_degrees`` (262,144 hot rows on the card),
     ``ItemSampler(1024, shuffle)`` -> ``NeighborSamplerStage([10, 10,
     10])`` -> ``FeatureFetcher`` -> ``CopyTo`` -> ``gb.DataLoader``,
     GraphSAGE 100-256-256-47 (mean, dropout 0.5), Adam at 1e-3: the
     first batch (blocks, input ids, features) equal to the same pipeline
     over the CPU graph, the first step against the CPU at 1e-4 as in
     20a, two batches stage by stage (``sample_ms``, ``fetch_ms`` and its
     disk reads, ``copy_ms``), one warm and 10 timed steps through the
     loader's thread (``step_ms``, ``ms_per_step``, the counts 0, the
     cache's hit rate, peak memory, the resident memory's growth, the
     feature file never mapped), two profiled (``device_idle_share``);
20e. ``graphbolt_layer_and_fused_csc``: the first batch of
     ``gb.LayerNeighborSampler([10, 10, 10])``, ``gb.from_dglgraph`` with
     ``SamplePerLayer`` + ``CompactPerLayer`` over 3 layers of fanout 10
     for 1,024 seeds into ``to_dgl_blocks``, and ``in_subgraph`` of the
     seeds, card against CPU exactly, each timed; the graph cache stages,
     the CPU and card feature caches and ``all_to_all`` at world size 1;

the heterogeneous path (kernel B1 on bipartite relations), R-GCN on a
graph of ogbn-mag's published counts (``mag_graph``: 736,389 papers,
1,134,649 authors, 8,740 institutions, 59,965 fields, 21,111,007 edges
over 4 relations, 128-wide features, 349 classes; the recipe of
``dgl_tpu/data/synthetic.py:324-395``, vectorised):

21. ``with_spmm_plans(num_hubs=2048)`` (int8 hubs; no relation passes the
    bitmap or dense gate, which is checked), then the R-GCN of
    ``examples/rgcn_hetero.py`` as user code (``hetero_rgcn``: two
    ``HeteroGraphConv`` layers of ``GraphConv``, 128 -> 64 -> 349, OGB's
    R-GCN widths for ogbn-mag), one counted forward (6 B1 launches:
    layer 1 skips ``writes`` and ``affiliated_with``, whose source type
    has no input there), held against the exact f32 path (the graph
    without plans) at rtol = 2e-2, atol = 2e-2 * max|ref|; gradients as in
    step 6; one counted step with Adam at 1e-2 and masked cross-entropy on
    the paper train split (9 launches: the backward of layer 1's
    ``cites`` and layer 0's ``cites`` and ``writes``), four more with
    finite, falling losses; B1 against its plain version on ``writes``
    both ways and ``affiliated_with`` forward (the step's real tables)
    and backward (a seeded table: institution reaches no loss), at
    rtol = atol = 1e-5, with its bound and ``embedding_bag``'s time;
    times, profiles and peak memory;
21a. ``mag_rgcn_minibatch``: the same R-GCN over
     ``HeteroFixedShapeNeighborSampler`` blocks of the same graph
     (fanouts [25, 20], ``hetero_rgcn.py``'s, on every relation into a
     sampled type; batch 1,024 papers): the blocks equal to the CPU's and
     of the same shapes every batch, the first step against the CPU at
     1e-4, 5 counted steps each sampling its batch inline
     (``ms_per_step`` with the sampling, ``step_ms`` without), the
     per-type slot caps; then
     ``sample_etype_neighbors`` over ``to_homogeneous`` of the graph,
     card against CPU;
21b. ``explain_rgcn``: HeteroGNNExplainer on the same R-GCN (eval, each
     relation's edge mask through ``mod_kwargs`` as its GraphConv's
     ``edge_weight``), ``explain_node("paper", ...)`` on the most cited
     paper with ``num_hops=2`` and 100 epochs (no launch), against the
     same explainer on the graph's CPU copy at rtol = 1e-4,
     atol = 1e-4 * max|ref|;
22. ``multi_update_all`` (copy_u, sum; cross reducer sum) over the four
    relations (4 B1 launches) and a ``pull`` over ``writes`` (1), held
    against the plain branch at rtol = 2e-2, atol = 2e-2 * max|ref|;
23. ``RGCN(128, 64, 349, num_rels=4, num_bases=2)`` over
    ``to_homogeneous`` of the same recipe at 1/8 of its counts (242,468
    nodes, 2,638,877 edges; no hand kernel, every count 0): one forward
    and one step held against the same model on the CPU at rtol = 1e-4,
    atol = 1e-4 * max|ref|, times and a step's profile;
24. DGL's HGT (``hgt_model``: per-type ``HeteroLinear`` adapters into 256
    and GELU, two ``HGTConv`` layers of 4 heads of 64 with ``use_norm``
    and dropout 0.2, a linear classifier to 349 on the paper rows) over
    ``to_homogeneous`` of the same recipe: at 1/32 of its counts one
    forward and one step (dropout off) held against the same model on the
    CPU at rtol = 1e-4, atol = 1e-4 * max|ref|; at 1/8 (242,468 nodes,
    2,638,877 edges) one counted forward and one counted step (no hand
    kernel: every count 0) with their peak memory, three more steps with
    finite, falling losses, times and profiles;

the sparse-matrix API and the graph utilities (B1 in the recipe only):

25. ``sparse_gcn``: DGL's sparse-API GCN (``examples/sparse/gcn.py``) at
    the arxiv GCN widths, 128-256-256-40, over ``D^-1/2 (A + I) D^-1/2``
    of ``to_bidirected(remove_self_loop(g))`` on the zipf graph, built as
    the example builds it (``sparse_gcn_matrix``; ``setup_s``): one
    counted forward and backward (every kernel count 0: ``spmm`` runs the
    plain g-SpMM of the reversed relation, which has no plan), output and
    gradients against three ``GraphConv(norm="both")`` layers with the
    same weights on the graph plus self-loops and against the same model
    on the CPU at rtol = 1e-4, atol = 1e-4 * max|ref| (on the sparse
    pass's ReLU pattern, as ``check_grads``), every sparse op of
    ``sparse_op_cases`` card against CPU at 1e-5 and timed, five Adam
    steps with a falling loss, times and profiles;
26. ``gcn_recipe``: ``examples/gcn_cora.py``'s recipe at arxiv scale,
    ``add_self_loop(remove_self_loop(g))`` and ``with_spmm_plans(
    weighted=True)``, ``GCN(128, 256, 40, num_layers=3)``: a counted
    forward (3 B1 launches) and step (5), against the graph without plans
    at rtol = 2e-2, atol = 2e-2 * max|ref| (gradients as in step 6), five
    steps with a falling loss, times and a profile; then each host
    transform of ``recipe_transforms`` at this size, timed, its card
    result equal to the CPU's, ``khop_graph`` and ``line_graph`` on a
    2,000-node ``rand_graph``, and the zipf graph's two-hop path counts;
27. ``batched_readout``: OGB's molhiv GIN (five ``GINConv`` sum layers,
    MLP 300-300, ``mean_nodes``, a linear to one logit) over a ``batch``
    of 32 random molhiv-sized graphs (``molhiv_graphs``): a counted BCE
    step (every kernel count 0), logits and gradients against the CPU at
    rtol = 1e-4 on the card pass's ReLU pattern, five Adam steps with a
    falling loss, times and profiles; then on a batch of 4,096 such
    graphs each readout of ``readout_cases`` card against CPU at 1e-5,
    and ``unbatch``, ``slice_batch`` and ``pad_batch`` equal to the CPU's;

the rest of the graph utilities (B1 under SIGN, B1w under GDC):

28. ``sign_diffusion``: ``SIGNDiffusion(k=3)`` (DGL's SIGN example) with
    ``gcn``, ``ppr`` and ``raw`` at F = 128 on the arxiv zipf graph with
    ``reorder_for_spmm``'s hub plan: a counted call each (3 B1 launches,
    one a hop), every recorded B1 call against its plain version at 1e-5,
    each hop against the same graph without plans at rtol = 2e-2,
    atol = 2e-2 * max|ref|, that graph's card result against the CPU's at
    1e-5, times and a profile;
29. ``gdc_gcn``: ``GDC("ppr")`` and ``GDC("heat")`` at their defaults on
    the Cora-sized graph (dense on the host; the diffused graph equal to
    the CPU's), then the weighted GCN 1433-16-7 with the diffusion's
    weights over ``with_spmm_plans(weighted=True, bitmap=False,
    dense_attn=False)``: a counted forward (2 B1w launches) and step (4),
    output and gradients against the graph without plans at 2e-2, each
    forward B1w call against its plain version (exact) with its bound and
    ``torch.sparse.mm``, times;
30. ``graphormer``: ``prepare_batch`` of 128 molhiv-sized graphs and
    Graphormer-base (12 layers, 768, 32 heads, max_degree 64, max_dist 5):
    the card against the CPU (in f64) on 16 of them (logits and
    gradients at rtol = 1e-4, atol = 1e-4 * max|ref|, on the card pass's
    ReLU pattern),
    a counted BCE/Adam step (no kernel), five steps, times, peak memory
    and profiles;
31. ``gin_glob``: ``models.GIN`` (5 x 300, sum readout) over phase 27's
    32 graphs, logits against the CPU at 1e-5 and gradients at 1e-4, five
    steps, times; every ``nn.glob`` pooling class over 4,096 such graphs
    against the CPU at 1e-5, timed;
32. ``point_cloud``: DGCNN's ``SegmentedKNNGraph(20)`` over 32 clouds of
    1,024 random points (edges equal to the CPU's but for float32
    near-ties, ``knn_near_ties``), its first ``EdgeConv`` 3 -> 64 against
    the CPU at 1e-5, PointNet++'s ``farthest_point_sampler`` of 512 and
    the segmented ``knn`` query (both exact), times;
33. ``graph_utilities``: the dense encodings and paths at Cora's size,
    the linear utilities and module transforms on the zipf graph, the
    others on ``rand_graph(2000, 10000)``, ``laplacian_lambda_max`` over
    256 molhiv-sized graphs and the Child-Sum Tree-LSTM of
    ``examples/tree_lstm.py`` over ``prop_nodes_topo`` on 256 random
    trees: each card result against the CPU's (exact, device values at
    1e-5), timed;

the multilevel partitioner and the explainers (no hand kernel: every count
must stay 0):

34. ``cluster_gcn``: DGL's Cluster-GCN recipe
    (``examples/pytorch/cluster_gcn/cluster_gcn.py``) on the arxiv zipf
    graph with 128-wide features, 40 classes and a 60 % training mask:
    ``ClusterGCNSampler`` (70 parts, products' part size; the assignment
    equal to the one of the graph's CPU copy, both timed, the edge cut
    and part sizes printed), the ``DataLoader`` over the part ids (7 a
    batch, products' tenth of the graph; the first batches equal to the
    CPU's and the prefetch thread's to the inline ones), GraphSAGE
    128-256-256-40 (mean, dropout 0.5), Adam at 1e-3 with weight decay
    5e-4; the first step against the CPU at rtol = 1e-4, one epoch of
    10 batches with the launch counts read around it (``step_ms``, the
    card's part), ``sample_ms`` (a batch sampled inline), another epoch
    from a fresh loader (``epoch_s``, ``ms_per_step``: its thread starts
    with the epoch), peak memory and the idle share of two profiled
    steps;
35. ``partition_utilities``: ``metis_partition_assignment``,
    ``partition_graph`` with ``load_partition``, ``load_assignment`` and
    ``load_partition_book``, ``metis_partition(extra_cached_hops=1,
    reshuffle=True)``, ``reorder_graph(g, "metis")`` and ``metis_perm`` on
    ``rand_graph(2000, 10000)``, ``hetero_partition_assignment`` and
    ``partition_hetero_graph`` on the mag recipe at 1/2000: each card
    result equal to the CPU's, timed on both;
36. ``explain_gin``: OGB's molhiv GIN with a two-logit head and edge
    weights (``gin_explain_model``) over 32 random molhiv-sized graphs:
    PGExplainer (20 epochs, then ``explain_graph``; its noise the seed's
    on both devices) against the CPU at rtol = 1e-4 (loss, MLP,
    probabilities, mask), SubgraphX at its defaults on the first graph
    (the node set exactly, the score at 1e-4), and HeteroPGExplainer and
    HeteroSubgraphX on a small random heterograph the same way;

the dataset zoo (``dgl_tpu_torch.data``): the repo's recipes from their
datasets, each dataset built in a fresh temporary directory on the card and
again on the CPU from the same seed and held exactly equal, each first step
against the same path on the CPU (plan paths at rtol = 2e-2,
atol = 2e-2 * max|ref|, on the card pass's ReLU pattern; exact paths at
1e-4), the launches of a forward and a step read around them:

37. ``data_zoo``: Cora, Citeseer, Pubmed, ``RedditDataset()``,
    ``SyntheticDataset``, ``SyntheticHeteroDataset``,
    ``KnowledgeGraphDataset``, ``MiniGCDataset``, ``KarateClubDataset``,
    ``BAShapeDataset``, Minesweeper, a ``CSVDataset`` over a directory the
    phase writes, and ``AsNodePredDataset`` and ``AsLinkPredDataset`` over
    Cora: ``build_s`` on the card and the CPU, and the citation sets built
    once more from their cache (``cache_load_s``), equal to the first;
38. ``data_citation_gcn``: ``examples/gcn_cora.py``'s recipe on each of
    Cora, Citeseer and Pubmed (``add_self_loop(remove_self_loop(g))``,
    ``with_spmm_plans(weighted=True)``, GCN F-16-C, dropout 0.5, Adam at
    1e-2, 200 epochs): the plan each graph took (B2 on a bitmap plan, B1
    on a hub plan), ``forward_ms``, ``step_ms`` and the test accuracy
    beside the reference's calibrated landing;
39. ``data_gat``: ``examples/fullgraph_gat_bitmap.py`` on Cora (30 epochs,
    AdamW 5e-3, the bitmap plan forced: B3 forward, B4 and B5 backward)
    and ``examples/gat_citeseer.py`` (200 epochs, Adam 5e-3; the dense
    route, no kernel);
40. ``data_reddit_gcn``: ``examples/reddit_fullgraph_gcn.py`` on
    ``RedditDataset()`` (``to_simple``, self-loops, the forced bitmap
    plan, GraphConv 602-16-41, Adam at 1e-2, 30 steps: B2);
41. ``data_ogb_fixture_gcn``: ``from_ogb("ogbn-arxiv_mid")`` on the
    checkout's OGB-layout fixture and ``tests/test_real_train.py``'s GCN
    (hidden 32, no dropout, 120 Adam steps at 1e-2): accuracy >= 0.6 and a
    final loss < 1.0;
42. ``data_minigc_gin``: ``examples/gin_graph_classification.py``
    (MiniGC seeds 0 and 1 through ``GraphDataLoader``, GIN 1-32-8 of 3
    layers over in-degree features, Adam at 1e-2, 10 epochs): the first
    batch equal to the CPU loader's;
43. ``data_builtin_graphbolt``: ``gb.BuiltinDataset("cora")`` written from
    the zoo and loaded on the card, its CSC, features, labels and splits
    equal to ``CoraGraphDataset``'s, then GraphBolt's node-classification
    pipeline (``ItemSampler`` -> ``NeighborSamplerStage([10, 10])`` ->
    ``FeatureFetcher`` -> ``CopyTo`` -> ``DataLoader``, GraphSAGE
    1433-256-7) for 20 epochs, the first batch equal to the CPU's, and
    its accuracy on the test nodes over sampled blocks.

Each accuracy must reach twice the test set's majority share, and the
floors the reference's own tests set where they exist (GCN on Cora 0.6,
GAT 0.5, ``tests/test_end_to_end.py``).

The distributed group (no hand kernel; every launch count stays 0), four
parts held by one process on the card (a one-process mesh: the exchange
is a transpose on the card, so the times are the layer's cost, not a
scaling figure):

44. ``dist_flagship`` (after the GraphBolt phases, on the products graph):
    the repo's papers100M configuration (``docs/papers100m_flagship.md``
    section 3; papers100M's graph cut to products' counts, METIS to a
    random assignment) through dryrun phase 7's path:
    ``PartitionedGraphCSC`` (sorted on the card, equal to the numpy
    build), ``DeviceDistSampler([15, 10, 5])`` over 1,024 of each part's
    own seeds, 128-wide bf16 features and 172 classes drawn from a seed
    and pulled by ``pull_rows_in_shard_map``, ``DeviceSAGE`` 128-256-172
    (3 layers), the parts' mean loss, Adam 1e-3. Every MFG's picks are
    in-neighbours (``check_device_picks``), the pulled rows equal the
    table's, the exchanged integer bytes equal the analytic count within
    5 %, the first step is within rtol = 1e-4 of the CPU's; then sample,
    pull and step times, ``device_idle_share`` and peak memory;
45. ``dist_host_minibatch``: dryrun phase 4's DistDGL workflow on the
    same parts (``DistNeighborSampler`` [10, 10, 10], 1,024 seeds a part,
    ``DistNodeDataLoader``, ``sparse_all_to_all_pull``, GraphSAGE
    100-256-47, Adam 1e-3, 3 steps; blocks and features equal to the
    CPU's, the first step within 1e-4), then
    ``examples/distributed_link_prediction.py`` and
    ``distributed_rgcn_minibatch.py`` at their sizes, each against the
    CPU;
46. ``dist_fullgraph`` (after the dataset zoo): dryrun phase 2, 1.25M
    nodes and 10M edges in 4 random parts, shards built on the card and
    the CPU (equal), 5 steps of ``dist_copy_u_sum(mean)`` -> linear ->
    cross-entropy -> SGD; the first step, ``dist_spmm`` (sum, mean, max,
    min, edge values) and the delayed form against the single-device
    path at rtol = 1e-5, atol = 1e-5 * max|ref|;
47. ``dist_hetero``: ogbn-mag / 8 partitioned by
    ``hetero_partition_assignment``, the per-etype halo aggregation at
    F = 64, plain, edge-weighted and delayed, against
    ``multi_update_all`` at 1e-5;
48. ``dist_process_group``: ``initialize`` with a coordinator on
    127.0.0.1 joins a world-size-1 NCCL group; the pull with its backward
    and ``dist_copy_u_sum`` over it against the one-process mesh; then
    two processes over gloo on the card at P = 2 (when a world-size-1
    gloo probe takes CUDA tensors; a failed worker fails the phase);
    ``exit_client``;
49. ``dist_cooperative``: GraphBolt over ``BuiltinDataset("cora")`` with
    ``CooperativeFeatureFetcher`` on a 4-part mesh, its first batch's
    features equal to ``FeatureFetcher``'s;
50. ``dist_host_surfaces``: ``DistGraph`` over ``partition_graph``'s
    files, ``node_split``/``edge_split``, ``DistTensor`` and
    ``DistEmbedding`` with ``SparseAdam``/``SparseAdagrad`` (against the
    plain sparse optimisers at 1e-5), ``KVServer``/``KVClient``: card
    against CPU.

Every training input is built outside ``torch.inference_mode()``.
It prints one JSON object per result line, the kernel table as
``{"kernels": [...]}``, the card's name and power limit, and as its last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that line. Without a CUDA card, or outside a checkout, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

N_NODES, N_EDGES = 169_343, 1_166_243  # bench.py:178-183
IN_FEATS, HIDDEN, CLASSES, LAYERS = 128, 256, 40, 3  # OGB arxiv GraphSAGE
HEADLINE_F = 256
# the synthetic Reddit stand-in at full scale (dgl_tpu/data/synthetic.py:
# 205-223; 114,615,892 directed edges = 57,307,946 undirected pairs)
REDDIT_N, REDDIT_PAIRS = 232_965, 57_307_946
REDDIT_FEAT, REDDIT_CLASSES = 602, 41
GCN_HIDDEN = 16  # examples/reddit_fullgraph_gcn.py:48-54
GAT_HIDDEN, GAT_HEADS = 8, 8  # benchmarks/bench_reddit_gat.py:47-48
B3_CHECK_ROWS = 4096
# B3's times as a walk of the bitmap, and B4's and B5's with dz in f32, as
# PERF.md records them (H100 80GB HBM3 at 700 W), by GAT layer: printed
# beside this run's times as "prev_ms", not measured here
PREV_MS = {"bitmap_gat_fwd": {"layer0 H=8 O=8": 5.944,
                              "layer1 H=1 O=41": 5.648},
           "bitmap_gat_bwd_dst": {"layer0 H=8 O=8": 5.990,
                                  "layer1 H=1 O=41": 5.684},
           "bitmap_gat_bwd_src": {"layer0 H=8 O=8": 8.339,
                                  "layer1 H=1 O=41": 7.257}}
PREV_MS_SOURCE = {
    "bitmap_gat_fwd": "PERF.md: the kernel that walked the bitmap, before "
                      "the CSC walk; not measured in this run",
    "bitmap_gat_bwd_dst": "PERF.md: the kernel with dz in f32; not measured "
                          "in this run"}
PREV_MS_SOURCE["bitmap_gat_bwd_src"] = PREV_MS_SOURCE["bitmap_gat_bwd_dst"]
# the edge cases of B4's and B5's walk: a bitmap of 1,301 dst rows by
# 26,001 sources (7 blocks a dst row, 1 a source row), and (heads, odim)
# pairs giving each (nh, nf) case of the kernels' switch
EDGE_N_SRC, EDGE_N_DST = 26_001, 1_301
EDGE_CASES = ((1, 5), (2, 8), (3, 7), (12, 8), (1, 16), (2, 12), (5, 16),
              (1, 32), (3, 20), (2, 130))
SWITCH_CASES = {(1, 8), (2, 8), (4, 8), (8, 8), (1, 16), (2, 16), (4, 16),
                (1, 32), (2, 32), (1, 64)}
# the edge cases of B3's CSC walk: 1,301 dst rows over 5,003 sources, rows
# of the in-degrees below (around the chunks of 32, 64, 128 and 256
# sources; 5,003 is the row holding every source), and (heads, odim)
# giving each case of the switch and the GAT's layer 1
FWD_N_SRC, FWD_N_DST = 5_003, 1_301
FWD_DEGREES = (0, 1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 257,
               1000, 1500, 5003)
FWD_CASES = EDGE_CASES + ((1, 41),)
HUB_HUBS, HUB_FEAT = 1024, 256  # benchmarks/bench_hub.py's defaults
# bench.py's minibatch cells (bench.py:303-305, 399-411): ogbn-products
# widths, batch 512, fanouts [10, 10], S = 4 reused host-sampled batches
MB_FEAT, MB_HIDDEN, MB_CLASSES, MB_BATCH = 100, 256, 47, 512
MB_FANOUTS, MB_BATCHES = [10, 10], 4
MB_EPOCHS, MB_RUNS = 10, 5  # k epochs a timed run (bench.py's iters), runs
E2E_EPOCHS = 2  # the end-to-end cell times 1 + k epochs against 1
# DGL's examples/pytorch/ogb/ogbn-arxiv GAT: 3 layers, 3 heads, 250 hidden
EDGE_GAT_HIDDEN, EDGE_GAT_HEADS = 250, 3
LR = 1e-2  # optax.adam(1e-2) of the JAX package's training scripts
TRAIN_STEPS = 5
# HBM bandwidth by card name (NVIDIA data sheets), bytes/s
HBM_RATE = (("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12), ("H200", 4.8e12),
            ("H100", 3.35e12))
F32_RATE = 67e12  # H100 SXM f32 outside the tensor cores, FLOP/s


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def hbm_rate(name: str) -> float:
    for key, rate in HBM_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no HBM bandwidth on record for {name!r}")


def ptxas_start(names):
    """Compile each of ``csrc/<name>.cu`` once more with ``-Xptxas -v``
    (the build's target and optimisation), in the background; returns the
    running ``nvcc`` processes by name."""
    from torch.utils.cpp_extension import CUDA_HOME

    from dgl_tpu_torch import _kernels

    out_dir = os.path.join(_kernels.BUILD_DIR, "ptxas")
    os.makedirs(out_dir, exist_ok=True)
    return {name: subprocess.Popen(
        [os.path.join(CUDA_HOME, "bin", "nvcc"), *_kernels.CUDA_FLAGS,
         "-std=c++17", "-c", "-Xptxas", "-v", "-o",
         os.path.join(out_dir, name + ".o"),
         os.path.join(ROOT, "dgl_tpu_torch", "csrc", name + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in names}


def ptxas_key(name: str) -> str:
    """The report's key of a compiled kernel's mangled ``name``: ``nh=..
    nf=..`` for B3-B5's templates, ``gspmm T=.. vec=.. op=.. fast=..``
    for B1's weighted caller, ``sum vec=..`` for B1, else the name
    itself."""
    import re

    m = re.search(r"shell_prefix_gspmm_kernelI([tf])Li(\d+)ELi(\d+)ELb([01])E",
                  name)
    if m:
        return (f"gspmm T={'bf16' if m.group(1) == 't' else 'f32'} "
                f"vec={m.group(2)} op={GSPMM_OPS[int(m.group(3))]} "
                f"fast={m.group(4)}")
    m = re.search(r"shell_prefix_sum_kernelILi(\d+)E", name)
    if m:
        return f"sum vec={m.group(1)}"
    m = re.search(r"ILi(\d+)ELi(\d+)E", name)
    return f"nh={m.group(1)} nf={m.group(2)}" if m else name


def ptxas_report(proc) -> dict:
    """What ``ptxas -v`` said of each instantiation of a kernel template
    (keys from ``ptxas_key``): registers, static shared bytes, stack frame
    and spills."""
    import re

    text = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc -Xptxas -v failed: {text[-2000:]}")
    report, key = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']*)'", line)
        if m:
            key = ptxas_key(m.group(1))
            report[key] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and key:
            report[key].update(stack_bytes=int(m.group(1)),
                               spill_store_bytes=int(m.group(2)),
                               spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and key:
            smem = re.search(r"(\d+) bytes smem", line)
            report[key].update(registers=int(m.group(1)),
                               smem_bytes=int(smem.group(1)) if smem else 0)
    return report


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int, warmup: int = 2, hide_host: bool = False) -> float:
    """Mean time of ``fn()`` in ms, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls.

    With ``hide_host`` the stream first runs a spin kernel that lasts
    longer than the host needs to enqueue the ``iters`` calls, so the
    events time the device's work with no gaps left by Python between
    launches (a kernel's own time). Without it they time what a caller
    waits for, host overhead included (a forward pass)."""
    import torch

    host_s = 0.0
    for _ in range(warmup):
        t = time.perf_counter()
        fn()
        host_s = max(host_s, time.perf_counter() - t)
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hide_host:  # cycles at up to 2 GHz, twice the enqueue time
        torch.cuda._sleep(min(int(host_s * iters * 2 * 2e9) + 1_000_000,
                              4_000_000_000))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int) -> dict:
    """Device time by kernel name over ``iters`` calls of ``fn`` under
    ``torch.profiler``, and the device's busy share of the wall time.

    The trace can lose the first launches after it starts, so one warm
    call runs inside the trace first and only kernels that start inside a
    ``record_function`` window around the ``iters`` calls count. Each
    kernel's entry gives its ms per call and the launches counted, so a lost
    launch would show as a short count. A ``record_function`` range (the
    window, ``Optimizer.step#Adam.step``) also shows on the device's track,
    spanning the kernels launched inside it; it is no kernel and is not
    counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function("chip_smoke_window"):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    start = min(ev.time_range.start for ev in events
                if ev.name == "chip_smoke_window")
    ranges = {ev.name for ev in events
              if ev.device_type == torch.autograd.DeviceType.CPU}
    by_name: dict = {}
    for ev in events:
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.name not in ranges
                and ev.time_range.start >= start):
            key = ev.name[:80]  # kernels whose names share it are summed
            us, n = by_name.get(key, (0.0, 0))
            by_name[key] = (us + ev.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _n in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "wall_ms_per_call": wall_us / iters / 1e3,
        "device_busy_ms_per_call": busy_us / iters / 1e3,
        "device_idle_share": (1 - busy_us / wall_us) if busy_us else None,
        "kernel_launches_per_call": sum(n for _us, n in by_name.values())
        / iters,
        "kernels_ms_per_call": {k: v[0] / iters / 1e3 for k, v in top},
        "kernels_launches_in_trace": {k: v[1] for k, v in top},
    }


def zipf_graph(seed: int = 0):
    """bench.py's arxiv-scale graph: zipf(s=1) sources, uniform dsts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, N_NODES + 1)
    src = rng.choice(N_NODES, N_EDGES, p=w / w.sum())
    dst = rng.integers(0, N_NODES, N_EDGES)
    return src, dst


def cold_bags(plan, reverse: bool = False):
    """One direction's cold edges as embedding_bag input (the forward
    shells, or with ``reverse`` the backward's): per output row, the table
    rows its shell levels gather (out-of-range slots dropped). Returns the
    indices, the offsets, the number of edges and of distinct table rows."""
    import torch

    from dgl_tpu_torch.ops.shell_prefix import BLOCK_ROWS, _rup

    flat_idx, level_rows, _levels, _res, _unrank, n_out = plan.direction(
        reverse)
    n_table = plan.num_dst if reverse else plan.num_src
    rows, cols, off = [], [], 0
    for m in level_rows:
        mm = min(m, n_out)
        idx = flat_idx[off:off + mm].long()
        r = torch.arange(mm, device=idx.device)
        keep = idx < n_table
        rows.append(r[keep])
        cols.append(idx[keep])
        off += _rup(m, BLOCK_ROWS)
    rows, cols = torch.cat(rows), torch.cat(cols)
    order = torch.sort(rows, stable=True).indices
    counts = torch.bincount(rows, minlength=n_out)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return (cols[order], offsets, int(cols.shape[0]),
            int(torch.unique(cols).shape[0]))


def kernel_bound(level_rows, n_out, n_table_rows_used, n_cold, feat,
                 has_base, rate, elem=2, slot_bytes=4, ops_per_value=1,
                 row_bytes=0):
    """Least time for one call of B1 over shells of ``level_rows`` with
    ``n_out`` output rows: the larger of bytes / HBM rate and f32
    operations / f32 rate. Bytes: each distinct table row read once
    (``elem`` bytes a value), each slot's indices read once
    (``slot_bytes``), the base read once and the output written once
    (f32). Operations: ``ops_per_value`` a cold edge and feature (B1 an
    add; its weighted caller a message op and an add, with an edge index
    and value among its slot bytes); ``row_bytes`` more a row read once
    (the weighted caller's rank). Also returns the gather-stream figure,
    which reads a table row per cold edge."""
    n_idx = sum(min(m, n_out) for m in level_rows)
    out_bytes = n_out * (feat * 4 * (2 if has_base else 1) + row_bytes)
    once = n_table_rows_used * feat * elem + n_idx * slot_bytes + out_bytes
    stream = n_cold * feat * elem + n_cold * slot_bytes + out_bytes
    bytes_ms = once / rate * 1e3
    ops_ms = ops_per_value * n_cold * feat / F32_RATE * 1e3
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), bound_by, stream / rate * 1e3


def check_b1(plan, reverse, xg, bags, rate) -> dict:
    """B1 against its plain version on one direction's shells (the
    forward's, or with ``reverse`` the backward's) of the bf16 table
    ``xg``, at rtol = atol = 1e-5 (both sum the same f32 values in the
    same order); its times, the plain version's and ``embedding_bag``'s
    over the same cold edges, and its bound."""
    import torch

    from dgl_tpu_torch.ops import hub_spmm
    from dgl_tpu_torch.ops.shell_prefix import (shell_prefix_sum,
                                                shell_prefix_sum_plain)

    flat_idx, level_rows, levels, _res, _unrank, n_out = plan.direction(
        reverse)
    bag_idx, bag_off, n_cold, rows_used = bags
    base = hub_spmm._residual_base(xg, plan, reverse)
    args = (xg, flat_idx, level_rows, n_out)
    kern = lambda: shell_prefix_sum(  # noqa: E731
        *args, base=base, levels=levels)
    got = kern()
    want = shell_prefix_sum_plain(*args, base=base)
    torch.cuda.synchronize()
    abs_err = (got - want).abs().max().item()
    rel_err = abs_err / max(want.abs().max().item(), 1e-30)
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise RuntimeError(f"B1 vs plain ({'reverse' if reverse else 'fwd'}"
                           f" shells, F={xg.shape[1]}): max abs err "
                           f"{abs_err}")
    lib = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
        bag_idx, xg, bag_off, mode="sum", include_last_offset=True)
    # the bags hold the shell levels' edges; the residual enters as base
    lib_err = (lib().float() + (0 if base is None else base[:n_out])
               - want).abs().max().item()
    bound, bound_by, stream_ms = kernel_bound(
        level_rows, n_out, rows_used, n_cold, xg.shape[1], base is not None,
        rate)
    return {
        "F": xg.shape[1], "n_out": n_out, "cold_edges": n_cold,
        "table_rows_read": rows_used, "shell_levels": len(level_rows),
        "residual": base is not None, "max_abs_err": abs_err,
        "max_rel_err": rel_err,
        "ms": time_ms(kern, 50, hide_host=True),
        "ms_with_host": time_ms(kern, 50),
        "plain_ms": time_ms(lambda: shell_prefix_sum_plain(
            *args, base=base), 10, hide_host=True),
        "library_ms": time_ms(lib, 50, hide_host=True),
        "library_max_abs_err_bf16_out": lib_err,
        "bound_ms": bound, "bound_by": bound_by,
        "gather_stream_bound_ms": stream_ms,
    }


def masked_loss(logits, y, mask):
    """The JAX package's training loss (``examples/reddit_fullgraph_gcn.py:
    61-66``): softmax cross-entropy with integer labels, averaged over the
    masked nodes."""
    import torch.nn.functional as F

    ce = F.cross_entropy(logits, y, reduction="none")
    return (ce * mask).sum() / mask.sum()


def train_step(model, opt, graph, x, y, mask):
    """One training step as user code writes it: forward, masked loss,
    backward, ``torch.optim.Adam`` step. Returns the loss (on the card)."""
    opt.zero_grad(set_to_none=True)
    loss = masked_loss(model(graph, x), y, mask)
    loss.backward()
    opt.step()
    return loss.detach()


def counted_step(model, opt, graph, x, y, mask, expect: dict, what: str):
    """The training main path: one step with the launch counts set to 0
    just before and read just after, and its peak device memory. Fails
    unless each kernel in ``expect`` launched exactly that often."""
    import torch

    from dgl_tpu_torch import _kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    loss = train_step(model, opt, graph, x, y, mask)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    for name, n in expect.items():
        if launches[name] != n:
            raise RuntimeError(f"{what} training step launched {name} "
                               f"{launches[name]} times, expected {n}")
    return loss, launches, torch.cuda.max_memory_allocated() / 2**30, step_s


def run_steps(model, opt, graph, x, y, mask, first_loss, falling: bool):
    """``TRAIN_STEPS - 1`` more steps after the counted one; the losses
    must be finite and, with ``falling``, the last below the first."""
    import torch

    losses = [first_loss] + [train_step(model, opt, graph, x, y, mask)
                             for _ in range(TRAIN_STEPS - 1)]
    losses = torch.stack(losses).tolist()
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"non-finite training loss: {losses}")
    if falling and not losses[-1] < losses[0]:
        raise RuntimeError(f"training loss did not fall: {losses}")
    return losses


def grads_of(model, graph, x, y, mask, pattern=None):
    """Every parameter's gradient of the masked loss with dropout off (of
    those that reach the loss), and
    the ReLU pattern of the pass (the models' ``torch.relu`` calls, as
    masks). Given another pass's ``pattern``, the ReLUs follow it instead
    of their own inputs' signs: the same piecewise-linear function."""
    model.eval()
    model.zero_grad(set_to_none=True)
    with relu_pattern(pattern) as seen:
        masked_loss(model(graph, x), y, mask).backward()
    # a parameter that reaches no loss (an R-GCN relation whose output
    # type the loss does not read) has no gradient
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    model.train()
    return grads, seen


@contextlib.contextmanager
def relu_pattern(pattern=None):
    """Within the block ``torch.relu`` records the masks ``t > 0`` of its
    calls in the list it yields, or, given another pass's ``pattern``,
    applies that pass's masks in their order: the same piecewise-linear
    function on the other pass's pieces, with relu's gradient."""
    import torch

    relu, seen = torch.relu, []

    def follow(t):
        m = (t > 0) if pattern is None else pattern[len(seen)]
        seen.append(m)
        return t * m  # relu(t) when m = t > 0, with relu's gradient

    torch.relu = follow
    try:
        yield seen
    finally:
        torch.relu = relu


def check_grads(model, gp, g_exact, x, y, mask, what: str,
                tol: float = 2e-2) -> dict:
    """The plan path's parameter gradients (fresh weights, dropout off)
    against the exact f32 path's, per parameter at rtol = ``tol``,
    atol = ``tol`` * max|ref| (2e-2: the plan paths round aggregated rows
    to bf16 on purpose). The exact path follows the plan path's ReLU pattern: a
    pre-activation within bf16 rounding of 0 at a node with tens of
    thousands of out-edges (a zipf hub) would otherwise swap a whole row
    of a weight's gradient, a difference of the input, not of the
    gradient. The comparison with the exact path's own pattern is reported
    beside it, and the number of ReLU outputs whose sign differs."""
    got, pattern = grads_of(model, gp, x, y, mask)
    ref, _ = grads_of(model, g_exact, x, y, mask, pattern)
    free, own = grads_of(model, g_exact, x, y, mask)
    out = {"tolerance": f"rtol={tol:g}, atol={tol:g}*max|ref| per "
                        "parameter, exact path on the plan path's ReLU "
                        "pattern",
           "max_rel_err": {}, "max_rel_err_own_relu_pattern": {},
           "relu_sign_differences": int(sum(
               (a != b).sum().item() for a, b in zip(pattern, own)))}
    for k, r in ref.items():
        scale = max(r.abs().max().item(), 1e-30)
        err = (got[k] - r).abs().max().item()
        out["max_rel_err"][k] = err / scale
        out["max_rel_err_own_relu_pattern"][k] = (
            (got[k] - free[k]).abs().max().item()
            / max(free[k].abs().max().item(), 1e-30))
        if not (got[k] - r).abs().le(tol * scale + tol * r.abs()).all():
            raise RuntimeError(f"{what}: gradient of {k} vs the exact f32 "
                               f"path: max abs err {err} (max |ref| "
                               f"{scale})")
    return out


@contextlib.contextmanager
def recording(module, name: str, keep=lambda *a, **k: True):
    """Record the arguments of the calls of ``module.name`` for which
    ``keep`` holds (the real inputs a training step hands a kernel)."""
    orig = getattr(module, name)
    calls = []

    def rec(*a, **k):
        if keep(*a, **k):
            calls.append((a, k))
        return orig(*a, **k)

    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def run_sage_training(gp, x, rate: float, tag: dict) -> dict:
    """GraphSAGE training at arxiv scale (B1 forward and, over the
    reverse shells, backward); returns B1's backward figures."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch.models import GraphSAGE
    from dgl_tpu_torch.ops import hub_spmm

    plan = gp._relation().hub_plan
    rel = gp._relation()
    g_exact = dt.graph((rel.src.cpu(), rel.dst.cpu()), num_nodes=N_NODES)
    # uniform labels from a fixed seed, as bench.py:307 draws them; every
    # node trains
    y = torch.from_numpy(np.random.default_rng(4).integers(
        0, CLASSES, N_NODES)).cuda()
    mask = torch.ones(N_NODES, device=x.device)
    model = GraphSAGE(IN_FEATS, HIDDEN, CLASSES, num_layers=LAYERS,
                      aggregator_type="mean", dropout=0.5,
                      generator=torch.Generator().manual_seed(0)).train()
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    # gradients with dropout off against the exact f32 path, recording
    # the reverse-shell calls' real tables for the kernel check
    with recording(hub_spmm, "shell_prefix_sum",
                   lambda t, idx, *a, **k: idx is plan.rev_shell_idx) as rec:
        grad_check = check_grads(model, gp, g_exact, x, y, mask, "GraphSAGE")
    del g_exact
    # 3 forward launches (one per layer) + 2 backward: layer 0 aggregates
    # the raw input, which needs no gradient; layers 1 and 2 aggregate
    # tables that do
    expect = LAYERS + (LAYERS - 1)
    loss, launches, peak, step_s = counted_step(
        model, opt, gp, x, y, mask, {"shell_prefix_sum": expect},
        "GraphSAGE")
    losses = run_steps(model, opt, gp, x, y, mask, loss, falling=False)
    emit({"phase": "sage_train_main_path", "model": "GraphSAGE 128-256-256"
          "-40, dropout 0.5", "launches": launches,
          "expected_shell_prefix_sum": expect, "peak_memory_gib": peak,
          "first_step_s": step_s, "losses": losses,
          "grads_vs_exact_f32": grad_check,
          "reverse_shells": len(plan.rev_shell_rows),
          "reverse_residual": plan.res_src is not None, **tag})
    if len(rec) != LAYERS - 1:
        raise RuntimeError(f"recorded {len(rec)} reverse-shell calls")
    bags = cold_bags(plan, reverse=True)
    bwd = {}
    for (args, _kw) in rec:
        xg = args[0]
        label = f"layer{1 if xg.shape[1] == HIDDEN else 2} bwd F={xg.shape[1]}"
        bwd[label] = check_b1(plan, True, xg, bags, rate)
        emit({"phase": "kernel_vs_plain", "kernel": "shell_prefix_sum",
              "shape": label, **bwd[label], **tag})
    del rec
    timing = {"step_ms": time_ms(
        lambda: train_step(model, opt, gp, x, y, mask), 5)}
    emit({"phase": "sage_train_timing", **timing, **tag})
    emit({"phase": "sage_train_profile", "calls": 2, **device_profile(
        lambda: train_step(model, opt, gp, x, y, mask), 2), **tag})
    return {"launches_train_step": launches["shell_prefix_sum"],
            "train_step_ms": timing["step_ms"], "backward": bwd}


# SAGEConv's other aggregators: B1 launches (forward, training step) on
# the hub-planned graph. gcn sums copy_u as mean does (3 / 5: layer 0's
# input needs no gradient); pool's max and lstm's mailbox UDF take the
# plain branch (the hub plan carries copy_u sums and means only)
SAGE_AGGS = {"gcn": (LAYERS, 2 * LAYERS - 1), "pool": (0, 0),
             "lstm": (0, 0)}
LP_K, LP_ALPHA, LP_LABELLED = 10, 0.9, 0.1  # LabelPropagation's phase


def run_sage_aggregators(gp, x, tag: dict) -> dict:
    """GraphSAGE 128-256-256-40 with the ``gcn``, ``pool`` and ``lstm``
    aggregators on the main path's graph and hub plan (phase a): one
    counted forward (eval) held against the graph without a plan, the
    gradients (dropout off) against it on the plan path's ReLU pattern,
    one counted Adam step (dropout 0.5, the labels of
    ``run_sage_training``) with its peak memory, four more with finite,
    falling losses, the forward's and step's times and profiles.
    ``gcn`` at the plan bound (rtol = 2e-2, atol = 2e-2 * max|ref|),
    ``pool`` and ``lstm`` at rtol = 1e-4, atol = 1e-4 * max|ref| (they
    run the same f32 operations on both graphs). Returns each one's
    launches."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.models import GraphSAGE

    rel = gp._relation()
    g_exact = dt.graph((rel.src.cpu(), rel.dst.cpu()), num_nodes=N_NODES)
    y = torch.from_numpy(np.random.default_rng(4).integers(
        0, CLASSES, N_NODES)).cuda()
    mask = torch.ones(N_NODES, device=x.device)
    result = {}
    for agg, (n_fwd, n_step) in SAGE_AGGS.items():
        torch.cuda.empty_cache()
        tol = 2e-2 if agg == "gcn" else 1e-4
        what = f"GraphSAGE-{agg}"
        model = GraphSAGE(IN_FEATS, HIDDEN, CLASSES, num_layers=LAYERS,
                          aggregator_type=agg, dropout=0.5,
                          generator=torch.Generator().manual_seed(0)).eval()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        with torch.inference_mode():
            out = model(gp, x)
        torch.cuda.synchronize()
        fwd_launches = dict(_kernels.launch_counts)
        fwd_peak = torch.cuda.max_memory_allocated() / 2**30
        expect_no_other_launch(fwd_launches, {"shell_prefix_sum": n_fwd},
                               f"the {what} forward")
        with torch.inference_mode():
            ref = model(g_exact, x)
        if tuple(out.shape) != (N_NODES, CLASSES) or not (
                torch.isfinite(out).all()):
            raise RuntimeError(f"{what}: bad output {tuple(out.shape)}")
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        if not torch.allclose(out, ref, rtol=tol, atol=tol * scale):
            raise RuntimeError(f"{what} vs the graph without a plan: max "
                               f"abs err {err} (max |ref| {scale})")
        del out, ref
        grad_check = check_grads(model, gp, g_exact, x, y, mask, what, tol)
        model.train()
        opt = torch.optim.Adam(model.parameters(), lr=LR)
        loss, step_launches, step_peak, step_s = counted_step(
            model, opt, gp, x, y, mask, {"shell_prefix_sum": n_step}, what)
        expect_no_other_launch(step_launches, {"shell_prefix_sum": n_step},
                               f"the {what} training step")
        losses = run_steps(model, opt, gp, x, y, mask, loss, falling=True)
        model.eval()
        with torch.inference_mode():
            fwd_ms = time_ms(lambda: model(gp, x), 3)
            fwd_prof = device_profile(lambda: model(gp, x), 2)
        model.train()
        train = lambda: train_step(model, opt, gp, x, y, mask)  # noqa: E731
        step_ms = time_ms(train, 3)
        step_prof = device_profile(train, 1)
        result[agg] = {"forward_launches": fwd_launches["shell_prefix_sum"],
                       "step_launches": step_launches["shell_prefix_sum"],
                       "forward_ms": fwd_ms, "step_ms": step_ms,
                       "forward_peak_memory_gib": fwd_peak,
                       "step_peak_memory_gib": step_peak}
        emit({"phase": "sage_aggregator", "aggregator": agg,
              "model": f"GraphSAGE 128-256-256-40 ({agg}), dropout 0.5",
              **result[agg], "forward_vs_exact_f32": {
                  "max_abs_err": err, "max_rel_err": err / scale,
                  "tolerance": f"rtol={tol:g}, atol={tol:g}*max|ref|"},
              "grads_vs_exact_f32": grad_check, "losses": losses,
              "first_step_s": step_s,
              "forward_idle_share": fwd_prof["device_idle_share"],
              "step_idle_share": step_prof["device_idle_share"], **tag})
        emit({"phase": "sage_aggregator_profile", "aggregator": agg,
              "forward": fwd_prof, "step": step_prof, **tag})
        del model, opt
    return result


def run_label_propagation(gp, tag: dict) -> dict:
    """``LabelPropagation(k=10, alpha=0.9)`` on the main path's graph and
    hub plan (phase b): the 40 class ids of ``run_sage_training``'s
    labels, 10 % of the nodes labelled (a seeded mask); one counted call
    (``k`` B1 launches at F = 40, one a hop) held against the graph
    without a plan at rtol = 2e-2, atol = 2e-2 * max|ref| (the hub path
    rounds the gathered rows to bf16), its time and profile."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.nn import LabelPropagation

    rel = gp._relation()
    g_exact = dt.graph((rel.src.cpu(), rel.dst.cpu()), num_nodes=N_NODES)
    labels = torch.from_numpy(np.random.default_rng(4).integers(
        0, CLASSES, N_NODES)).cuda()
    mask = torch.from_numpy(np.random.default_rng(5).random(N_NODES)
                            < LP_LABELLED).cuda()
    lp = LabelPropagation(k=LP_K, alpha=LP_ALPHA)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        out = lp(gp, labels, mask)
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    expect_no_other_launch(launches, {"shell_prefix_sum": LP_K},
                           "LabelPropagation")
    with torch.inference_mode():
        ref = lp(g_exact, labels, mask)
    if tuple(out.shape) != (N_NODES, CLASSES) or not torch.isfinite(
            out).all():
        raise RuntimeError(f"LabelPropagation: bad output {tuple(out.shape)}")
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    if not torch.allclose(out, ref, rtol=2e-2, atol=2e-2 * scale):
        raise RuntimeError(f"LabelPropagation vs the graph without a plan: "
                           f"max abs err {err} (max |ref| {scale})")
    with torch.inference_mode():
        ms = time_ms(lambda: lp(gp, labels, mask), 5)
        plain_ms = time_ms(lambda: lp(g_exact, labels, mask), 5)
        prof = device_profile(lambda: lp(gp, labels, mask), 2)
    result = {"launches": launches["shell_prefix_sum"], "forward_ms": ms,
              "plain_graph_forward_ms": plain_ms}
    emit({"phase": "label_propagation", "k": LP_K, "alpha": LP_ALPHA,
          "labelled": int(mask.sum().item()), **result,
          "vs_exact_f32": {"max_abs_err": err, "max_rel_err": err / scale,
                           "tolerance": "rtol=2e-2, atol=2e-2*max|ref|"},
          "profile": prof, **tag})
    return result


def run_sage(rate: float, tag: dict) -> dict:
    """The GraphSAGE path (kernel B1); returns B1's entry of the kernel
    table."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.models import GraphSAGE

    # 2. the main path, driven once with the launch counts read around it
    t0 = time.perf_counter()
    src, dst = zipf_graph(0)
    g = dt.graph((src, dst), num_nodes=N_NODES)
    gp, perm = dt.transforms.reorder_for_spmm(g, num_hubs=2048,
                                              precision="int8")
    plan = gp._relation().hub_plan
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(N_NODES, IN_FEATS)).astype(np.float32)).cuda()
    model = GraphSAGE(IN_FEATS, HIDDEN, CLASSES, num_layers=LAYERS,
                      aggregator_type="mean",
                      generator=torch.Generator().manual_seed(0)).eval()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        out = model(gp, x)
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches["shell_prefix_sum"] != LAYERS:
        raise RuntimeError(f"main path launched the kernel "
                           f"{launches['shell_prefix_sum']} times, "
                           f"expected {LAYERS} (one per layer)")
    emit({"phase": "main_path", "graph": {"nodes": N_NODES,
                                          "edges": N_EDGES},
          "hub_plan": repr(plan), "shell_levels": len(plan.shell_rows),
          "residual": plan.res_dst is not None, "setup_s": setup_s,
          "launches": launches, "peak_memory_gib": peak_gib, **tag})

    # 3. two more passes, then the exact f32 path on the same graph
    with torch.inference_mode():
        outs = [out] + [model(gp, x) for _ in range(2)]
        rel = gp._relation()
        g_ref = dt.graph((rel.src.cpu(), rel.dst.cpu()), num_nodes=N_NODES)
        ref = model(g_ref, x)
    torch.cuda.synchronize()
    for o in outs:
        if tuple(o.shape) != (N_NODES, CLASSES) or not torch.isfinite(o).all():
            raise RuntimeError(f"bad output {tuple(o.shape)}")
    repeat_err = max((o - outs[0]).abs().max().item() for o in outs[1:])
    scale = ref.abs().max().item()
    err = (outs[0] - ref).abs().max().item()
    if not torch.allclose(outs[0], ref, rtol=2e-2, atol=2e-2 * scale):
        raise RuntimeError(f"hub path vs exact f32 path: max abs err {err} "
                           f"(max |ref| {scale})")
    emit({"phase": "slice_vs_exact_f32", "max_abs_err": err,
          "max_rel_err": err / scale, "repeat_max_abs_err": repeat_err,
          "tolerance": "rtol=2e-2, atol=2e-2*max|ref|", **tag})

    # 4. kernel vs plain on the card: the three layers' real shell inputs
    # and the bench headline width
    with torch.inference_mode():
        h1 = torch.relu(model.sage0(gp, x))
        h2 = torch.relu(model.sage1(gp, h1))
        tables = {
            "layer0 F=128": x,
            "layer1 F=256": h1,
            "layer2 F=40": model.sage2.fc_neigh(h2),
            "headline F=256": torch.from_numpy(np.random.default_rng(2).normal(
                size=(N_NODES, HEADLINE_F)).astype(np.float32)).cuda(),
        }
    bags = cold_bags(plan)
    per_shape = {}
    with torch.inference_mode():
        for label, t in tables.items():
            xg = t.to(torch.bfloat16).contiguous()
            per_shape[label] = check_b1(plan, False, xg, bags, rate)
            emit({"phase": "kernel_vs_plain", "kernel": "shell_prefix_sum",
                  "shape": label, **per_shape[label], **tag})

    # 5. end-to-end times, host overhead included, and where the forward's
    # device time goes
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(gp, x), 10)
        xh = tables["headline F=256"]
        spmm_ms = time_ms(lambda: dt.ops.copy_u_sum(gp, xh), 20)
        exact_fwd_ms = time_ms(lambda: model(g_ref, x), 5)
        prof = device_profile(lambda: model(gp, x), 3)
    gbps = (N_EDGES + N_NODES) * HEADLINE_F * 4 / (spmm_ms * 1e-3) / 1e9
    emit({"phase": "timing", "forward_ms": fwd_ms,
          "exact_f32_path_forward_ms": exact_fwd_ms,
          "copy_u_sum_f256_ms": spmm_ms, "copy_u_sum_f256_effective_gbps":
          gbps, "gbps_bytes": "(E+N)*F*4", "hbm_rate_gbps": rate / 1e9,
          **tag})
    emit({"phase": "forward_profile", "calls": 3, **prof, **tag})
    del tables, outs, ref, g_ref

    # 6. training: GraphSAGE with dropout, Adam, every node labelled
    train = run_sage_training(gp, x, rate, tag)
    # 6a, 6b. the other aggregators, and label propagation, on the plan
    aggs = run_sage_aggregators(gp, x, tag)
    lp = run_label_propagation(gp, tag)

    main = per_shape["layer1 F=256"]
    bwd = train["backward"]
    return {
        "name": "shell_prefix_sum",
        "route": "cuda",
        "source": "dgl_tpu_torch/csrc/shell_prefix_sum.cu",
        "replaces": "dgl_tpu/ops/shell_pallas.py:110",
        "launches": launches["shell_prefix_sum"],
        "max_abs_err": max(v["max_abs_err"]
                           for v in list(per_shape.values())
                           + list(bwd.values())),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shape": f"layer1 F=256, n_out={N_NODES}, times per call; "
                 "launches: the inference forward",
        "launches_train_step": train["launches_train_step"],
        "sage_aggregator_launches": {
            agg: [r["forward_launches"], r["step_launches"]]
            for agg, r in aggs.items()},
        "label_propagation_launches": lp["launches"],
        "backward": {k: {f: v[f] for f in ("F", "n_out", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms", "max_abs_err")}
                     for k, v in bwd.items()},
    }


def reddit_graph(seed: int = 41):
    """The synthetic Reddit stand-in at full scale.

    The SBM recipe of ``dgl_tpu/data/synthetic.py:114-126`` (41 classes,
    homophily 0.8, seed 41) with 57,307,946 undirected pairs, put in both
    directions; self-loops removed, then one added per node, and duplicates
    removed (the dedup runs on the card). Features follow the recipe's
    gaussian mode (class centroids times 2 plus unit noise), 602 wide.
    Returns host int64 ``(src, dst)`` sorted by (dst, src), and on the card
    the f32 features, the int64 labels and the recipe's f32 train mask."""
    import numpy as np
    import torch

    n, e = REDDIT_N, REDDIT_PAIRS
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, REDDIT_CLASSES, n)
    src = rng.integers(0, n, e)
    intra = rng.random(e) < 0.8
    order = np.argsort(labels, kind="stable")
    gstart = np.searchsorted(labels[order], np.arange(REDDIT_CLASSES + 1))
    lo = gstart[labels[src]]
    width = np.maximum(gstart[labels[src] + 1] - lo, 1)
    same = order[lo + (rng.random(e) * width).astype(np.int64)]
    dst = np.where(intra, same, rng.integers(0, n, e))
    del intra, lo, width, same
    centroids = rng.normal(size=(REDDIT_CLASSES, REDDIT_FEAT)) * 2.0
    feat = (centroids[labels] + rng.normal(size=(n, REDDIT_FEAT))).astype(
        np.float32)
    # the recipe's split (synthetic.py:153-161): 60 % of the nodes train
    train_mask = np.zeros(n, np.float32)
    train_mask[rng.permutation(n)[:int(n * 0.6)]] = 1.0
    s = torch.from_numpy(src).cuda()
    d = torch.from_numpy(dst).cuda()
    flat = torch.cat([d * n + s, s * n + d])
    del s, d
    flat = flat[flat // n != flat % n]
    loops = torch.arange(n, device=flat.device, dtype=torch.int64) * (n + 1)
    flat = torch.unique(torch.cat([flat, loops]))
    out = ((flat % n).cpu().numpy(), (flat // n).cpu().numpy(),
           torch.from_numpy(feat).cuda(), torch.from_numpy(labels).cuda(),
           torch.from_numpy(train_mask).cuda())
    del flat
    torch.cuda.empty_cache()
    return out


def b3_figures(rel, heads, odim, rate) -> dict:
    """B3's bound and traffic over the relation's CSC: the bound counts every input read once (indptr, the int32 ids, el,
    er and h over the real rows) and every output written once (out, lse)
    over the HBM rate, against 2 f32 operations per edge and feature over
    the f32 rate; ``gather_gb`` is what the design moves per call, el and h
    gathered per edge and pass (mostly L2 hits), and ``ids_gb`` the ids
    read once a pass."""
    from dgl_tpu_torch.ops import bitmap_gat as tbg

    nh, nf, h_pad, o_pad = tbg._passes(heads, odim)
    passes = (h_pad // nh) * (o_pad // nf)
    E, N = rel.num_edges, rel.num_dst
    n_bytes = ((N + 1) * 4 + E * 4 + 2 * rel.num_src * heads * 4
               + rel.num_src * heads * odim * 2 + N * heads * odim * 4
               + N * heads * 4)
    bytes_ms = n_bytes / rate * 1e3
    ops_ms = 2 * E * heads * odim / F32_RATE * 1e3
    return {"nf": nf, "o_pad": o_pad, "passes": passes,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes_ms": bytes_ms, "bound_operations_ms": ops_ms,
            "gather_gb": E * passes * (nh * 4 + nh * nf * 2) / 1e9,
            "ids_gb": E * passes * 4 / 1e9}


def bitmap_bound(bits, n_rows, other_bytes, flops, rate):
    """Least time of one call over the bitmap: its first ``n_rows`` rows
    read once (the padding rows below are never read) plus ``other_bytes``
    (the other inputs read once, the outputs written once) over the HBM
    rate, against ``flops`` f32 operations over the f32 rate."""
    bytes_ms = (n_rows * bits.shape[1] + other_bytes) / rate * 1e3
    ops_ms = flops / F32_RATE * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def check_rows(n: int, count: int, seed: int = 3):
    """``count`` dst rows spread over the graph: the first and the last
    512-row tile and random rows between, sorted."""
    import numpy as np
    import torch

    edge = np.concatenate([np.arange(512), np.arange(n - 512, n)])
    rest = np.setdiff1d(np.arange(n), edge)
    mid = np.random.default_rng(seed).choice(rest, count - edge.size,
                                             replace=False)
    return torch.from_numpy(np.sort(np.concatenate([edge, mid]))).cuda()


def run_gcn_training(g, gp, feat, y, mask, rate: float, tag: dict) -> dict:
    """GCN training at Reddit scale (B2 forward and, over the transpose
    bitmap, backward); returns B2's backward figures."""
    import torch

    from dgl_tpu_torch.models import GCN
    from dgl_tpu_torch.ops import bitmap_spmm
    from dgl_tpu_torch.ops.bitmap_spmm import (bitmap_matmul,
                                               bitmap_matmul_plain)

    N, rel = REDDIT_N, gp._relation()
    E = rel.num_edges
    model = GCN(REDDIT_FEAT, GCN_HIDDEN, REDDIT_CLASSES, dropout=0.5,
                generator=torch.Generator().manual_seed(0)).train()
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    # gradients with dropout off against the exact f32 path, recording
    # B2's calls of the plan pass: two forward, then the backward's
    # (layer 1, layer 0)
    with recording(bitmap_spmm, "bitmap_matmul") as rec:
        grad_check = check_grads(model, gp, g, feat, y, mask, "GCN")
    # 2 forward launches + 2 backward over bits (the graph is symmetric)
    loss, launches, peak, step_s = counted_step(
        model, opt, gp, feat, y, mask, {"bitmap_spmm": 4}, "GCN")
    losses = run_steps(model, opt, gp, feat, y, mask, loss, falling=True)
    emit({"phase": "gcn_train_main_path", "model": "GCN 602-16-41, dropout "
          "0.5", "launches": launches, "peak_memory_gib": peak,
          "first_step_s": step_s, "losses": losses,
          "grads_vs_exact_f32": grad_check, **tag})
    if len(rec) != 4:
        raise RuntimeError(f"recorded {len(rec)} bitmap_matmul calls")
    csc = rel.csc_indptr.long(), rel.csc_indices.long()
    adj = torch.sparse_csr_tensor(csc[0], csc[1], torch.ones(
        E, device=feat.device), size=(N, N))  # symmetric: A^T = A
    bwd = {}
    for i, (args, _kw) in enumerate(rec[2:]):
        bits_t, dz, n_rows = args
        label = f"layer{1 - i} bwd F={dz.shape[1]}"
        got = bitmap_matmul(bits_t, dz, n_rows)
        want = bitmap_matmul_plain(bits_t, dz, n_rows)
        torch.cuda.synchronize()
        scale = max(want.abs().max().item(), 1e-30)
        abs_err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5 * scale):
            raise RuntimeError(f"B2 vs plain at {label}: max abs err "
                               f"{abs_err} (max |ref| {scale})")
        feat_n = dz.shape[1]
        dzf = dz.to(torch.bfloat16).float()
        bound, bound_by = bitmap_bound(
            bits_t, n_rows, N * feat_n * 2 + N * feat_n * 4, E * feat_n,
            rate)
        bwd[label] = {
            "F": feat_n, "max_abs_err": abs_err,
            "max_rel_err": abs_err / scale,
            "ms": time_ms(lambda: bitmap_matmul(bits_t, dz, n_rows), 20,
                          hide_host=True),
            "plain_ms": time_ms(lambda: bitmap_matmul_plain(
                bits_t, dz, n_rows), 2, warmup=1, hide_host=True),
            "library_ms": time_ms(lambda: torch.sparse.mm(adj, dzf), 20,
                                  hide_host=True),
            "bound_ms": bound, "bound_by": bound_by,
        }
        emit({"phase": "kernel_vs_plain", "kernel": "bitmap_spmm",
              "shape": label, "n_dst": n_rows, "edges": E,
              "tolerance": "rtol=1e-5, atol=1e-5*max|ref|",
              "library": "torch.sparse.mm(CSR adjacency, f32)",
              **bwd[label], **tag})
    del rec, adj
    step = lambda: train_step(model, opt, gp, feat, y, mask)  # noqa: E731
    timing = {"step_ms": time_ms(step, 5)}
    emit({"phase": "gcn_train_timing", **timing, **tag})
    emit({"phase": "gcn_train_profile", "calls": 2,
          **device_profile(step, 2), **tag})
    return {"launches_train_step": launches["bitmap_spmm"],
            "train_step_ms": timing["step_ms"], "backward": bwd}


def run_gat_training(gp, feat, y, mask, rate: float, ptxas: dict,
                     tag: dict) -> dict:
    """GAT training at Reddit scale (B3 forward, B4 and B5 backward);
    returns B4's and B5's figures, with ``ptxas``'s report of each and its
    occupancy beside them."""
    import torch

    from dgl_tpu_torch.models import GAT
    from dgl_tpu_torch.ops import bitmap_gat as tbg

    N, rel = REDDIT_N, gp._relation()
    E = rel.num_edges
    model = GAT(REDDIT_FEAT, GAT_HIDDEN, REDDIT_CLASSES, heads=GAT_HEADS,
                feat_drop=0.0, attn_drop=0.0,
                generator=torch.Generator().manual_seed(0)).train()
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    expect = {"bitmap_gat_fwd": 2, "bitmap_gat_bwd_dst": 2,
              "bitmap_gat_bwd_src": 2}
    loss, launches, peak, step_s = counted_step(
        model, opt, gp, feat, y, mask, expect, "GAT")
    losses = run_steps(model, opt, gp, feat, y, mask, loss, falling=True)
    emit({"phase": "gat_train_main_path", "model": "GAT 602-8x8-41, no "
          "dropout", "launches": launches, "peak_memory_gib": peak,
          "first_step_s": step_s, "losses": losses, **tag})
    # one more backward, recording B4's and B5's real inputs at both layers
    with recording(tbg, "bitmap_gat_bwd_dst") as rec_d, recording(
            tbg, "bitmap_gat_bwd_src") as rec_s:
        masked_loss(model(gp, feat), y, mask).backward()
    model.zero_grad(set_to_none=True)
    if len(rec_d) != 2 or len(rec_s) != 2:
        raise RuntimeError("expected two B4 and two B5 calls")
    rows = check_rows(N, B3_CHECK_ROWS)
    srows = check_rows(N, B3_CHECK_ROWS, seed=4)
    b4, b5 = {}, {}
    for (args_d, _), (args_s, _) in zip(rec_d, rec_s):
        bits, elp, erp, hp, slope, lse, c, dz, n_rows = args_d
        bits_t, n_src = args_s[0], args_s[8]
        heads, odim = hp.shape[1], hp.shape[2]
        label = f"layer{0 if heads == GAT_HEADS else 1} H={heads} O={odim}"
        got = tbg.bitmap_gat_bwd_dst(*args_d)
        got_del, got_dh = tbg.bitmap_gat_bwd_src(*args_s)
        plain_d = lambda: tbg.gat_bwd_dst_plain(  # noqa: E731
            bits[rows], elp, erp[rows], hp, slope, lse[rows], c[rows],
            dz[rows])
        plain_s = lambda: tbg.gat_bwd_src_plain(  # noqa: E731
            bits_t[srows], elp[srows], erp, hp[srows], slope, lse, c, dz)
        want = plain_d()
        want_del, want_dh = plain_s()
        torch.cuda.synchronize()
        errs, rel = {}, {}
        for what, a, b in (("der", got[rows], want),
                           ("del", got_del[srows], want_del),
                           ("dh", got_dh[srows], want_dh)):
            scale = max(b.abs().max().item(), 1e-30)
            errs[what] = (a - b).abs().max().item()
            rel[what] = errs[what] / scale
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-5 * scale):
                raise RuntimeError(f"B4/B5 vs plain at {label} ({what}): "
                                   f"max abs err {errs[what]} (max |ref| "
                                   f"{scale})")
        nh, nho = N * heads, N * heads * odim
        # B4 reads el, er, lse, c (f32), h and dz (bf16) and writes der; B5
        # reads el, h per source and er, lse, c, dz per destination and
        # writes del and dh
        bound_d = bitmap_bound(bits, n_rows, nh * 4 * 4 + nho * 2
                               + nho * 2 + nh * 4, E * heads * odim * 2,
                               rate)
        bound_s = bitmap_bound(bits_t, n_src, nh * 4 * 4 + nho * 2
                               + nho * 2 + nh * 4 + nho * 4,
                               E * heads * odim * 4, rate)
        common = {"H": heads, "O": odim, "library_ms": None,
                  "plain_rows": B3_CHECK_ROWS}
        compiled = {name: {"ptxas": ptxas[name][
            "nh={} nf={}".format(*tbg._passes(heads, odim)[:2])],
            **tbg.bwd_occupancy(name, heads, odim),
            "prev_ms": PREV_MS[name][label],
            "prev_ms_source": PREV_MS_SOURCE[name]}
            for name in ("bitmap_gat_bwd_dst", "bitmap_gat_bwd_src")}
        b4[label] = {**common, **compiled["bitmap_gat_bwd_dst"],
                     "max_abs_err": errs["der"],
                     "max_rel_err": rel["der"],
                     "ms": time_ms(lambda: tbg.bitmap_gat_bwd_dst(*args_d),
                                   10, hide_host=True),
                     "plain_ms": time_ms(plain_d, 2, warmup=1,
                                         hide_host=True),
                     "bound_ms": bound_d[0], "bound_by": bound_d[1]}
        b5[label] = {**common, **compiled["bitmap_gat_bwd_src"],
                     "max_abs_err": max(errs["del"], errs["dh"]),
                     "max_abs_err_del": errs["del"],
                     "max_abs_err_dh": errs["dh"],
                     "max_rel_err_del": rel["del"],
                     "max_rel_err_dh": rel["dh"],
                     "ms": time_ms(lambda: tbg.bitmap_gat_bwd_src(*args_s),
                                   10, hide_host=True),
                     "plain_ms": time_ms(plain_s, 2, warmup=1,
                                         hide_host=True),
                     "bound_ms": bound_s[0], "bound_by": bound_s[1]}
        for name, d in (("bitmap_gat_bwd_dst", b4), ("bitmap_gat_bwd_src",
                                                     b5)):
            emit({"phase": "kernel_vs_plain", "kernel": name,
                  "shape": label, "n": N, "edges": E,
                  "tolerance": "rtol=1e-4, atol=1e-5*max|ref|",
                  "plain": f"on {B3_CHECK_ROWS} rows (the first and last "
                           "512-row tiles and random rows between)",
                  "library": "none: no single PyTorch call computes a "
                             "masked rank-1-logit softmax gradient",
                  **d[label], **tag})
        del got, got_del, got_dh, want, want_del, want_dh
    del rec_d, rec_s
    step = lambda: train_step(model, opt, gp, feat, y, mask)  # noqa: E731
    timing = {"step_ms": time_ms(step, 3)}
    emit({"phase": "gat_train_timing", **timing, **tag})
    emit({"phase": "gat_train_profile", "calls": 2,
          **device_profile(step, 2), **tag})
    return {"launches": launches, "train_step_ms": timing["step_ms"],
            "b4": b4, "b5": b5}


def run_reddit(rate: float, ptxas: dict, tag: dict) -> list:
    """The Reddit-scale GCN and GAT paths (kernels B2 and B3); returns
    their entries of the kernel table."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.models import GAT, GCN
    from dgl_tpu_torch.ops import bitmap_gat as tbg
    from dgl_tpu_torch.ops.bitmap_spmm import (bitmap_matmul,
                                               bitmap_matmul_plain)

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    N = REDDIT_N

    # 7. the graph and its plans, as examples/reddit_fullgraph_gcn.py:41-42
    t0 = time.perf_counter()
    src, dst, feat, labels, train_mask = reddit_graph()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = dt.graph((src, dst), num_nodes=N)
    graph_s = time.perf_counter() - t0
    del src, dst
    t0 = time.perf_counter()
    gp = g.with_spmm_plans(num_hubs=256, bitmap=True,
                           bitmap_max_bytes=8 << 30)
    torch.cuda.synchronize()
    plans_s = time.perf_counter() - t0
    rel = gp._relation()
    plan = rel.bitmap_plan
    if plan is None or plan.bits_rev is not None:
        raise RuntimeError(f"expected one symmetric bitmap plan, got {plan}")
    E = rel.num_edges
    emit({"phase": "reddit_graph", "nodes": N, "edges": E,
          "density": E / N / N, "bitmap": repr(plan),
          "bitmap_bytes": plan.bits.numel(), "hub_plan": repr(rel.hub_plan),
          "data_s": gen_s, "graph_s": graph_s, "plans_s": plans_s,
          "setup_s": gen_s + graph_s + plans_s,
          "device_memory_gib": torch.cuda.memory_allocated() / 2**30, **tag})

    # 8. GCN(602, 16, 41): the main path, counts read around it, then the
    # exact f32 path (the graph without plans) as its reference
    gcn = GCN(REDDIT_FEAT, GCN_HIDDEN, REDDIT_CLASSES,
              generator=torch.Generator().manual_seed(0)).eval()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        out = gcn(gp, feat)
    torch.cuda.synchronize()
    gcn_launches = dict(_kernels.launch_counts)
    gcn_peak = torch.cuda.max_memory_allocated() / 2**30
    if gcn_launches["bitmap_spmm"] != 2:
        raise RuntimeError(f"GCN launched bitmap_spmm "
                           f"{gcn_launches['bitmap_spmm']} times, expected 2")
    with torch.inference_mode():
        ref = gcn(g, feat)
    torch.cuda.synchronize()
    if tuple(out.shape) != (N, REDDIT_CLASSES) or not torch.isfinite(
            out).all():
        raise RuntimeError(f"bad GCN output {tuple(out.shape)}")
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    if not torch.allclose(out, ref, rtol=2e-2, atol=2e-2 * scale):
        raise RuntimeError(f"GCN bitmap path vs exact f32 path: max abs err "
                           f"{err} (max |ref| {scale})")
    emit({"phase": "gcn_main_path", "model": "GCN 602-16-41",
          "launches": gcn_launches, "peak_memory_gib": gcn_peak,
          "max_abs_err_vs_exact_f32": err, "max_rel_err": err / scale,
          "tolerance": "rtol=2e-2, atol=2e-2*max|ref|", **tag})
    del ref

    # 9. GAT(602, 8x8, 41): the main path, counts read around it
    gat = GAT(REDDIT_FEAT, GAT_HIDDEN, REDDIT_CLASSES, heads=GAT_HEADS,
              generator=torch.Generator().manual_seed(0)).eval()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        gout = gat(gp, feat)
    torch.cuda.synchronize()
    gat_launches = dict(_kernels.launch_counts)
    gat_peak = torch.cuda.max_memory_allocated() / 2**30
    if gat_launches["bitmap_gat_fwd"] != 2:
        raise RuntimeError(f"GAT launched bitmap_gat_fwd "
                           f"{gat_launches['bitmap_gat_fwd']} times, "
                           "expected 2")
    if tuple(gout.shape) != (N, REDDIT_CLASSES) or not torch.isfinite(
            gout).all():
        raise RuntimeError(f"bad GAT output {tuple(gout.shape)}")
    emit({"phase": "gat_main_path", "model": "GAT 602-8x8-41",
          "launches": gat_launches, "peak_memory_gib": gat_peak,
          "output_max_abs": gout.abs().max().item(), **tag})

    # 10. B2 against its plain version and torch.sparse.mm on both layers'
    # real tables (F = 16 each)
    bits = plan.bits
    with torch.inference_mode():
        nrm = 1.0 / torch.sqrt(torch.clamp(gp.out_degrees().float(), min=1))
        t0_tab = (feat * nrm[:, None]) @ gcn.conv0.weight
        h1 = torch.relu(gcn.conv0(gp, feat))
        tables = {"layer0 F=16": t0_tab, "layer1 F=16": h1 * nrm[:, None]}
        csc = rel.csc_indptr.long(), rel.csc_indices.long()
        adj = torch.sparse_csr_tensor(
            csc[0], csc[1], torch.ones(E, device=feat.device), size=(N, N))
    b2 = {}
    with torch.inference_mode():
        for label, t in tables.items():
            xb = t.to(torch.bfloat16).contiguous()
            xf = xb.float()
            got = bitmap_matmul(bits, xb, N)
            want = bitmap_matmul_plain(bits, xb, N)
            torch.cuda.synchronize()
            scale = max(want.abs().max().item(), 1e-30)
            abs_err = (got - want).abs().max().item()
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-5 * scale):
                raise RuntimeError(f"B2 vs plain at {label}: max abs err "
                                   f"{abs_err} (max |ref| {scale})")
            lib_err = (torch.sparse.mm(adj, xf) - got).abs().max().item()
            feat_n = xb.shape[1]
            bound, bound_by = bitmap_bound(
                bits, N, N * feat_n * 2 + N * feat_n * 4, E * feat_n, rate)
            b2[label] = {
                "F": feat_n, "max_abs_err": abs_err,
                "max_rel_err": abs_err / scale,
                "ms": time_ms(lambda: bitmap_matmul(bits, xb, N), 20,
                              hide_host=True),
                "plain_ms": time_ms(lambda: bitmap_matmul_plain(bits, xb, N),
                                    2, warmup=1, hide_host=True),
                "library_ms": time_ms(lambda: torch.sparse.mm(adj, xf), 20,
                                      hide_host=True),
                "library_max_abs_err": lib_err,
                "bound_ms": bound, "bound_by": bound_by,
            }
            emit({"phase": "kernel_vs_plain", "kernel": "bitmap_spmm",
                  "shape": label, "n_dst": N, "edges": E,
                  "tolerance": "rtol=1e-5, atol=1e-5*max|ref|",
                  "library": "torch.sparse.mm(CSR adjacency, f32)",
                  **b2[label], **tag})
    del adj, tables, t0_tab

    # 11. B3 against its plain version on both layers' real inputs, on
    # B3_CHECK_ROWS dst rows spread over the graph; B3 walks the relation's
    # CSC, the plain version reads the bits
    rows = check_rows(N, B3_CHECK_ROWS)
    csc = rel.csc_indptr, rel.csc_indices
    b3 = {}
    with torch.inference_mode():
        h0 = gat.gat0(gp, feat)
        # each layer's input, and its output on the model's own route: the
        # main path's output for the last layer
        layers = {"layer0 H=8 O=8": (gat.gat0, feat, h0),
                  "layer1 H=1 O=41": (gat.gat1, h0.reshape(N, -1), gout)}
        for label, (conv, x_in, y) in layers.items():
            heads, odim = conv.num_heads, conv.out_feats
            hs = conv.fc(x_in).reshape(-1, heads, odim)
            el = (hs * conv.attn_l).sum(-1)
            er = (hs * conv.attn_r).sum(-1)
            hb = hs.to(torch.bfloat16)
            slope = conv.negative_slope
            got, got_lse = tbg.bitmap_gat_fwd(bits, *csc, el, er, hb, slope,
                                              N)
            want, want_lse = tbg.gat_fwd_plain(bits[rows], el, er[rows], hb,
                                               slope)
            # the layer's plain forward on the check rows: the plain
            # attention, then the layer's residual, bias and activation,
            # and at the last layer the model's mean over heads
            y_want = conv._finish(want, x_in[rows], heads, odim)
            if y.dim() == 2:
                y_want = y_want.mean(dim=1)
            torch.cuda.synchronize()
            errs = {}
            for what, a, b in (("out", got[rows], want),
                               ("lse", got_lse[rows], want_lse),
                               ("layer_output", y[rows], y_want)):
                scale = max(b.abs().max().item(), 1e-30)
                errs[what] = (a - b).abs().max().item()
                if not torch.allclose(a, b, rtol=1e-4, atol=1e-5 * scale):
                    raise RuntimeError(f"B3 vs plain at {label} ({what}): "
                                       f"max abs err {errs[what]} "
                                       f"(max |ref| {scale})")
            nh, nf = tbg._passes(heads, odim)[:2]
            b3[label] = {
                "H": heads, "O": odim, "max_abs_err": errs["out"],
                "max_abs_err_lse": errs["lse"],
                "max_abs_err_layer_output": errs["layer_output"],
                "ms": time_ms(lambda: tbg.bitmap_gat_fwd(
                    bits, *csc, el, er, hb, slope, N), 10, hide_host=True),
                # one call of about a minute at layer 0: no warm-up (the
                # check above ran it on 4,096 rows)
                "plain_ms": time_ms(lambda: tbg.gat_fwd_plain(
                    bits[:N], el, er[:N], hb, slope), 1, warmup=0,
                    hide_host=True),
                "library_ms": None,
                **b3_figures(rel, heads, odim, rate),
                "ptxas": ptxas["bitmap_gat_fwd"][f"nh={nh} nf={nf}"],
                **tbg.fwd_occupancy(heads, odim),
                "prev_ms": PREV_MS["bitmap_gat_fwd"][label],
                "prev_ms_source": PREV_MS_SOURCE["bitmap_gat_fwd"],
            }
            emit({"phase": "kernel_vs_plain", "kernel": "bitmap_gat_fwd",
                  "shape": label, "n_dst": N, "checked_rows": len(rows),
                  "input": "the relation's CSC (csc_indptr, csc_indices)",
                  "tolerance": "rtol=1e-4, atol=1e-5*max|ref|",
                  "library": "none: no single PyTorch call computes a "
                             "masked rank-1-logit softmax aggregation",
                  **b3[label], **tag})
            del hs, el, er, hb, got, got_lse, y_want
        del layers, h0

    # 12. both forwards as a caller waits for them, and where their device
    # time goes
    with torch.inference_mode():
        timing = {
            "gcn_forward_ms": time_ms(lambda: gcn(gp, feat), 5),
            "gat_forward_ms": time_ms(lambda: gat(gp, feat), 3),
            "gcn_exact_f32_path_forward_ms": time_ms(lambda: gcn(g, feat), 2),
        }
        emit({"phase": "reddit_timing", **timing, **tag})
        emit({"phase": "gcn_forward_profile", "calls": 3,
              **device_profile(lambda: gcn(gp, feat), 3), **tag})
        emit({"phase": "gat_forward_profile", "calls": 2,
              **device_profile(lambda: gat(gp, feat), 2), **tag})
    del gcn, gat, gout, out

    # 13-14. training: GCN (dropout 0.5) and GAT, Adam, masked loss over
    # the recipe's train split
    gcn_train = run_gcn_training(g, gp, feat, labels, train_mask, rate, tag)
    gat_train = run_gat_training(gp, feat, labels, train_mask, rate, ptxas,
                                 tag)

    m2, m3 = b2["layer0 F=16"], b3["layer0 H=8 O=8"]
    b4, b5 = gat_train["b4"], gat_train["b5"]
    return [{
        "name": "bitmap_spmm",
        "route": "cuda",
        "source": "dgl_tpu_torch/csrc/bitmap_spmm.cu",
        "replaces": "dgl_tpu/ops/bitmap_spmm.py:201",
        "launches": gcn_launches["bitmap_spmm"],
        "max_abs_err": max(v["max_abs_err"] for v in b2.values()),
        "ms": m2["ms"],
        "plain_ms": m2["plain_ms"],
        "bound_ms": m2["bound_ms"],
        "bound_by": m2["bound_by"],
        "library_ms": m2["library_ms"],
        "shape": f"GCN layer0 F=16, n_dst={N}, E={E}, times per call; "
                 "launches: the inference forward",
        "launches_train_step": gcn_train["launches_train_step"],
        "backward": {k: {f: v[f] for f in ("F", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms",
                                             "max_abs_err")}
                     for k, v in gcn_train["backward"].items()},
    }, {
        "name": "bitmap_gat_fwd",
        "route": "cuda",
        "source": "dgl_tpu_torch/csrc/bitmap_gat_fwd.cu",
        "replaces": "dgl_tpu/ops/bitmap_gat.py:121",
        "launches": gat_launches["bitmap_gat_fwd"],
        "max_abs_err": max(v["max_abs_err"] for v in b3.values()),
        "ms": m3["ms"],
        "plain_ms": m3["plain_ms"],
        "bound_ms": m3["bound_ms"],
        "bound_by": m3["bound_by"],
        "library_ms": None,
        "input": "the relation's CSC (csc_indptr, csc_indices), walked a "
                 "dst row a warp; the bitmap is not read",
        "shape": f"GAT layer0 H=8 O=8, n_dst={N}, E={E}, times per call; "
                 "layer1 H=1 O=41 in one pass of 64 features; launches: "
                 "the inference forward",
        "layer1": {k: b3["layer1 H=1 O=41"][k]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "max_abs_err")},
        "launches_train_step": gat_train["launches"]["bitmap_gat_fwd"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"dgl_tpu_torch/csrc/{name}.cu",
        "replaces": f"dgl_tpu/ops/bitmap_gat.py:{line}",
        "launches": gat_train["launches"][name],
        "max_abs_err": max(v["max_abs_err"] for v in d.values()),
        "ms": d["layer0 H=8 O=8"]["ms"],
        "plain_ms": d["layer0 H=8 O=8"]["plain_ms"],
        "bound_ms": d["layer0 H=8 O=8"]["bound_ms"],
        "bound_by": d["layer0 H=8 O=8"]["bound_by"],
        "library_ms": None,
        "shape": f"GAT layer0 H=8 O=8, n={N}, E={E}, times per call; "
                 f"layer1 H=1 O=41: {d['layer1 H=1 O=41']['ms']} ms; "
                 f"plain_ms on {B3_CHECK_ROWS} rows; launches: one GAT "
                 "training step",
    } for name, line, d in (("bitmap_gat_bwd_dst", 226, b4),
                            ("bitmap_gat_bwd_src", 298, b5))]


def expect_no_other_launch(launches: dict, allowed: dict, what: str):
    """Fail unless the kernels in ``allowed`` launched exactly that often
    and every other kernel not at all."""
    for name, n in launches.items():
        if n != allowed.get(name, 0):
            raise RuntimeError(f"{what} launched {name} {n} times, expected "
                               f"{allowed.get(name, 0)}")


def run_hub_cache(rate: float, tag: dict) -> dict:
    """The hub-cache path (kernel B6); returns B6's entry of the kernel
    table."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.ops.hub_cache import (HubPlan, _hub_gather_plain,
                                             hub_copy_u_sum, hub_gather)

    # 15. the zipf graph without a plan, bench_hub.py's hub split and table
    src, dst = zipf_graph(0)
    g = dt.graph((src, dst), num_nodes=N_NODES)
    gp, _perm = dt.transforms.reorder_for_spmm(g, num_hubs=2048,
                                               precision="int8")
    rel = g._relation()
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(N_NODES, HUB_FEAT)).astype(np.float32)).cuda()
    t0 = time.perf_counter()
    plan = HubPlan.build(rel, HUB_HUBS)
    torch.cuda.synchronize()
    emit({"phase": "hub_cache_plan", "num_hubs": plan.num_hubs,
          "coverage": plan.coverage, "slots": plan.slots.shape[0],
          "cold_edges_padded": plan.cold_src.shape[0],
          "plan_s": time.perf_counter() - t0, **tag})
    with torch.inference_mode():
        ref = dt.ops.copy_u_sum(g, x)
        scale = ref.abs().max().item()
        launches, errs = {}, {}
        for precision in ("highest", "bf16"):
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            out = hub_copy_u_sum(rel, x, plan=plan, precision=precision)
            torch.cuda.synchronize()
            launches[precision] = dict(_kernels.launch_counts)
            expect_no_other_launch(launches[precision], {"hub_gather": 1},
                                   f"hub_copy_u_sum({precision})")
            if tuple(out.shape) != (N_NODES, HUB_FEAT) or not torch.isfinite(
                    out).all():
                raise RuntimeError(f"bad hub_copy_u_sum output "
                                   f"{tuple(out.shape)}")
            errs[precision] = (out - ref).abs().max().item()
            ok = (torch.allclose(out, ref, rtol=2e-4, atol=2e-4 * scale)
                  if precision == "highest"
                  else errs[precision] <= 2e-2 * scale)
            if not ok:
                raise RuntimeError(f"hub_copy_u_sum({precision}) vs "
                                   f"copy_u_sum: max abs err "
                                   f"{errs[precision]} (max |ref| {scale})")
            emit({"phase": "hub_cache_main_path", "precision": precision,
                  "launches": launches[precision],
                  "max_abs_err_vs_exact_f32": errs[precision],
                  "max_rel_err": errs[precision] / scale,
                  "tolerance": "rtol=2e-4, atol=2e-4*max|ref|"
                               if precision == "highest"
                               else "max abs err <= 2e-2*max|ref|", **tag})
            del out

        # 16. B6 against its plain version on the path's real table and
        # slots, times, bound, and the SpMM as a caller waits for it
        hub_x = x.index_select(0, plan.hub_ids)
        slots = plan.slots
        flat = slots.reshape(-1)
        table_z = torch.cat([hub_x, hub_x.new_zeros((1, HUB_FEAT))])
        E_pad, H = slots.shape[0], plan.num_hubs
        # the (E, F) output written once, the slots and the table read once
        bytes_ms = (E_pad * HUB_FEAT * 4 + E_pad * 4 + H * HUB_FEAT * 4) \
            / rate * 1e3
        b6 = {}
        for precision in ("highest", "bf16"):
            kern = lambda: hub_gather(  # noqa: E731
                hub_x, slots, precision=precision)
            got = kern()
            want = _hub_gather_plain(hub_x, slots, precision)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not torch.equal(got, want):
                raise RuntimeError(f"B6 vs plain ({precision}): max abs err "
                                   f"{err}, expected 0.0")
            lib = lambda: torch.nn.functional.embedding(  # noqa: E731
                flat, table_z)
            lib_err = (lib() - got).abs().max().item()
            b6[precision] = {
                "H": H, "F": HUB_FEAT, "E_padded": E_pad,
                "max_abs_err": err,
                "ms": time_ms(kern, 20, hide_host=True),
                "plain_ms": time_ms(lambda: _hub_gather_plain(
                    hub_x, slots, precision), 10, hide_host=True),
                "library_ms": time_ms(lib, 20, hide_host=True),
                "library_max_abs_err": lib_err,
                # a selection does no arithmetic (the bf16 rounding is one
                # conversion per value): bytes bound it
                "bound_ms": bytes_ms, "bound_by": "bytes",
            }
            emit({"phase": "kernel_vs_plain", "kernel": "hub_gather",
                  "precision": precision, "tolerance": "exact (0.0)",
                  "library": "torch.nn.functional.embedding over the table "
                             "with a zero row appended",
                  **b6[precision], **tag})
            del got, want
        timing = {
            "hub_copy_u_sum_ms": time_ms(lambda: hub_copy_u_sum(
                rel, x, plan=plan), 10),
            "hub_copy_u_sum_bf16_ms": time_ms(lambda: hub_copy_u_sum(
                rel, x, plan=plan, precision="bf16"), 10),
            "copy_u_sum_plain_ms": time_ms(lambda: dt.ops.copy_u_sum(g, x),
                                           10),
            "copy_u_sum_reorder_for_spmm_hub_path_ms": time_ms(
                lambda: dt.ops.copy_u_sum(gp, x), 10),
        }
        emit({"phase": "hub_cache_timing", "F": HUB_FEAT, **timing, **tag})
        emit({"phase": "hub_cache_profile", "calls": 3, **device_profile(
            lambda: hub_copy_u_sum(rel, x, plan=plan), 3), **tag})
    m = b6["highest"]
    return {
        "name": "hub_gather",
        "route": "cuda",
        "source": "dgl_tpu_torch/csrc/hub_gather.cu",
        "replaces": "dgl_tpu/ops/pallas_hub.py:112",
        "launches": launches["highest"]["hub_gather"],
        "max_abs_err": max(v["max_abs_err"] for v in b6.values()),
        "ms": m["ms"],
        "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"],
        "library_ms": m["library_ms"],
        "shape": f"hub_x ({H}, {HUB_FEAT}) f32, slots ({E_pad}, 1), "
                 f"precision highest, times per call; bf16: "
                 f"{b6['bf16']['ms']} ms; launches: one hub_copy_u_sum call",
        "launches_bf16": launches["bf16"]["hub_gather"],
        "hub_copy_u_sum_ms": timing["hub_copy_u_sum_ms"],
    }


def run_gat_edge(tag: dict) -> dict:
    """GAT over the per-edge route at ogbn-arxiv widths, inference and
    training; no hand kernel may launch."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.models import GAT

    # 17. the zipf graph plus one self-loop per node, no plan
    t0 = time.perf_counter()
    g = dt.graph(zipf_loops_graph(), num_nodes=N_NODES)
    rel = g._relation()
    if rel.hub_plan is not None or rel.bitmap_plan is not None:
        raise RuntimeError("the per-edge GAT graph carries a plan")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(N_NODES, IN_FEATS)).astype(np.float32)).cuda()
    y = torch.from_numpy(np.random.default_rng(4).integers(
        0, CLASSES, N_NODES)).cuda()
    mask = torch.ones(N_NODES, device=x.device)
    model = GAT(IN_FEATS, EDGE_GAT_HIDDEN, CLASSES, heads=EDGE_GAT_HEADS,
                num_layers=LAYERS, feat_drop=0.75, attn_drop=0.05,
                generator=torch.Generator().manual_seed(0)).eval()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        out = model(g, x)
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    expect_no_other_launch(launches, {}, "the per-edge GAT forward")
    if tuple(out.shape) != (N_NODES, CLASSES) or not torch.isfinite(
            out).all():
        raise RuntimeError(f"bad per-edge GAT output {tuple(out.shape)}")
    emit({"phase": "gat_edge_main_path", "model": "GAT 128-250x3-250x3-40, "
          "3 layers, per-edge route", "nodes": N_NODES,
          "edges": rel.num_edges, "launches": launches,
          "peak_memory_gib": peak, "setup_s": setup_s, **tag})

    # the same model on the CPU as the reference
    t0 = time.perf_counter()
    model_cpu = GAT(IN_FEATS, EDGE_GAT_HIDDEN, CLASSES, heads=EDGE_GAT_HEADS,
                    num_layers=LAYERS, device="cpu").eval()
    model_cpu.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    with torch.inference_mode():
        ref = model_cpu(g.to("cpu"), x.cpu())
    scale = ref.abs().max().item()
    err = (out.cpu() - ref).abs().max().item()
    if not torch.allclose(out.cpu(), ref, rtol=1e-4, atol=1e-4 * scale):
        raise RuntimeError(f"per-edge GAT on the card vs the CPU: max abs "
                           f"err {err} (max |ref| {scale})")
    emit({"phase": "gat_edge_vs_cpu", "max_abs_err": err,
          "max_rel_err": err / scale, "cpu_forward_s":
          time.perf_counter() - t0,
          "tolerance": "rtol=1e-4, atol=1e-4*max|ref|", **tag})
    del model_cpu, ref, out
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(g, x), 5)
        prof = device_profile(lambda: model(g, x), 2)
    emit({"phase": "gat_edge_timing", "forward_ms": fwd_ms, **tag})
    emit({"phase": "gat_edge_forward_profile", "calls": 2, **prof, **tag})

    # 18. training: both dropouts, Adam, every node labelled
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    loss, launches, peak, step_s = counted_step(
        model, opt, g, x, y, mask, {k: 0 for k in _kernels.launch_counts},
        "per-edge GAT")
    losses = run_steps(model, opt, g, x, y, mask, loss, falling=False)
    emit({"phase": "gat_edge_train_main_path", "model": "GAT 128-250x3-"
          "250x3-40, feat_drop 0.75, attn_drop 0.05", "launches": launches,
          "peak_memory_gib": peak, "first_step_s": step_s, "losses": losses,
          **tag})
    step = lambda: train_step(model, opt, g, x, y, mask)  # noqa: E731
    timing = {"step_ms": time_ms(step, 3)}
    emit({"phase": "gat_edge_train_timing", **timing, **tag})
    emit({"phase": "gat_edge_train_profile", "calls": 2,
          **device_profile(step, 2), **tag})
    return {"forward_ms": fwd_ms, "train_step_ms": timing["step_ms"],
            "peak_memory_gib": peak}


def edge_case_plan():
    """The bitmap of B4's and B5's edge cases, built on the card: random
    edges with empty rows both ways (destinations 1000..1099 receive
    nothing, sources 20000..20099 send nothing), a full dst row 7 (25,901
    bits, 4,096 in each full block: more than the walk's 256-entry queue,
    so each block goes in rounds) and a full source row 9 (1,201 bits).
    7 blocks a dst row is not a whole number of the walk's 2-block loads,
    and neither row count is a multiple of a thread block's 8 rows."""
    import numpy as np

    import dgl_tpu_torch as dt
    from dgl_tpu_torch.ops.bitmap_spmm import build_bitmap_plan

    rng = np.random.default_rng(17)
    src = rng.integers(0, EDGE_N_SRC, 40000)
    dst = rng.integers(0, EDGE_N_DST, 40000)
    keep = (((dst < 1000) | (dst >= 1100))
            & ((src < 20000) | (src >= 20100)))
    all_src = np.setdiff1d(np.arange(EDGE_N_SRC), np.arange(20000, 20100))
    all_dst = np.setdiff1d(np.arange(EDGE_N_DST), np.arange(1000, 1100))
    src = np.concatenate([src[keep], all_src, np.full(all_dst.size, 9)])
    dst = np.concatenate([dst[keep], np.full(all_src.size, 7), all_dst])
    flat = np.unique(dst.astype(np.int64) * EDGE_N_SRC + src)
    rel = dt.Relation.from_coo(flat % EDGE_N_SRC, flat // EDGE_N_SRC,
                               EDGE_N_SRC, EDGE_N_DST)
    return build_bitmap_plan(rel)


def run_bwd_edge_cases(tag: dict) -> None:
    """B4 and B5 at the edges of their walk (``edge_case_plan``), every
    (nh, nf) case of their switch, against their plain versions at
    rtol = 1e-4, atol = 1e-5 * max|ref| (B3's tolerance); rows without an
    edge must get exact zeros. Raises on any mismatch."""
    import numpy as np
    import torch

    from dgl_tpu_torch.ops import bitmap_gat as tbg

    plan = edge_case_plan()
    bits, bits_t = plan.bits, plan.bits_rev
    deg_dst = tbg._expand_bits(bits[:EDGE_N_DST])[:, :EDGE_N_SRC].sum(1)
    deg_src = tbg._expand_bits(bits_t[:EDGE_N_SRC])[:, :EDGE_N_DST].sum(1)
    if (int(deg_dst[7]) != EDGE_N_SRC - 100 or int(deg_src[9]) != EDGE_N_DST
            - 100 or int((deg_dst == 0).sum()) != 100
            or int((deg_src == 0).sum()) != 100):
        raise RuntimeError("the edge-case bitmap lacks its full or empty rows")
    covered = {tbg._passes(h, o)[:2] for h, o in EDGE_CASES}
    if covered != SWITCH_CASES:
        raise RuntimeError(f"edge cases cover {sorted(covered)}")
    cases = {}
    for heads, odim in EDGE_CASES:
        rng = np.random.default_rng(heads * 10 + odim)
        t = lambda *sh: torch.from_numpy(  # noqa: E731
            rng.normal(size=sh).astype(np.float32)).cuda()
        el, er = t(EDGE_N_SRC, heads), t(EDGE_N_DST, heads)
        h = t(EDGE_N_SRC, heads, odim).to(torch.bfloat16)
        out, lse = tbg.gat_fwd_plain(bits[:EDGE_N_DST], el, er, h, 0.2)
        dzf = t(EDGE_N_DST, heads, odim)
        c, dz = (out * dzf).sum(-1), dzf.to(torch.bfloat16)
        der = tbg.bitmap_gat_bwd_dst(bits, el, er, h, 0.2, lse, c, dz,
                                     EDGE_N_DST)
        dele, dh = tbg.bitmap_gat_bwd_src(bits_t, el, er, h, 0.2, lse, c, dz,
                                          EDGE_N_SRC)
        want = (tbg.gat_bwd_dst_plain(bits[:EDGE_N_DST], el, er, h, 0.2, lse,
                                      c, dz),
                *tbg.gat_bwd_src_plain(bits_t[:EDGE_N_SRC], el, er, h, 0.2,
                                       lse, c, dz))
        torch.cuda.synchronize()
        label = f"H={heads} O={odim}"
        errs = {}
        for what, a, b in zip(("der", "del", "dh"), (der, dele, dh), want):
            scale = max(b.abs().max().item(), 1e-30)
            errs[what] = (a - b).abs().max().item()
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-5 * scale):
                raise RuntimeError(f"B4/B5 edge case {label} ({what}): max "
                                   f"abs err {errs[what]} (max |ref| "
                                   f"{scale})")
        if (der[deg_dst == 0].any() or dele[deg_src == 0].any()
                or dh[deg_src == 0].any()):
            raise RuntimeError(f"B4/B5 edge case {label}: a row without an "
                               "edge got a gradient")
        nh, nf = tbg._passes(heads, odim)[:2]
        cases[label] = {"nh": nh, "nf": nf, "max_abs_err": errs}
    emit({"phase": "bitmap_gat_bwd_edge_cases", "bitmap": repr(plan),
          "full_rows_bits": {"dst 7": int(deg_dst[7]),
                             "source 9": int(deg_src[9])},
          "empty_rows": {"dst": 100, "source": 100},
          "tolerance": "rtol=1e-4, atol=1e-5*max|ref|", "cases": cases,
          **tag})


def fwd_edge_case_csc(device="cuda"):
    """The graph of B3's edge cases (``tests/test_torch_gpu.py`` holds B3 to
    the same ones): the rows 0..16 have the in-degrees FWD_DEGREES, rows
    1000..1099 none, the others 0..40 random ones; and its CSC with sink
    indices (``FWD_N_SRC``, a padded edge) added: one in the middle of rows
    20..24, a sink alone in row 25 (which has no real edge), 40 after the
    33 real ones of row 26. Returns the bitmap plan of the real edges, the
    CSC with sinks (int32) and the real in-degrees, all on ``device``."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch.ops.bitmap_spmm import build_bitmap_plan

    rng = np.random.default_rng(23)
    deg = rng.integers(0, 41, FWD_N_DST)
    deg[:len(FWD_DEGREES)] = FWD_DEGREES
    deg[1000:1100] = 0
    deg[25], deg[26] = 0, 33
    lists = [np.sort(rng.choice(FWD_N_SRC, d, replace=False)) for d in deg]
    src = np.concatenate(lists)
    dst = np.repeat(np.arange(FWD_N_DST), deg)
    plan = build_bitmap_plan(dt.Relation.from_coo(src, dst, FWD_N_SRC,
                                                  FWD_N_DST, device=device))
    for d in range(20, 25):
        lists[d] = np.insert(lists[d], len(lists[d]) // 2, FWD_N_SRC)
    lists[25] = np.array([FWD_N_SRC])
    lists[26] = np.concatenate([lists[26], np.full(40, FWD_N_SRC)])
    indptr = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
    csc = tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                for a in (indptr, np.concatenate(lists)))
    return plan, csc, torch.from_numpy(deg).to(device)


def run_fwd_edge_cases(tag: dict) -> None:
    """B3 at the edges of its CSC walk (``fwd_edge_case_csc``), every case
    of its switch, against its plain version over the bits at rtol = 1e-4,
    atol = 1e-5 * max|ref|: rows without a real edge must get out = 0
    exactly and lse = log(1e-30), sink indices must be skipped. Raises on
    any mismatch."""
    import numpy as np
    import torch

    from dgl_tpu_torch.ops import bitmap_gat as tbg

    plan, csc, deg = fwd_edge_case_csc()
    bits = plan.bits
    got_deg = tbg._expand_bits(bits[:FWD_N_DST])[:, :FWD_N_SRC].sum(1)
    if not torch.equal(got_deg.long(), deg.long()):
        raise RuntimeError("the edge-case bitmap lacks its rows")
    covered = {tbg._passes(h, o)[:2] for h, o in FWD_CASES}
    if covered != SWITCH_CASES:
        raise RuntimeError(f"B3 edge cases cover {sorted(covered)}")
    empty = deg == 0
    cases = {}
    for heads, odim in FWD_CASES:
        rng = np.random.default_rng(heads * 100 + odim)
        t = lambda *sh: torch.from_numpy(  # noqa: E731
            rng.normal(size=sh).astype(np.float32)).cuda()
        el, er = t(FWD_N_SRC, heads), t(FWD_N_DST, heads)
        h = t(FWD_N_SRC, heads, odim).to(torch.bfloat16)
        out, lse = tbg.bitmap_gat_fwd(bits, *csc, el, er, h, 0.2, FWD_N_DST)
        want = tbg.gat_fwd_plain(bits[:FWD_N_DST], el, er, h, 0.2)
        torch.cuda.synchronize()
        label = f"H={heads} O={odim} nf={tbg._passes(heads, odim)[1]}"
        errs = {}
        for what, a, b in zip(("out", "lse"), (out, lse), want):
            scale = max(b.abs().max().item(), 1e-30)
            errs[what] = (a - b).abs().max().item()
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-5 * scale):
                raise RuntimeError(f"B3 edge case {label} ({what}): max abs "
                                   f"err {errs[what]} (max |ref| {scale})")
        if out[empty].any() or not torch.all(
                lse[empty] == float(np.log(np.float32(1e-30)))):
            raise RuntimeError(f"B3 edge case {label}: a row without an "
                               "edge got a value")
        cases[label] = {"max_abs_err": errs}
    emit({"phase": "bitmap_gat_fwd_edge_cases", "bitmap": repr(plan),
          "degrees": list(FWD_DEGREES), "empty_rows": int(empty.sum()),
          "sink_indices": {"rows 20..24": 1, "row 25 (alone)": 1,
                           "row 26": 40},
          "tolerance": "rtol=1e-4, atol=1e-5*max|ref|", "cases": cases,
          **tag})


def minibatch_data(device):
    """The zipf graph on ``device`` with bench.py's minibatch features
    (N, 100) f32 and labels uniform in [0, 47), from seeded numpy
    generators."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt

    g = dt.graph(zipf_graph(0), num_nodes=N_NODES, device=device)
    rng = np.random.default_rng(5)
    feats = torch.from_numpy(rng.normal(size=(N_NODES, MB_FEAT)).astype(
        np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, MB_CLASSES, N_NODES)).to(device)
    return g, feats, labels


def block_loss(model, blocks, feats, labels):
    """``sage_minibatch``'s loss (bench.py:454-466): gather the input
    frontier's features (padding rows zeroed), forward over the blocks,
    cross-entropy over the real output slots; returns it and the
    logits."""
    import torch

    from dgl_tpu_torch.base import NID

    x = feats[blocks[0].srcdata[NID]] * blocks[0].srcdata["_mask"][:, None]
    logits = model(blocks, x)
    return masked_loss(logits, labels[blocks[-1].dstdata[NID]],
                       blocks[-1].dstdata["_mask"].to(torch.float32)), logits


def run_sage_minibatch(data, tag: dict, device="cuda") -> dict:
    """19. bench.py's ``sage_minibatch`` (bench.py:388-495): fixed-shape
    blocks sampled on the host, reused, and the training step on the
    card; no hand kernel may launch."""
    import statistics

    import numpy as np
    import torch

    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.dataloading import FixedShapeNeighborSampler
    from dgl_tpu_torch.models import GraphSAGE

    t_phase = time.perf_counter()
    g, feats, labels = data
    seeds = np.random.default_rng(6).permutation(N_NODES)[
        :MB_BATCHES * MB_BATCH].reshape(MB_BATCHES, MB_BATCH)
    # the host library's build and the relation's int64 CSC, once
    t0 = time.perf_counter()
    FixedShapeNeighborSampler(MB_FANOUTS, MB_BATCH, seed=1,
                              device=device).sample_blocks(g, seeds[0])
    first_sample_s = time.perf_counter() - t0
    sampler = FixedShapeNeighborSampler(MB_FANOUTS, MB_BATCH, seed=0,
                                        device=device)
    batches, sample_s = [], []
    for s in range(MB_BATCHES):
        t0 = time.perf_counter()
        batches.append(sampler.sample_blocks(g, seeds[s])[2])
        sample_s.append(time.perf_counter() - t0)
    real_edges = sum(int(b.edata["_mask"].sum()) for bl in batches
                     for b in bl)
    model = GraphSAGE(MB_FEAT, MB_HIDDEN, MB_CLASSES, num_layers=2,
                      dropout=0.0, generator=torch.Generator().manual_seed(0),
                      device=device)

    # one step on the card against the same step on the CPU
    model_cpu = GraphSAGE(MB_FEAT, MB_HIDDEN, MB_CLASSES, num_layers=2,
                          dropout=0.0, device="cpu")
    model_cpu.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    got = block_loss(model, batches[0], feats, labels)
    ref = block_loss(model_cpu, [b.to("cpu") for b in batches[0]],
                     feats.cpu(), labels.cpu())
    for loss, _logits in (got, ref):
        loss.backward()
    pairs = [("loss", got[0], ref[0]), ("logits", got[1], ref[1])] + [
        (k, p.grad, q.grad) for (k, p), q in zip(model.named_parameters(),
                                                 model_cpu.parameters())]
    errs = {}
    for name, a, b in pairs:
        a, b = a.detach().cpu(), b.detach()
        scale = b.abs().max().item()
        errs[name] = (a - b).abs().max().item()
        if not torch.allclose(a, b, rtol=1e-4, atol=1e-5 * scale):
            raise RuntimeError(f"minibatch step on the card vs the CPU: "
                               f"{name} max abs err {errs[name]} (max |ref| "
                               f"{scale})")
    emit({"phase": "sage_minibatch_vs_cpu", "max_abs_err": errs,
          "tolerance": "rtol=1e-4, atol=1e-5*max|ref|", **tag})
    del model_cpu

    # the main path: an epoch of S steps with the launch counts read
    # around it
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    with torch.no_grad():
        first_loss = block_loss(model, batches[0], feats, labels)[0]

    def epoch():
        for blocks in batches:
            opt.zero_grad(set_to_none=True)
            block_loss(model, blocks, feats, labels)[0].backward()
            opt.step()

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    epoch()
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    expect_no_other_launch(launches, {}, "the sage_minibatch epoch")
    emit({"phase": "sage_minibatch_main_path",
          "model": f"GraphSAGE {MB_FEAT}-{MB_HIDDEN}-{MB_CLASSES}, 2 layers "
                   f"over blocks", "launches": launches,
          "first_sample_s": first_sample_s, **tag})

    # bench.py's timing: runs of k epochs after a warm one
    epoch()
    runs = []
    for _ in range(MB_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MB_EPOCHS):
            epoch()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    med = statistics.median(runs)
    prof = device_profile(epoch, 2)
    with torch.no_grad():
        last_loss = block_loss(model, batches[0], feats, labels)[0]
    losses = [first_loss.item(), last_loss.item()]
    if not all(map(math.isfinite, losses)) or not losses[1] < losses[0]:
        raise RuntimeError(f"sage_minibatch: the first batch's loss before "
                           f"and after training: {losses}")
    result = {
        "config": f"B={MB_BATCH} fanouts={MB_FANOUTS} feat={MB_FEAT} "
                  f"hid={MB_HIDDEN}",
        "ms_per_step": med / (MB_EPOCHS * MB_BATCHES) * 1e3,
        "edges_per_s": real_edges * MB_EPOCHS / med,
        "run_spread": (max(runs) - min(runs)) / med,
        "sample_ms": statistics.mean(sample_s) * 1e3,
        "device_idle_share": prof["device_idle_share"],
        "device_busy_ms_per_step": prof["device_busy_ms_per_call"]
        / MB_BATCHES,
        "wall_ms_per_step_profiled": prof["wall_ms_per_call"] / MB_BATCHES,
        "real_edges_per_epoch": real_edges, "loss_first_batch": losses,
        "phase_s": time.perf_counter() - t_phase}
    emit({"phase": "sage_minibatch", **result, **tag})
    emit({"phase": "sage_minibatch_profile", "calls": "2 epochs of "
          f"{MB_BATCHES} steps", **prof, **tag})
    return result


def check_device_picks(mfg, indptr, indices, fanouts) -> int:
    """On the card: every unmasked pick is an in-neighbour of its frontier
    node; a live row of in-degree at most the fanout takes all its
    neighbours in CSC order; masks are 0 past the degree and under a
    masked node. Returns the masked seeds' count."""
    import torch

    n, e = indptr.shape[0] - 1, indices.shape[0]
    deg_all = (indptr[1:] - indptr[:-1]).long()
    dst = torch.repeat_interleave(torch.arange(n, device=indptr.device),
                                  deg_all)
    keys = torch.sort(dst * n + indices.long()).values
    live = mfg.seed_mask
    for depth, fanout in enumerate(reversed(fanouts)):
        front = mfg.frontiers[depth].long()
        nbr, m = mfg.nbrs[depth].long(), mfg.masks[depth]
        q = (front[:, None] * n + nbr)[m]
        hit = keys[torch.searchsorted(keys, q).clamp(max=e - 1)] == q
        start = indptr[front].long()
        deg = indptr[front + 1].long() - start
        j = torch.arange(fanout, device=m.device)[None, :]
        inside = j < deg[:, None]
        small = (deg <= fanout) & live
        want = indices[(start[:, None] + j).clamp(max=e - 1)].long()
        bad = {
            "pick not an in-neighbour": int((~hit).sum()),
            "mask past the degree": int((m & ~inside).sum()),
            "mask under a masked node": int((m & ~live[:, None]).sum()),
            "take-all row missing a slot": int(
                (small[:, None] & inside & ~m).sum()),
            "take-all row out of order": int(
                (small[:, None] & inside & (nbr != want)).sum()),
        }
        if any(bad.values()):
            raise RuntimeError(f"device sampler, depth {depth}: {bad}")
        live = torch.cat([live, m.reshape(-1)])
    return int((~mfg.seed_mask).sum())


def run_sage_end_to_end(data, tag: dict, device="cuda") -> dict:
    """20. bench.py's ``sage_minibatch_end_to_end`` (bench.py:286-385):
    each epoch shuffles its seeds on the card, and every step samples on
    the card, gathers the features and takes an Adam step, eagerly, with
    no host sync inside an epoch; no hand kernel may launch."""
    import torch

    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.models import DeviceSAGE
    from dgl_tpu_torch.sampling import (DeviceNeighborSampler,
                                        device_seed_batches)

    t_phase = time.perf_counter()
    g, feats, labels = data
    rel = g._relation()
    indptr = rel.csc_indptr.to(torch.int32)
    indices = rel.csc_indices.to(torch.int32)
    sampler = DeviceNeighborSampler(MB_FANOUTS)
    model = DeviceSAGE(MB_FEAT, MB_HIDDEN, MB_CLASSES, num_layers=2,
                       generator=torch.Generator().manual_seed(0),
                       device=device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator(device=device).manual_seed(42)
    nb = N_NODES // MB_BATCH  # full batches per epoch, as bench.py

    # the sampler's picks, on the last (part-masked) batch of a schedule
    ids, smask = device_seed_batches(gen, N_NODES, MB_BATCH, device=device)
    mfg = sampler.sample(gen, indptr, indices, ids[-1], seed_mask=smask[-1])
    masked = check_device_picks(mfg, indptr, indices, MB_FANOUTS)
    emit({"phase": "sage_end_to_end_picks", "seeds": MB_BATCH,
          "masked_seeds": masked,
          "frontiers": [int(f.shape[0]) for f in mfg.frontiers],
          "real_edges": int(mfg.num_real_edges()), **tag})

    def step(seeds, sm):
        mfg = sampler.sample(gen, indptr, indices, seeds, seed_mask=sm)
        logits = model(mfg, feats.index_select(0, mfg.input_nodes()))
        loss = masked_loss(logits, labels.index_select(0, seeds),
                           sm.to(torch.float32))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach(), mfg.num_real_edges()

    def epochs(k):
        """k epochs; their real edges and mean losses, on the card."""
        edges = torch.zeros((), dtype=torch.int64, device=device)
        means = []
        for _ in range(k):
            ids, smask = device_seed_batches(gen, N_NODES, MB_BATCH,
                                             device=device)
            total = torch.zeros((), device=device)
            for i in range(nb):
                loss, ne = step(ids[i], smask[i])
                total = total + loss
                edges = edges + ne
            means.append(total / nb)
        return edges, means

    # the main path: one epoch with the launch counts read around it and
    # any host sync an error
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        edges, means = epochs(1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    expect_no_other_launch(launches, {}, "the end-to-end epoch")
    losses = [m.item() for m in means]
    emit({"phase": "sage_end_to_end_main_path",
          "model": f"DeviceSAGE {MB_FEAT}-{MB_HIDDEN}-{MB_CLASSES}, "
                   f"fanouts {MB_FANOUTS}, unique mode",
          "launches": launches, "host_syncs_in_epoch": 0,
          "real_edges": int(edges), **tag})

    # bench.py's timing: 1 + k epochs against 1, best of 2 each
    def timed(k):
        best = math.inf
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            edges, means = epochs(k)
            edges = int(edges)  # the one read, after the last step
            best = min(best, time.perf_counter() - t0)
            losses.extend(m.item() for m in means)
        return best, edges / k

    t1, _ = timed(1)
    tk, edges_per_epoch = timed(1 + E2E_EPOCHS)
    dt_epoch = (tk - t1) / E2E_EPOCHS
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"end-to-end epoch mean losses: {losses}")
    prof = device_profile(lambda: step(ids[0], smask[0]), 20)
    result = {
        "pipeline": "on-device sampler (sampling+shuffle+fetch+train, "
                    "eager)",
        "ms_per_step": dt_epoch / nb * 1e3, "steps_per_epoch": nb,
        "edges_per_s": edges_per_epoch / dt_epoch, "epoch_s": dt_epoch,
        "device_idle_share": prof["device_idle_share"],
        "device_busy_ms_per_step": prof["device_busy_ms_per_call"],
        "epoch_mean_losses": losses,
        "phase_s": time.perf_counter() - t_phase}
    emit({"phase": "sage_minibatch_end_to_end", **result, **tag})
    emit({"phase": "sage_end_to_end_profile", "calls": "20 steps",
          **prof, **tag})
    return result


# ---------------------------------------------------------------------------
# the weighted shell plan: B1's weighted caller, GCN with edge weights, the
# fused and dense GAT routes
# ---------------------------------------------------------------------------


# The ``tiles`` edge-case plan's level row counts n_0 .. n_31: ends at
# R - 1, R and R + 1 of the kernel's tiles (R = 128, 48, 16, 8 and 4 rows
# at the widths of GSPMM_SHAPES) and at 2R +- 1, others inside a tile.
TILE_LEVEL_ENDS = (2500, 1500, 700, 385, 257, 256, 255, 200, 129, 128, 127,
                   100, 97, 96, 95, 60, 49, 48, 47, 33, 32, 31, 17, 16, 15,
                   9, 8, 7, 5, 4, 3, 1)


def tiles_edges(rng, n=3001, extra=8):
    """Edges whose destinations' in-degrees give the levels
    ``TILE_LEVEL_ENDS``: the rank-0 row reaches all 32 levels and ``extra``
    edges past the cap (a residual), rows beyond the first level's 2,500
    have no in-edge, and the rank order is a random permutation of the
    node ids (unrank not the identity). ``n`` (3,001) is no multiple of
    any tile's rows. Sources uniform."""
    import numpy as np

    ends = np.asarray(TILE_LEVEL_ENDS)
    deg = (ends[None, :] > np.arange(n)[:, None]).sum(1)
    deg[0] += extra
    dst = np.repeat(rng.permutation(n), deg)
    return rng.integers(0, n, dst.size), dst, n


def gspmm_edge_case_plans(device="cuda"):
    """The plans of the weighted kernel's edge cases
    (``tests/test_torch_gpu.py`` holds the kernel to the same ones), by
    name: ``residual``, a power-law graph of 300 nodes and 4,000 edges
    whose in- and out-degrees pass the shell cap (both residuals, unrank
    not the identity); ``identity``, 500 nodes and 3,000 uniform edges
    relabelled by falling in-degree (no residual, identity unrank);
    ``empty``, 50 nodes and no edge (no level); ``tiles``, 3,001 nodes
    whose levels end at the kernel's tile edges (``tiles_edges``). f32
    gathers; the cases cast the tables to each type themselves."""
    import numpy as np

    import dgl_tpu_torch as dt
    from dgl_tpu_torch.ops.shell_spmm import build_shell_plan

    rng = np.random.default_rng(17)
    n = 300
    w = 1.0 / np.arange(1, n + 1)
    graphs = {"residual": (rng.choice(n, 4000, p=w / w.sum()),
                           rng.choice(n, 4000, p=w[::-1] / w.sum()), n)}
    n = 500
    src, dst = rng.integers(0, n, 3000), rng.integers(0, n, 3000)
    perm = np.argsort(-np.bincount(dst, minlength=n), kind="stable")
    new = np.empty(n, np.int64)
    new[perm] = np.arange(n)
    graphs["identity"] = (new[src], new[dst], n)
    graphs["empty"] = (np.zeros(0, np.int64), np.zeros(0, np.int64), 50)
    graphs["tiles"] = tiles_edges(rng)
    return {name: build_shell_plan(dt.graph((s, d), num_nodes=n,
                                            device=device)._relation(),
                                   "f32")
            for name, (s, d, n) in graphs.items()}


# (u feature shape or None, e feature shape): every broadcast gspmm hands
# the shell path, at F = 1, 40, 128, 256 and 750
GSPMM_SHAPES = (((1,), (1,)), (None, ()),
                ((40,), (1,)), ((2, 20), (2, 1)), ((2, 20), (2, 20)),
                ((2, 20), (1, 1)),
                ((128,), (1,)), ((4, 32), (4, 1)), ((4, 32), (1, 1)),
                ((256,), (1,)), ((2, 128), (2, 1)), ((2, 128), (2, 128)),
                ((750,), (1,)), ((3, 250), (3, 1)), ((3, 250), (3, 250)))
GSPMM_OPS = ("add", "sub", "mul", "div", "copy_lhs", "copy_rhs")


def gspmm_case(plan, u_feat, e_feat, op, dtype, seed, device="cuda"):
    """One edge case's arguments of ``shell_prefix_gspmm``: the tables in
    ``dtype`` (edge 0's value 0 under ``div``: its message is inf, and the
    padded slots, which gather edge 0, must be skipped), the forward
    layout and the residual's base."""
    import numpy as np
    import torch

    from dgl_tpu_torch.ops.shell_spmm import _residual_base

    rng = np.random.default_rng(seed)
    n_edges = int(plan.emask.shape[0])
    lhs = rhs = None
    if op != "copy_rhs":
        lhs = torch.from_numpy(rng.normal(size=(plan.num_src,) + tuple(
            u_feat or (1,))).astype(np.float32)).to(device, dtype)
    if op != "copy_lhs":
        e = rng.normal(size=(n_edges,) + tuple(e_feat)).astype(np.float32)
        if op == "div" and n_edges:
            e[0] = 0.0
        rhs = torch.from_numpy(e).to(device, dtype)
    lay = plan.fwd
    empty = torch.zeros(0, dtype=torch.int32, device=device)
    nidx = empty if lay.nidx is None else lay.nidx
    eidx = empty if lay.eidx is None else lay.eidx
    base = _residual_base(op, lhs, rhs, plan.res_dst, plan.num_dst)
    return (op, lhs, rhs, nidx, eidx, lay.level_rows, lay.level_real,
            plan.num_dst), base


def gspmm_case_ranks(plan, device="cuda"):
    """The ``rank`` arguments each edge case runs with: none (rows out in
    rank order) and the plan's ``rank_dst`` (node order; ``arange`` where
    the rank order is the identity, so the kernel's scatter still runs)."""
    import torch

    rank = plan.rank_dst
    if rank is None:
        rank = torch.arange(plan.num_dst, dtype=torch.int32, device=device)
    return (None, rank)


def run_gspmm_edge_cases(tag: dict) -> None:
    """The weighted kernel against its plain version on the edge-case plans
    (``gspmm_edge_case_plans``): every op, both table types, every
    broadcast of ``GSPMM_SHAPES``, with and without the residual's base,
    identity and other unrank, rows out in rank and in node order, ``div``
    by a zero at edge 0, a graph without an edge, levels ending at the
    kernel's tile edges. Exact: the same rounded messages added in the
    same order (inf and NaN where they are)."""
    import torch

    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.ops.shell_prefix import (shell_prefix_gspmm,
                                                shell_prefix_gspmm_plain)

    plans = gspmm_edge_case_plans()
    n_cases, nonfinite = 0, 0
    before = _kernels.launch_counts["shell_prefix_gspmm"]
    for name, plan in plans.items():
        for dtype in (torch.bfloat16, torch.float32):
            for i, (u_feat, e_feat) in enumerate(GSPMM_SHAPES):
                for op in GSPMM_OPS:
                    if (u_feat is None) != (op == "copy_rhs"):
                        continue
                    args, base = gspmm_case(plan, u_feat, e_feat, op, dtype,
                                            i * 10 + GSPMM_OPS.index(op))
                    for rank in gspmm_case_ranks(plan):
                        got = shell_prefix_gspmm(*args, base=base, rank=rank)
                        want = shell_prefix_gspmm_plain(*args, base=base,
                                                        rank=rank)
                        torch.cuda.synchronize()
                        try:
                            torch.testing.assert_close(
                                got, want, rtol=0, atol=0, equal_nan=True)
                        except AssertionError as exc:
                            raise RuntimeError(
                                f"shell_prefix_gspmm edge case {name} "
                                f"{dtype} {op} u{u_feat} e{e_feat} rank "
                                f"{rank is not None}: {exc}") from None
                        nonfinite += int((~torch.isfinite(got)).sum())
                        n_cases += 1
    launched = _kernels.launch_counts["shell_prefix_gspmm"] - before
    if launched != n_cases:
        raise RuntimeError(f"{n_cases} edge cases launched the kernel "
                           f"{launched} times")
    emit({"phase": "shell_gspmm_edge_cases", "cases": n_cases,
          "plans": {k: {"rows": p.num_dst,
                        "levels": len(p.fwd.level_rows),
                        "residual": p.res_dst is not None,
                        "identity_unrank": p.unrank_dst is None}
                    for k, p in plans.items()},
          "nonfinite_outputs_matched": nonfinite,
          "tolerance": "exact (0.0; inf and NaN where the plain version has "
                       "them)", **tag})


def zipf_loops_graph():
    """The zipf graph plus one self-loop a node (the GAT graphs: no
    zero in-degree): 169,343 nodes, 1,335,586 edges."""
    import numpy as np

    src, dst = zipf_graph(0)
    loops = np.arange(N_NODES)
    return np.concatenate([src, loops]), np.concatenate([dst, loops])


def weighted_gcn(dims, dropout, seed, allow_zero_in_degree=False):
    """GraphConv(norm="none") layers of widths ``dims`` over normalised
    edge weights, as DGL users compose them for a weighted graph:
    ``EdgeWeightNorm("both")`` once into ``g.edata["w"]``, each layer
    ``conv(g, h, edge_weight=g.edata["w"])``, ReLU then dropout between
    layers (the ``GCN`` model's order). Weights from ``seed``."""
    import torch
    from torch import nn

    from dgl_tpu_torch.nn import GraphConv

    class _Model(nn.Module):
        def __init__(self):
            super().__init__()
            gen = torch.Generator().manual_seed(seed)
            self.convs = nn.ModuleList(
                GraphConv(a, b, norm="none", generator=gen,
                          allow_zero_in_degree=allow_zero_in_degree)
                for a, b in zip(dims[:-1], dims[1:]))
            self.dropout = nn.Dropout(dropout)

        def forward(self, graph, x):
            w = graph.edata["w"]
            for i, conv in enumerate(self.convs):
                x = conv(graph, x, edge_weight=w)
                if i != len(self.convs) - 1:
                    x = self.dropout(torch.relu(x))
            return x

    return _Model()


@contextlib.contextmanager
def unrank_gathers(unrank):
    """Record each ``index_select`` by ``unrank`` (the gather the weighted
    kernel's node-order store replaces) run inside the block: yields the
    list its row counts go into."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    found = []
    if unrank is None:
        yield found
        return

    class _Gathers(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if (func is torch.ops.aten.index_select.default
                    and args[2].shape == unrank.shape
                    and torch.equal(args[2], unrank.to(args[2].dtype))):
                found.append(int(args[0].shape[0]))
            return func(*args, **(kwargs or {}))

    with _Gathers():
        yield found


def check_gspmm(args, kw, plan, reverse, weights_csr, rate) -> dict:
    """One recorded call of the weighted kernel against its plain version
    on the card (exact), its time, the plain version's, ``torch.sparse.mm``
    over the f32 CSR of the edge weights (the same function: times the
    f32 table for ``u_mul_e``, times a ones column for ``EdgeWeightNorm``'s
    ``copy_rhs``), its bound, and what the card runs it with."""
    import torch

    from dgl_tpu_torch.ops.shell_prefix import (BLOCK_ROWS, _rup,
                                                gspmm_occupancy,
                                                shell_prefix_gspmm,
                                                shell_prefix_gspmm_plain)

    op, lhs, rhs, nidx, _eidx, rows, real, n_out = args
    base, rank = kw.get("base"), kw.get("rank")
    kern = lambda: shell_prefix_gspmm(*args, **kw)  # noqa: E731
    got = kern()
    want = shell_prefix_gspmm_plain(*args, base=base, rank=rank)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    feat = int(got[0].numel())
    if not torch.equal(got, want):
        raise RuntimeError(f"shell_prefix_gspmm vs plain "
                           f"({'bwd' if reverse else 'fwd'}, {op}, F="
                           f"{feat}): max abs err {err}")
    lay, _res, unrank, _n = plan.direction(reverse)
    n_edges = sum(min(int(m), n_out) for m in real)
    value_bytes = rhs.element_size() * int(rhs[0].numel())
    if lhs is None:  # copy_rhs: the slots' edge indices and values alone
        rows_used, elem, slot_bytes, ops = 0, 0, 4 + value_bytes, 1
        table = torch.ones((weights_csr.shape[1], 1), device=got.device)
    else:
        used, off = [], 0
        for m8, m in zip(lay.level_rows, lay.level_real):
            used.append(nidx[off:off + min(m, n_out)])
            off += _rup(m8, BLOCK_ROWS)
        rows_used = int(torch.unique(torch.cat(used)).numel())
        elem, slot_bytes, ops = lhs.element_size(), 8 + value_bytes, 2
        table = lhs.to(torch.float32).reshape(lhs.shape[0], -1)
    bound, bound_by, stream = kernel_bound(
        real, n_out, rows_used, n_edges, feat, base is not None, rate,
        elem=elem, slot_bytes=slot_bytes, ops_per_value=ops,
        row_bytes=0 if rank is None else 4)
    lib = lambda: torch.sparse.mm(weights_csr, table)  # noqa: E731
    by_node = got.reshape(n_out, -1)
    if rank is None and unrank is not None:  # rows in rank order
        by_node = by_node.index_select(0, unrank.long())
    lib_err = (lib() - by_node).abs().max().item()
    occ = gspmm_occupancy(op, lhs, rhs, len(rows))
    row0 = None
    if lhs is not None:  # every slot gathers row 0: no traffic for rows
        a0 = (op, lhs, rhs, torch.zeros_like(nidx)) + tuple(args[4:])
        row0 = time_ms(lambda: shell_prefix_gspmm(*a0, **kw), 50,
                       hide_host=True)
    return {
        "F": feat, "op": op, "table": str(rhs.dtype),
        "n_out": n_out, "edges": n_edges, "levels": len(rows),
        "residual": base is not None, "node_order": rank is not None,
        "table_rows_read": rows_used, "max_abs_err": err,
        "ms": time_ms(kern, 50, hide_host=True),
        "plain_ms": time_ms(lambda: shell_prefix_gspmm_plain(
            *args, base=base, rank=rank), 10, hide_host=True),
        "library_ms": time_ms(lib, 50, hide_host=True),
        "library_max_abs_err_f32_table": lib_err,
        "bound_ms": bound, "bound_by": bound_by,
        # a table row read from memory for every slot: no cache reuse
        "gather_stream_ms": stream, "ms_every_slot_row_0": row0,
        "ptxas_key": occ.pop("kernel"), "occupancy": occ,
    }


def weights_csr(rel, w, reverse: bool):
    """The f32 CSR of the edge weights: (N_dst, N_src) by destination row,
    or with ``reverse`` its transpose."""
    import torch

    if reverse:
        crow, col, eid = rel.csr_indptr, rel.csr_indices, rel.csr_eids
        shape = (rel.num_src, rel.num_dst)
    else:
        crow, col, eid = rel.csc_indptr, rel.csc_indices, rel.csc_eids
        shape = (rel.num_dst, rel.num_src)
    return torch.sparse_csr_tensor(crow.long(), col.long(),
                                   w.index_select(0, eid.long()), shape)


def run_weighted_gcn(gp, g_exact, x, y, mask, rate: float, ptxas: dict,
                     tag: dict) -> dict:
    """GCN with edge weights at ogbn-arxiv widths over the weighted shell
    plan (B1's weighted caller); returns the kernel's entry of the kernel
    table. ``ptxas``: the report of ``shell_prefix_sum.cu``."""
    import numpy as np
    import torch

    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.nn import EdgeWeightNorm
    from dgl_tpu_torch.ops import shell_prefix

    rel = gp._relation()
    plan = rel.shell_plan
    w = torch.from_numpy((np.random.default_rng(5).random(
        rel.num_edges) + 0.5).astype(np.float32)).cuda()
    norm = EdgeWeightNorm("both")
    with recording(shell_prefix, "shell_prefix_gspmm") as norm_rec:
        _kernels.reset_launch_counts()
        gp.edata["w"] = norm(gp, w)
        torch.cuda.synchronize()
        norm_launches = dict(_kernels.launch_counts)
    expect_no_other_launch(norm_launches, {"shell_prefix_gspmm": 1},
                           "EdgeWeightNorm")
    g_exact.edata["w"] = norm(g_exact, w)
    dims = (IN_FEATS, HIDDEN, HIDDEN, CLASSES)
    model = weighted_gcn(dims, 0.5, 0).cuda().eval()

    # the main path: one counted forward (one launch a layer: GraphConv
    # aggregates at the smaller width, 128, 256 and 40)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        out = model(gp, x)
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    expect_no_other_launch(launches, {"shell_prefix_gspmm": LAYERS},
                           "the weighted GCN forward")
    with torch.inference_mode():
        ref = model(g_exact, x)
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    if tuple(out.shape) != (N_NODES, CLASSES) or not torch.allclose(
            out, ref, rtol=2e-2, atol=2e-2 * scale):
        raise RuntimeError(f"weighted GCN vs exact f32 path: max abs err "
                           f"{err} (max |ref| {scale}), shape "
                           f"{tuple(out.shape)}")
    with torch.inference_mode(), unrank_gathers(plan.unrank_dst) as gathers:
        model(gp, x)
    if gathers:
        raise RuntimeError(f"the weighted GCN forward gathered {gathers} "
                           "times by unrank: the kernel stores in node order")
    emit({"phase": "weighted_gcn_main_path", "model": "GraphConv(norm="
          "'none') 128-256-256-40 over EdgeWeightNorm('both') weights, "
          "ReLU, dropout 0.5", "launches": launches,
          "expected_shell_prefix_gspmm": LAYERS,
          "edge_weight_norm_launches": norm_launches,
          "unrank_gathers": len(gathers),
          "max_abs_err_vs_exact_f32": err, "max_rel_err": err / scale,
          "tolerance": "rtol=2e-2, atol=2e-2*max|ref|",
          "peak_memory_gib": peak, **tag})
    del out, ref

    # gradients against the exact f32 path, recording the kernel's real
    # calls (3 forward, 2 backward over the reverse shells)
    model.train()
    with recording(shell_prefix, "shell_prefix_gspmm") as rec:
        grad_check = check_grads(model, gp, g_exact, x, y, mask,
                                 "weighted GCN")
    if len(rec) != LAYERS + LAYERS - 1:
        raise RuntimeError(f"the gradient pass called the kernel {len(rec)} "
                           "times")
    calls = list(rec)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    expect = LAYERS + LAYERS - 1  # the input's aggregation needs no dU
    loss, step_launches, step_peak, step_s = counted_step(
        model, opt, gp, x, y, mask, {"shell_prefix_gspmm": expect},
        "weighted GCN")
    expect_no_other_launch(step_launches, {"shell_prefix_gspmm": expect},
                           "the weighted GCN step")
    losses = run_steps(model, opt, gp, x, y, mask, loss, falling=False)
    emit({"phase": "weighted_gcn_train_main_path", "launches":
          step_launches, "expected_shell_prefix_gspmm": expect,
          "peak_memory_gib": step_peak, "first_step_s": step_s,
          "losses": losses, "grads_vs_exact_f32": grad_check,
          "shell_levels": {"forward": len(plan.fwd.level_rows),
                           "reverse": len(plan.rev.level_rows)}, **tag})

    # the kernel at each of the path's shapes
    csr = {False: weights_csr(rel, gp.edata["w"], False),
           True: weights_csr(rel, gp.edata["w"], True)}
    calls += [(a, k, weights_csr(rel, w, False)) for a, k in norm_rec]
    shapes = {}
    with torch.inference_mode():
        for args, kw, *norm_csr in calls:
            reverse = args[3] is plan.rev.nidx
            r = check_gspmm(args, kw, plan, reverse,
                            norm_csr[0] if norm_csr else csr[reverse], rate)
            r["ptxas"] = ptxas[r.pop("ptxas_key")]
            label = (f"norm F={r['F']}" if norm_csr else
                     f"{'bwd' if reverse else 'fwd'} F={r['F']}")
            shapes[label] = r
            emit({"phase": "kernel_vs_plain", "kernel": "shell_prefix_gspmm",
                  "shape": label, "tolerance": "exact (0.0)",
                  "library": "torch.sparse.mm, f32 CSR of the edge weights, "
                             "times the f32 table (a ones column for "
                             "EdgeWeightNorm)", **r, **tag})
    if sorted(shapes) != sorted([f"fwd F={f}" for f in dims[:-2]]
                                + [f"fwd F={CLASSES}", f"bwd F={HIDDEN}",
                                   f"bwd F={CLASSES}", "norm F=1"]):
        raise RuntimeError(f"recorded kernel shapes {sorted(shapes)}")
    del calls, rec, norm_rec

    model.eval()
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(gp, x), 10)
        exact_ms = time_ms(lambda: model(g_exact, x), 5)
        prof = device_profile(lambda: model(gp, x), 3)
    model.train()
    step = lambda: train_step(model, opt, gp, x, y, mask)  # noqa: E731
    timing = {"forward_ms": fwd_ms, "exact_f32_path_forward_ms": exact_ms,
              "step_ms": time_ms(step, 5)}
    emit({"phase": "weighted_gcn_timing", **timing, **tag})
    emit({"phase": "weighted_gcn_forward_profile", "calls": 3, **prof,
          **tag})
    emit({"phase": "weighted_gcn_train_profile", "calls": 2,
          **device_profile(step, 2), **tag})
    main = shapes[f"fwd F={HIDDEN}"]
    return {
        "name": "shell_prefix_gspmm",
        "route": "cuda",
        "source": "dgl_tpu_torch/csrc/shell_prefix_sum.cu",
        "replaces": "dgl_tpu/ops/shell_pallas.py:110",
        "launches": launches["shell_prefix_gspmm"],
        "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shape": f"u_mul_e sum, fwd F={HIDDEN} bf16, n_out={N_NODES}, times "
                 "per call; launches: the weighted GCN forward",
        "launches_train_step": step_launches["shell_prefix_gspmm"],
        "shapes": {k: {f: v[f] for f in ("F", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms",
                                         "max_abs_err")}
                   for k, v in shapes.items()},
        "launches_edge_weight_norm": norm_launches["shell_prefix_gspmm"],
        "forward_ms": fwd_ms, "train_step_ms": timing["step_ms"],
    }


def bf16_flip_check(out, ref, what):
    """The port's rule for one computation on two devices whose roundings
    to bf16 may differ by one step: at most 1 element in 1000 outside
    rtol = atol = 1e-4 of max|ref|, every element within 2**-8 *
    max|ref|."""
    scale = max(ref.abs().max().item(), 1e-30)
    diff = (out - ref).abs()
    bad = (diff > 1e-4 * scale + 1e-4 * ref.abs()).float().mean().item()
    err = diff.max().item()
    if bad > 1e-3 or err > 2.0 ** -8 * scale:
        raise RuntimeError(f"{what}: max abs err {err} (max |ref| {scale}), "
                           f"share outside 1e-4: {bad}")
    return {"max_abs_err": err, "max_rel_err": err / scale,
            "share_outside_1e-4": bad}


def run_fused_gat(gp, g_plain, x, y, mask, edge_step_ms, tag: dict) -> dict:
    """GAT at ogbn-arxiv widths over the weighted shell plan: every layer
    through the fused shell-space route (PyTorch operations, no hand
    kernel, as the reference's XLA operations)."""
    import torch

    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.models import GAT
    from dgl_tpu_torch.ops import fused_gat

    model = GAT(IN_FEATS, EDGE_GAT_HIDDEN, CLASSES, heads=EDGE_GAT_HEADS,
                num_layers=LAYERS, feat_drop=0.75, attn_drop=0.05,
                generator=torch.Generator().manual_seed(0)).eval()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    with recording(fused_gat, "fused_gat_attention") as rec, \
            torch.inference_mode():
        out = model(gp, x)
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    expect_no_other_launch(launches, {}, "the fused GAT forward")
    if len(rec) != LAYERS:
        raise RuntimeError(f"{len(rec)} layers took the fused route")
    del rec
    if tuple(out.shape) != (N_NODES, CLASSES) or not torch.isfinite(
            out).all():
        raise RuntimeError(f"bad fused GAT output {tuple(out.shape)}")
    with torch.inference_mode():
        ref = model(g_plain, x)
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    if not torch.allclose(out, ref, rtol=2e-2, atol=2e-2 * scale):
        raise RuntimeError(f"fused GAT vs the per-edge route: max abs err "
                           f"{err} (max |ref| {scale})")
    del ref
    t0 = time.perf_counter()
    model_cpu = GAT(IN_FEATS, EDGE_GAT_HIDDEN, CLASSES, heads=EDGE_GAT_HEADS,
                    num_layers=LAYERS, device="cpu").eval()
    model_cpu.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    with torch.inference_mode():
        cpu = model_cpu(gp.to("cpu"), x.cpu())
    vs_cpu = bf16_flip_check(out.cpu(), cpu, "fused GAT card vs CPU")
    emit({"phase": "fused_gat_main_path", "model": "GAT 128-250x3-250x3-40,"
          " 3 layers, fused shell-space route", "launches": launches,
          "peak_memory_gib": peak,
          "vs_per_edge_route": {"max_abs_err": err,
                                "max_rel_err": err / scale,
                                "tolerance": "rtol=2e-2, atol=2e-2*max|ref|"},
          "vs_cpu_fused_route": {**vs_cpu, "tolerance": "at most 1 in 1000 "
                                 "outside 1e-4, all within 2**-8*max|ref|",
                                 "cpu_forward_s": time.perf_counter() - t0},
          **tag})
    del model_cpu, cpu, out
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(gp, x), 5)
        prof = device_profile(lambda: model(gp, x), 2)
    emit({"phase": "fused_gat_forward_profile", "calls": 2, **prof, **tag})

    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    loss, launches, step_peak, step_s = counted_step(
        model, opt, gp, x, y, mask, {k: 0 for k in _kernels.launch_counts},
        "fused GAT")
    losses = run_steps(model, opt, gp, x, y, mask, loss, falling=False)
    step = lambda: train_step(model, opt, gp, x, y, mask)  # noqa: E731
    step_ms = time_ms(step, 3)
    emit({"phase": "fused_gat_train_main_path", "model": "GAT 128-250x3-"
          "250x3-40, feat_drop 0.75, attn_drop 0.05 (an (E, H) mask)",
          "launches": launches, "peak_memory_gib": step_peak,
          "first_step_s": step_s, "losses": losses, **tag})
    emit({"phase": "fused_gat_timing", "forward_ms": fwd_ms,
          "step_ms": step_ms, "per_edge_route_step_ms_this_run":
          edge_step_ms, **tag})
    emit({"phase": "fused_gat_train_profile", "calls": 2,
          **device_profile(step, 2), **tag})
    return {"forward_ms": fwd_ms, "train_step_ms": step_ms,
            "peak_memory_gib": step_peak}


# DGL's Cora GAT (examples/pytorch/gat): 8 heads of 8, 7 classes, both
# dropouts 0.6; Cora's shape: 2,708 nodes, 10,556 directed edges (5,278
# pairs), 1,433 features
CORA_N, CORA_PAIRS, CORA_FEAT, CORA_CLASSES = 2708, 5278, 1433, 7


def cora_graph(seed: int = 43):
    """A seeded random graph of Cora's shape: CORA_PAIRS distinct
    undirected pairs, no self-loop, both directions, plus one self-loop a
    node."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = rng.integers(0, CORA_N, 3 * CORA_PAIRS)
    b = rng.integers(0, CORA_N, 3 * CORA_PAIRS)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    key = np.unique((lo * CORA_N + hi)[lo != hi])
    key = rng.permutation(key)[:CORA_PAIRS]
    lo, hi = key // CORA_N, key % CORA_N
    loops = np.arange(CORA_N)
    return (np.concatenate([lo, hi, loops]), np.concatenate([hi, lo, loops]))


def run_dense_cora(tag: dict) -> dict:
    """GAT at Cora's size over ``with_spmm_plans(weighted=True)``: both
    layers through the dense masked-attention route in bf16, held against
    the per-edge route at the reference's bound for that route."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.models import GAT
    from dgl_tpu_torch.ops import dense_attn

    src, dst = cora_graph()
    g = dt.graph((src, dst), num_nodes=CORA_N)
    t0 = time.perf_counter()
    gp = g.with_spmm_plans(weighted=True)
    torch.cuda.synchronize()
    plans_s = time.perf_counter() - t0
    rel = gp._relation()
    if rel.dense_adj is None or rel.shell_plan is None:
        raise RuntimeError("the Cora-sized graph lacks its dense mask")
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(CORA_N, CORA_FEAT)).astype(np.float32)).cuda()
    y = torch.from_numpy(np.random.default_rng(7).integers(
        0, CORA_CLASSES, CORA_N)).cuda()
    mask = torch.ones(CORA_N, device=x.device)
    model = GAT(CORA_FEAT, 8, CORA_CLASSES, heads=8, num_layers=2,
                feat_drop=0.6, attn_drop=0.6,
                generator=torch.Generator().manual_seed(0)).eval()
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on for f32 products")
    _kernels.reset_launch_counts()
    with recording(dense_attn, "dense_masked_attention") as rec:
        with torch.inference_mode():
            out = model(gp, x)
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    expect_no_other_launch(launches, {}, "the dense GAT forward")
    if len(rec) != 2 or any(k["compute_dtype"] != torch.bfloat16
                            for _a, k in rec):
        raise RuntimeError("the dense route did not carry both layers in "
                           "bf16")
    del rec
    # the reference's bound for this route in bf16
    # (tests/test_dense_attn.py::test_dense_path_bf16_error_bound): the
    # loss sum(out**2) within 1e-2 relative, each gradient within 3e-2
    # L2-relative; the output within 3e-2 L2-relative
    with torch.inference_mode():
        ref = model(g, x)
    out_l2 = ((out - ref).norm() / ref.norm()).item()
    model.zero_grad(set_to_none=True)
    losses, grads = [], []
    for graph in (gp, g):
        loss = (model(graph, x) ** 2).sum()
        loss.backward()
        losses.append(loss.item())
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
    grad_l2 = {k: ((grads[0][k] - r).norm() / r.norm().clamp_min(1e-12)
                   ).item() for k, r in grads[1].items()}
    if out_l2 >= 3e-2 or loss_rel >= 1e-2 or max(grad_l2.values()) >= 3e-2:
        raise RuntimeError(f"dense GAT vs per-edge: output L2 {out_l2}, "
                           f"loss {loss_rel}, gradients {grad_l2}")
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(gp, x), 10)
        edge_fwd_ms = time_ms(lambda: model(g, x), 10)
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    loss, step_launches, peak, step_s = counted_step(
        model, opt, gp, x, y, mask, {k: 0 for k in _kernels.launch_counts},
        "dense GAT")
    if not math.isfinite(loss.item()):
        raise RuntimeError(f"dense GAT training loss {loss.item()}")
    step_ms = time_ms(lambda: train_step(model, opt, gp, x, y, mask), 10)
    result = {"forward_ms": fwd_ms, "per_edge_route_forward_ms": edge_fwd_ms,
              "step_ms": step_ms}
    emit({"phase": "dense_gat_cora", "model": "GAT 1433-8x8-7, dropouts "
          "0.6 (Cora-sized random graph)", "nodes": CORA_N,
          "edges": rel.num_edges, "plans_s": plans_s, "launches": launches,
          "vs_per_edge_route": {"output_l2_rel": out_l2,
                                "loss_rel": loss_rel, "grad_l2_rel": grad_l2,
                                "tolerance": "output and gradients < 3e-2 "
                                "L2-relative, loss < 1e-2"},
          "train_step_launches": step_launches, "train_loss": loss.item(),
          "peak_memory_gib": peak, **result, **tag})
    return result


DENSE_OUT = 16  # DGL's Cora GCN hidden width (1433 -> 16)


def held(got: dict, ref: dict, tol: float, what: str, zero=()) -> dict:
    """Each tensor of ``got`` against ``ref``'s (moved to its device) at
    rtol = ``tol``, atol = ``tol`` * max|ref|; fails otherwise. Returns
    the largest error over that scale of each. The tensors named in
    ``zero`` are 0 in exact arithmetic, so both sides hold rounding
    noise: their scale is the largest max|ref| of all the tensors."""
    import torch

    largest = max(r.abs().max().item() for r in ref.values())
    errs = {}
    for k, r in ref.items():
        g = got[k].detach()
        r = r.detach().to(g.device)
        scale = max(largest if k in zero else r.abs().max().item(), 1e-30)
        err = (g - r).abs().max().item()
        if not torch.allclose(g, r, rtol=tol, atol=tol * scale):
            raise RuntimeError(f"{what}, {k}: max abs err {err} (max |ref| "
                               f"{scale})")
        errs[k] = err / scale
    return errs


def grads_and_out(fn, params, inputs, cot_seed: int) -> dict:
    """``fn(*inputs)``'s outputs and the gradients of ``sum(out * cot)``
    (seeded cotangents, made on the CPU) for the float inputs that
    require them and for ``params`` (a name -> tensor map)."""
    import torch

    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator().manual_seed(cot_seed)
    cots = [torch.randn(o.shape, generator=gen).to(o.device) for o in outs]
    loss = sum((o * c).sum() for o, c in zip(outs, cots))
    tensors = {f"out{i}": o for i, o in enumerate(outs)}
    wrt = [(f"d input {i}", t) for i, t in enumerate(inputs)
           if isinstance(t, torch.Tensor) and t.requires_grad]
    wrt += [(f"grad {k}", p) for k, p in params.items()]
    grads = torch.autograd.grad(loss, [t for _k, t in wrt],
                                allow_unused=True)
    for (k, t), gr in zip(wrt, grads):
        tensors[k] = torch.zeros_like(t) if gr is None else gr
    return tensors


def run_dense_convs(tag: dict, device="cuda") -> dict:
    """The dense-adjacency convs on the Cora-shaped graph (phase d),
    1433 -> 16: ``DenseGraphConv`` on the (N, N) adjacency with the
    graph's self-loops against ``GraphConv``, ``DenseSAGEConv`` on the
    adjacency without them (it adds the identity) against
    ``SAGEConv("mean")``, ``DenseChebConv`` (k = 3) against ``ChebConv``,
    on the card, the weights shared (seed 0): the output and the gradients
    of the input and every weight at rtol = 1e-4, atol = 1e-4 * max|ref|
    (the same f32 sums, dense or gathered; TF32 off), and both forwards'
    times. No hand kernel: every count stays 0."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.nn import conv as c

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on for f32 products")
    src, dst = cora_graph()
    g = dt.graph((src, dst), num_nodes=CORA_N, device=device)
    adj_loops = torch.zeros((CORA_N, CORA_N), device=device)
    adj_loops[torch.from_numpy(dst).to(device),
              torch.from_numpy(src).to(device)] = 1
    adj = adj_loops - torch.eye(CORA_N, device=device)  # one loop a node
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(CORA_N, CORA_FEAT)).astype(np.float32)).to(device)
    gen = torch.Generator().manual_seed(0)
    F, O = CORA_FEAT, DENSE_OUT
    kw = dict(generator=gen, device=device)
    gc = c.GraphConv(F, O, **kw)
    sage = c.SAGEConv(F, O, **kw)
    cheb = c.ChebConv(F, O, k=3, **kw)
    with torch.no_grad():  # nonzero biases, seeded
        for m in (gc, sage, cheb):
            m.bias.copy_(torch.randn(O, generator=gen))
    dgc = c.DenseGraphConv(F, O, device=device)
    dsage = c.DenseSAGEConv(F, O, device=device)
    dcheb = c.DenseChebConv(F, O, 3, device=device)
    with torch.no_grad():
        dgc.weight.copy_(gc.weight)
        dgc.bias.copy_(gc.bias)
        dsage.fc.weight.copy_(torch.cat([sage.fc_self.weight,
                                         sage.fc_neigh.weight], 1))
        dsage.fc.bias.copy_(sage.bias)
        dcheb.W.copy_(torch.stack([cheb.w0.weight.T, cheb.w1.weight.T,
                                   cheb.w2.weight.T]))
        dcheb.bias.copy_(cheb.bias)
    pairs = {
        "DenseGraphConv": (dgc, adj_loops, gc, {
            "weight": "weight", "bias": "bias"}),
        "DenseSAGEConv": (dsage, adj, sage, {
            "fc.weight": ("fc_self.weight", "fc_neigh.weight"),
            "fc.bias": "bias"}),
        "DenseChebConv": (dcheb, adj_loops, cheb, {
            "W": ("w0.weight", "w1.weight", "w2.weight"), "bias": "bias"}),
    }
    result = {}
    for i, (name, (dense, a, sparse, names)) in enumerate(pairs.items()):
        xi = x.clone().requires_grad_()
        _kernels.reset_launch_counts()
        got = grads_and_out(dense, dict(dense.named_parameters()), (a, xi),
                            i)
        xs = x.clone().requires_grad_()
        sp = grads_and_out(sparse, dict(sparse.named_parameters()), (g, xs),
                           i)
        expect_no_other_launch(dict(_kernels.launch_counts), {},
                               f"{name} and its graph conv")
        ref = {"out0": sp["out0"], "d input 1": sp["d input 1"]}
        got = {k: v for k, v in got.items() if k != "d input 0"}
        for dk, sk in names.items():
            if isinstance(sk, str):
                ref[f"grad {dk}"] = sp[f"grad {sk}"]
            elif dk == "W":
                ref[f"grad {dk}"] = torch.stack([sp[f"grad {k}"].T
                                                 for k in sk])
            else:
                ref[f"grad {dk}"] = torch.cat([sp[f"grad {k}"] for k in sk], 1)
        errs = held(got, ref, 1e-4, f"{name} vs its graph conv")
        with torch.inference_mode():
            ms = time_ms(lambda: dense(a, x), 10)
            graph_ms = time_ms(lambda: sparse(g, x), 10)
        result[name] = {"forward_ms": ms, "graph_conv_forward_ms": graph_ms}
        emit({"phase": "dense_conv", "conv": name, "against": type(
            sparse).__name__, "nodes": CORA_N, "widths": f"{F}-{O}",
            "max_rel_err": max(errs.values()),
            "worst": max(errs, key=errs.get),
            "tolerance": "rtol=1e-4, atol=1e-4*max|ref| per tensor",
            **result[name], **tag})
    return result


# Graphormer-base's layer (Ying et al., 2021): width 768, 32 heads, FFN
# 768; a batch of 64 graphs padded to 51 nodes; EGT's edge channels 64
GT_B, GT_N, GT_D, GT_HEADS, GT_FFN, GT_EDGE = 64, 51, 768, 32, 768, 64
GT_MAX_DEGREE, GT_MAX_DIST, GT_PATH_LEN, GT_PATH_FEAT = 64, 10, 5, 16
GT_KERNELS, GT_NODE_TYPES, GT_LAP_K, GT_LAP_DIM = 16, 32, 8, 16
# the gt pass's gradients that are 0 in exact arithmetic: a bias added to
# every score of a softmax row (the 3D encoder's last bias, a per-head
# constant of the attention bias; the key projections' biases)
GT_ZERO_GRADS = ("grad spatial3d.proj2.bias",
                 "grad graphormer.attn.k_proj.bias",
                 "grad lap.attn0.key.bias", "grad lap.attn1.key.bias")


def gt_inputs(seed: int = 8):
    """The gt phase's seeded batch (numpy): node features, graph sizes
    (the first 51), the padding mask, in/out degrees, shortest-path
    distances (-1 unreachable), path edge features, 3D coordinates, node
    types, EGT's pair features and its additive mask, and Laplacian
    eigenvalues and eigenvectors (NaN past a graph's size, up to k)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = rng.integers(10, GT_N + 1, GT_B)
    sizes[0] = GT_N
    real = np.arange(GT_N)[None, :] < sizes[:, None]
    pad = ~(real[:, :, None] & real[:, None, :])
    lap_vals = rng.random((GT_B * GT_N, GT_LAP_K)).astype(np.float32)
    lap_vecs = rng.normal(size=(GT_B * GT_N, GT_LAP_K)).astype(np.float32)
    short = np.repeat(np.minimum(sizes, GT_LAP_K), GT_N)
    cut = np.arange(GT_LAP_K)[None, :] >= short[:, None]
    lap_vals[cut] = np.nan
    lap_vecs[cut] = np.nan
    return {
        "nfeat": rng.normal(size=(GT_B, GT_N, GT_D)).astype(np.float32),
        "pad": pad,
        "degrees": rng.integers(0, 80, (GT_B, GT_N, 2)),
        "dist": rng.integers(-1, GT_MAX_DIST + 3, (GT_B, GT_N, GT_N)),
        "path": rng.normal(size=(GT_B, GT_N, GT_N, GT_PATH_LEN,
                                 GT_PATH_FEAT)).astype(np.float32),
        "coord": rng.normal(size=(GT_B, GT_N, 3)).astype(np.float32),
        "types": rng.integers(0, GT_NODE_TYPES, (GT_B, GT_N)),
        "efeat": rng.normal(size=(GT_B, GT_N, GT_N, GT_EDGE)).astype(
            np.float32),
        "emask": np.where(pad, -1e9, 0.0).astype(np.float32),
        "lap_vals": lap_vals, "lap_vecs": lap_vecs}


def gt_modules(device):
    """The gt phase's modules, weights drawn on the CPU from seed 0 (the
    same on every device)."""
    import torch

    from dgl_tpu_torch.nn import gt

    gen = torch.Generator().manual_seed(0)
    kw = dict(generator=gen, device=device)
    return {
        "degree": gt.DegreeEncoder(GT_MAX_DEGREE, GT_D, **kw),
        "spatial": gt.SpatialEncoder(GT_MAX_DIST, GT_HEADS, **kw),
        "path": gt.PathEncoder(GT_PATH_LEN, GT_PATH_FEAT, GT_HEADS, **kw),
        "spatial3d": gt.SpatialEncoder3d(GT_KERNELS, GT_HEADS,
                                         GT_NODE_TYPES, **kw),
        "lap": gt.LapPosEncoder("Transformer", 2, GT_LAP_K, GT_LAP_DIM,
                                n_head=2, num_post_layer=1, **kw),
        "graphormer": gt.GraphormerLayer(GT_D, GT_FFN, GT_HEADS, **kw),
        "egt": gt.EGTLayer(GT_D, GT_EDGE, GT_HEADS, **kw)}


def gt_pass(mods, data, device) -> dict:
    """The gt phase's pass (eval: dropout off): the node features plus the
    degree encoding, the attention bias of the spatial, path and 3D
    encoders, a ``GraphormerLayer`` under the padding mask, an
    ``EGTLayer`` over the pair features and the Laplacian encoder; the
    outputs and the gradients of the node and pair features and of every
    parameter (``grads_and_out``, seeded cotangents)."""
    import torch

    t = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    nfeat = t["nfeat"].requires_grad_()
    efeat = t["efeat"].requires_grad_()
    for m in mods.values():
        m.eval()

    def fn(nfeat, efeat):
        h = nfeat + mods["degree"](t["degrees"])
        bias = (mods["spatial"](t["dist"])
                + mods["path"](t["dist"], t["path"])
                + mods["spatial3d"](t["coord"], t["types"]))
        out = mods["graphormer"](h, bias, t["pad"])
        n_out, e_out = mods["egt"](out, efeat, t["emask"])
        return n_out, e_out, mods["lap"](t["lap_vals"], t["lap_vecs"])

    params = {f"{name}.{k}": p for name, m in mods.items()
              for k, p in m.named_parameters()}
    return grads_and_out(fn, params, (nfeat, efeat), 3)


def run_gt(tag: dict, device="cuda") -> dict:
    """The graph-transformer layers at Graphormer-base's width (phase e):
    768 wide, 32 heads, FFN 768, over a seeded batch of 64 graphs padded
    to 51 nodes with a padding mask; the degree, spatial, path and 3D
    encoders, ``GraphormerLayer``, ``EGTLayer`` (pair channels 64) and the
    Laplacian encoder, as ``gt_pass`` composes them, on the card against
    the same modules and inputs on the CPU: every output and gradient at
    rtol = 1e-4, atol = 1e-4 * max|ref| (TF32 off; the gradients that are
    0 in exact arithmetic, ``GT_ZERO_GRADS``, at 1e-4 of the largest
    max|ref|); the pass's and the
    Graphormer layer's times and peak memory. No hand kernel: every count
    stays 0."""
    import torch

    from dgl_tpu_torch import _kernels

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on for f32 products")
    data = gt_inputs()
    t0 = time.perf_counter()
    ref = gt_pass(gt_modules("cpu"), data, "cpu")
    cpu_s = time.perf_counter() - t0
    mods = gt_modules(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    got = gt_pass(mods, data, device)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    expect_no_other_launch(dict(_kernels.launch_counts), {}, "the gt pass")
    if not all(torch.isfinite(v).all() for v in got.values()):
        raise RuntimeError("the gt pass gave non-finite values")
    # gradients of biases that add one value to a whole row of scores,
    # which the softmax does not see
    errs = held(got, ref, 1e-4, "gt pass, card vs CPU", zero=GT_ZERO_GRADS)
    pad = torch.from_numpy(data["pad"]).to(device)
    x = torch.from_numpy(data["nfeat"]).to(device)
    layer = mods["graphormer"]
    with torch.inference_mode():
        layer_ms = time_ms(lambda: layer(x, None, pad), 10)
    pass_ms = time_ms(lambda: gt_pass(mods, data, device), 3)
    result = {"pass_with_grads_ms": pass_ms,
              "graphormer_layer_forward_ms": layer_ms,
              "peak_memory_gib": peak}
    emit({"phase": "gt_layers", "batch": f"{GT_B} graphs x {GT_N} nodes",
          "width": GT_D, "heads": GT_HEADS, "tensors": len(errs),
          "max_rel_err": max(errs.values()),
          "worst": max(errs, key=errs.get), "cpu_s": cpu_s,
          "tolerance": "rtol=1e-4, atol=1e-4*max|ref| per tensor",
          **result, **tag})
    return result


LINK_BATCH, LINK_RELS, LINK_RFEATS = 65_536, 16, 64


def run_link_sparse(tag: dict, device="cuda") -> dict:
    """Link predictors and sparse optimisers (phase f), card against CPU:
    ``EdgePredictor`` (``cos`` then a linear to 16, and ``cat``),
    ``TransE`` (p = 1) and ``TransR`` (p = 2, 64-wide relation space)
    over 65,536 seeded 128-wide (head, tail, relation) triples of 16
    relations, outputs and every gradient at rtol = 1e-4,
    atol = 1e-4 * max|ref|; then a ``NodeEmbedding`` of arxiv's 169,343
    rows x 128 and one sparse Adam and one sparse Adagrad update over
    65,536 ids with repeats (each of 64 ids 64 times, the rest
    uniform): table and state at rtol = atol = 1e-5 (per-row sums by
    atomics in another order), rows never touched unchanged exactly, and
    each update's time."""
    import numpy as np
    import torch

    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.nn import (EdgePredictor, NodeEmbedding, TransE,
                                  TransR, sparse_adagrad_init,
                                  sparse_adagrad_update, sparse_adam_init,
                                  sparse_adam_update)

    rng = np.random.default_rng(10)
    hh = rng.normal(size=(LINK_BATCH, IN_FEATS)).astype(np.float32)
    ht = rng.normal(size=(LINK_BATCH, IN_FEATS)).astype(np.float32)
    rels = rng.integers(0, LINK_RELS, LINK_BATCH)

    def mods(device):
        gen = torch.Generator().manual_seed(0)
        kw = dict(generator=gen, device=device)
        return {"EdgePredictor cos": EdgePredictor("cos", IN_FEATS, 16,
                                                   bias=True, **kw),
                "EdgePredictor cat": EdgePredictor("cat", IN_FEATS, 1, **kw),
                "TransE": TransE(LINK_RELS, IN_FEATS, 1, **kw),
                "TransR": TransR(LINK_RELS, LINK_RFEATS, IN_FEATS, 2, **kw)}

    result = {}
    pairs = {dev: mods(dev) for dev in ("cpu", device)}
    _kernels.reset_launch_counts()
    for i, name in enumerate(pairs["cpu"]):
        res = {}
        for dev, ms in pairs.items():
            m = ms[name]
            a = torch.from_numpy(hh).to(dev).requires_grad_()
            b = torch.from_numpy(ht).to(dev)
            r = torch.from_numpy(rels).to(dev)
            args = (a, b) if name.startswith("Edge") else (a, b, r)
            res[dev] = grads_and_out(m, dict(m.named_parameters()), args, i)
        errs = held(res[device], res["cpu"], 1e-4, f"{name}, card vs CPU")
        result[name] = max(errs.values())
    torch.cuda.synchronize()
    expect_no_other_launch(dict(_kernels.launch_counts), {},
                           "the link predictors")
    # sparse optimisers over an arxiv-sized table
    ids = rng.integers(0, N_NODES, LINK_BATCH)
    ids[:64 * 64] = np.repeat(rng.choice(N_NODES, 64, replace=False), 64)
    grads = rng.normal(size=(LINK_BATCH, IN_FEATS)).astype(np.float32)
    untouched = torch.ones(N_NODES, dtype=torch.bool)
    untouched[torch.from_numpy(ids)] = False
    opt_ms = {}
    for opt, (init, update) in {"adam": (sparse_adam_init,
                                         sparse_adam_update),
                                "adagrad": (sparse_adagrad_init,
                                            sparse_adagrad_update)}.items():
        out = {}
        for dev in ("cpu", device):
            emb = NodeEmbedding(N_NODES, IN_FEATS, seed=0, device=dev)
            state = init(emb.weight)
            i_d, g_d = (torch.from_numpy(ids).to(dev),
                        torch.from_numpy(grads).to(dev))
            table, new_state = update(emb.weight, state, i_d, g_d, lr=0.01)
            out[dev] = (emb.weight, table, new_state)
            if dev == device:
                opt_ms[opt] = time_ms(
                    lambda: update(emb.weight, state, i_d, g_d, lr=0.01), 10)
        (w0, t_cpu, s_cpu), (_w, t_gpu, s_gpu) = out["cpu"], out[device]
        for a, b in [(t_gpu, t_cpu)] + list(zip(s_gpu, s_cpu)):
            if not torch.allclose(a.cpu(), b, rtol=1e-5, atol=1e-5):
                raise RuntimeError(f"sparse {opt}: card vs CPU max abs err "
                                   f"{(a.cpu() - b).abs().max().item()}")
        if not torch.equal(t_gpu.cpu()[untouched], w0[untouched]):
            raise RuntimeError(f"sparse {opt} moved untouched rows")
        if torch.equal(t_gpu.cpu()[~untouched], w0[~untouched]):
            raise RuntimeError(f"sparse {opt} moved no touched row")
    emit({"phase": "link_and_sparse_emb", "link_max_rel_err": result,
          "link_tolerance": "rtol=1e-4, atol=1e-4*max|ref| per tensor",
          "table": f"{N_NODES} x {IN_FEATS}", "update_ids": LINK_BATCH,
          "distinct_ids": int(np.unique(ids).size),
          "sparse_tolerance": "rtol=atol=1e-5; untouched rows exact",
          "update_ms": opt_ms, **tag})
    return {"link": result, "update_ms": opt_ms}


def run_weighted(rate: float, edge_step_ms: float, ptxas: dict,
                 tag: dict) -> dict:
    """The weighted shell plan's phases on the zipf graph plus self-loops
    (``with_spmm_plans(num_hubs=2048, weighted=True)``, bf16 gathers):
    the weighted GCN (B1's weighted caller) and the fused GAT route.
    Returns the weighted kernel's entry of the kernel table."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt

    src, dst = zipf_loops_graph()
    # two graphs: a plan copy shares its original's feature frames
    g = dt.graph((src, dst), num_nodes=N_NODES)
    t0 = time.perf_counter()
    gp = dt.graph((src, dst), num_nodes=N_NODES).with_spmm_plans(
        num_hubs=2048, weighted=True)
    torch.cuda.synchronize()
    plans_s = time.perf_counter() - t0
    rel = gp._relation()
    plan = rel.shell_plan
    if plan is None or rel.dense_adj is not None or (
            rel.bitmap_plan is not None):
        raise RuntimeError("the weighted graph's plans are not the shell "
                           "and hub plans alone")

    def res_size(res):
        return None if res is None else {
            "padded_slots": int(res[0].shape[0]),
            "edges": int(res[4].sum().item()),
            "nodes": int(torch.unique(res[3]).numel())}

    emit({"phase": "weighted_plans", "nodes": N_NODES,
          "edges": rel.num_edges, "plans_s": plans_s,
          "gather_dtype": plan.gather_dtype,
          "forward_levels": len(plan.fwd.level_rows),
          "forward_level_rows": plan.fwd.level_real,
          "forward_residual": res_size(plan.res_dst),
          "reverse_levels": len(plan.rev.level_rows),
          "reverse_residual": res_size(plan.res_src),
          "identity_unrank": {"dst": plan.unrank_dst is None,
                              "src": plan.unrank_src is None}, **tag})
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(N_NODES, IN_FEATS)).astype(np.float32)).cuda()
    y = torch.from_numpy(np.random.default_rng(4).integers(
        0, CLASSES, N_NODES)).cuda()
    mask = torch.ones(N_NODES, device=x.device)
    entry = run_weighted_gcn(gp, g, x, y, mask, rate,
                             ptxas["shell_prefix_sum"], tag)
    entry["fused_gat"] = run_fused_gat(gp, g, x, y, mask, edge_step_ms, tag)
    entry["conv_zoo"] = run_conv_zoo(gp, g, x, tag)
    entry["explain_gcn"] = run_explain_gcn(gp, g, x, tag)
    return entry


# ---------------------------------------------------------------------------
# the conv zoo over the arxiv plans (B1 and B1w under new callers)
# ---------------------------------------------------------------------------

ZOO_OUT, ZOO_HEADS, ZOO_EDGE_FEATS = 256, 4, 16  # in is IN_FEATS (128)
# NNConv's per-edge (in, out) matrices: (E, in * out) f32, 175 GB at
# 128 x 256 over the 1,335,586 edges; 16 x 16 takes 1.37 GB
NNCONV_FEATS = 16
# AtomicConv's radial filters (cutoffs, means, scalings) and atom types
ATOMIC_RBF = ((2.0, 3.5, 5.0, 6.5), (0.0, 1.5, 3.0, 4.5), (4.0, 4.0, 4.0,
                                                            4.0))
ATOMIC_TYPES = (1.0, 6.0, 7.0, 8.0)


def zoo_convs(device="cuda"):
    """The convs of the zoo phase, weights from seed 0: (name, module,
    extra inputs, (B1, B1w) launches a forward on the weighted graph's
    plans). Extra inputs: ``"e"`` (E, 16) edge features, ``"e128"``
    (E, 128), ``"w"`` (E,) edge weights, ``"x0"`` the initial features,
    ``"t"`` (E,) edge types in [0, 3), ``"p"`` (E, 2) pseudo-coordinates,
    ``"eig"`` (N, 3) eigenvector columns, ``"coord"`` (N, 3)
    coordinates, ``"d"`` (E, 1) distances, ``"x16"`` the input's first
    16 columns in place of the input, ``"atoms"`` (N, 1) atomic numbers
    in its place. Copy_u sums and means go through the hub plan (B1),
    other sum and mean ops through the shell plan (B1w), max and min
    through the shell plan's PyTorch reductions (no kernel). So
    PNA's mean 1 and std 2 (the means of h and h * h) B1; DGN's mean 1 B1
    and its directional aggregators' |F| norm and two ``u_mul_e`` sums 3
    B1w; GatedGCN's ``u_mul_e`` and ``copy_e`` sums 2 B1w; TWIRLS's first
    three steps 3 B1 and the reweighted fourth 1 B1w; AtomicConv's
    ``copy_e`` sum 1 B1w; EGNN's ``copy_e`` sum and mean 2 B1w;
    GroupRevRes's two GraphConv groups 2 B1."""
    import torch
    from torch import nn

    from dgl_tpu_torch.nn import conv as c

    gen = torch.Generator().manual_seed(0)
    kw = dict(generator=gen, device=device)
    F, O, H, FE = IN_FEATS, ZOO_OUT, ZOO_HEADS, ZOO_EDGE_FEATS

    def lin(a, b):
        m = nn.Linear(a, b)
        with torch.no_grad():
            nn.init.xavier_uniform_(m.weight, generator=gen)
            m.bias.zero_()
        return m

    return [
        ("GATv2Conv", c.GATv2Conv(F, O // H, H, **kw), (), (0, 1)),
        ("DotGatConv", c.DotGatConv(F, O // H, H, **kw), (), (0, 1)),
        ("AGNNConv", c.AGNNConv(device=device), (), (0, 1)),
        ("EGATConv", c.EGATConv(F, FE, O // H, FE, H, **kw), ("e",),
         (0, 1)),
        ("EdgeGATConv", c.EdgeGATConv(F, FE, O // H, H, **kw), ("e",),
         (0, 1)),
        ("GINConv sum", c.GINConv(lin(F, O), "sum", learn_eps=True,
                                  device=device), (), (1, 0)),
        ("GINEConv", c.GINEConv(lin(F, O), learn_eps=True, device=device),
         ("e128",), (0, 1)),
        ("EdgeConv", c.EdgeConv(F, O, **kw), (), (0, 0)),
        ("SGConv k=2", c.SGConv(F, O, k=2, **kw), (), (2, 0)),
        ("APPNPConv k=10", c.APPNPConv(), (), (10, 0)),
        ("TAGConv k=2", c.TAGConv(F, O, k=2, **kw), (), (2, 0)),
        ("ChebConv k=3", c.ChebConv(F, O, k=3, **kw), (), (2, 0)),
        ("GCN2Conv", c.GCN2Conv(F, layer=1, **kw), ("x0",), (1, 0)),
        ("GCN2Conv weighted", c.GCN2Conv(F, layer=1, **kw), ("x0", "w"),
         (0, 1)),
        ("GatedGraphConv", c.GatedGraphConv(F, O, 2, n_etypes=3, **kw),
         ("t",), (0, 2)),
        ("NNConv 16-16 mean", c.NNConv(
            NNCONV_FEATS, NNCONV_FEATS, lin(FE, NNCONV_FEATS ** 2), "mean",
            **kw), ("x16", "e"), (0, 1)),
        ("GMMConv sum", c.GMMConv(F, O, 2, 4, "sum", **kw), ("p",), (0, 1)),
        ("GMMConv mean", c.GMMConv(F, O, 2, 4, "mean", **kw), ("p",),
         (0, 1)),
        ("GMMConv max", c.GMMConv(F, O, 2, 4, "max", **kw), ("p",), (0, 0)),
        ("CFConv", c.CFConv(F, FE, O, O, **kw), ("e",), (0, 1)),
        ("PNAConv", c.PNAConv(F, O, ("mean", "max", "min", "std"),
                              ("identity", "amplification", "attenuation"),
                              **kw), (), (3, 0)),
        ("PNAConvTower", c.PNAConvTower(F, O, **kw), (), (3, 0)),
        ("DGNConv", c.DGNConv(F, O, ("mean", "dir1-av", "dir1-dx"), **kw),
         ("eig",), (1, 3)),
        # relu looked up at call time, so the plain pass can follow the
        # planned pass's ReLU pattern (relu_pattern)
        ("GatedGCNConv", c.GatedGCNConv(F, FE, O, activation=lambda t:
                                        torch.relu(t), **kw), ("e",),
         (0, 2)),
        ("TWIRLSConv attention", c.TWIRLSConv(F, O, O, prop_step=4,
                                              attention=True, **kw), (),
         (3, 1)),
        ("AtomicConv", c.AtomicConv(*ATOMIC_RBF, ATOMIC_TYPES),
         ("atoms", "d"), (0, 1)),
        ("EGNNConv", c.EGNNConv(F, O, O, edge_feat_size=FE, **kw),
         ("coord", "e"), (0, 2)),
        ("GroupRevRes GraphConv", c.GroupRevRes(
            lambda i: c.GraphConv(F // 2, F // 2, **kw), 2), (), (2, 0)),
    ]


def zoo_inputs(n, e, device="cuda"):
    """The zoo's inputs a kind, made with numpy from a seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(6)

    def put(a):
        return torch.from_numpy(a).to(device)

    return {"e": put(rng.standard_normal((e, ZOO_EDGE_FEATS),
                                         dtype=np.float32)),
            "e128": put(rng.standard_normal((e, IN_FEATS),
                                            dtype=np.float32)),
            "w": put((rng.random(e) + 0.5).astype(np.float32)),
            "x0": put(rng.standard_normal((n, IN_FEATS), dtype=np.float32)),
            "t": put(rng.integers(0, 3, e).astype(np.int64)),
            "p": put(rng.uniform(-1, 1, (e, 2)).astype(np.float32)),
            "eig": put(rng.standard_normal((n, 3), dtype=np.float32)),
            "coord": put(rng.standard_normal((n, 3), dtype=np.float32)),
            "d": put(rng.uniform(0.5, 8.0, (e, 1)).astype(np.float32)),
            "atoms": put(rng.choice(np.array(ATOMIC_TYPES, np.float32),
                                    (n, 1)))}


# the zoo's convs that reduce with max or min (over the shell plan's bf16
# rows), and of those the ones with PNA's std
ZOO_MAX = ("EdgeConv", "GMMConv max", "PNAConv", "PNAConvTower")
ZOO_STD = ("PNAConv", "PNAConvTower")


@contextlib.contextmanager
def following_plan_max(plan):
    """Within the block, the plain path's max and min g-SpMM pick each
    destination's messages as the shell ``plan`` picks them, and return
    the picked messages computed in f32.

    The plan takes the arg-extremum of messages computed in bf16, so where
    two messages lie within a bf16 step of each other it may pick the
    other one, and where they round to one value it splits the pick among
    them in the order of its reductions: either moves that destination's
    gradient to other edges, a difference of the pick, not of the
    gradient (as ``check_grads`` follows the plan path's ReLU pattern).
    The picks are the gradient of the plan's own ``copy_rhs`` extremum of
    the bf16 messages; the result is the same piecewise-linear function as
    the plain path's, on the plan path's pieces."""
    import torch

    from dgl_tpu_torch.ops import shell_spmm, spmm

    plain = spmm._gspmm_cmp

    def follow(op, reduce_op, rel, u, e):
        if rel.num_edges != rel.num_edges_padded:
            raise RuntimeError("following_plan_max takes no padded edges")
        src = rel.src.to(torch.int64)

        def messages(uu, ee):
            ul = None if uu is None else uu.index_select(0, src)
            if ul is not None and ee is not None:
                nd = max(ul.dim(), ee.dim())
                ul, ee = spmm._expand(ul, nd), spmm._expand(ee, nd)
            return spmm._binary(op, ul, ee)

        bf = torch.bfloat16
        m = messages(u, e)  # eid order, f32
        mb = messages(None if u is None else u.to(bf),
                      None if e is None else e.to(bf)).float().detach()
        mb.requires_grad_()
        with torch.enable_grad():
            picked = shell_spmm.shell_gspmm_cmp(
                "copy_rhs", reduce_op, plan, None, mb, rel.in_degrees())
            pick, = torch.autograd.grad(picked.sum(), mb)
        dst = rel.dst.to(torch.int64)
        return m.new_zeros((rel.num_dst,) + tuple(m.shape[1:])).index_add(
            0, dst, m * pick)

    spmm._gspmm_cmp = follow
    try:
        yield
    finally:
        spmm._gspmm_cmp = plain


@contextlib.contextmanager
def following_plan_rounding():
    """Within the block, the plain path's ``copy_u`` sums and means round
    the source table to bf16, and the gradient that flows back to it to
    bf16, as the hub plan does (its kernel gathers bf16 rows, its
    backward bf16 rows of ``dz``); the sums stay f32.

    PNA's ``std`` is ``sqrt(max(mu2 - mu^2, 0) + 1e-30)``, whose slope is
    about 5e14 where the variance is 0. At a node with one distinct
    in-neighbour row the exact variance is 0, while the plan's, from
    bf16 rows, is ``bf16(x^2) - bf16(x)^2``: the plan clamps it or keeps a
    rounding residue, and its gradient there is that residue times the
    slope (1e11 and more), a difference of the rounding, not of the
    gradient. With the plan's roundings the plain path's variances, and
    so its clamp pattern, are the plan's, and it computes the plan path's
    function with sums in another order."""
    import torch

    from dgl_tpu_torch.ops import spmm

    class Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.to(torch.bfloat16).to(t.dtype)

        @staticmethod
        def backward(ctx, grad):
            return grad.to(torch.bfloat16).to(grad.dtype)

    plain = spmm._gspmm_sum

    def rounded(op, rel, u, e):
        return plain(op, rel, Round.apply(u) if op == "copy_lhs" else u, e)

    spmm._gspmm_sum = rounded
    try:
        yield
    finally:
        spmm._gspmm_sum = plain


def zoo_args(x, kinds, inputs):
    """A zoo conv's input (``x``, or its first 16 columns for ``"x16"``),
    its other positional inputs and its keyword inputs."""
    x = x[:, :NNCONV_FEATS] if "x16" in kinds else x
    x = inputs["atoms"] if "atoms" in kinds else x
    args = [inputs[k] for k in kinds if k not in ("w", "x16", "atoms")]
    kw = {"edge_weight": inputs["w"]} if "w" in kinds else {}
    return x, args, kw


def zoo_pass(mod, graph, x, kinds, inputs, cot_seed, pattern=None):
    """One forward and one backward of ``sum(out * cot)`` (cotangents of
    the output shapes, seeded): the outputs, the gradients of the input
    and of every parameter, the launches of each half and the forward's
    ReLU pattern (``relu_pattern``; following ``pattern`` when given)."""
    import torch

    from dgl_tpu_torch import _kernels

    x, args, kw = zoo_args(x, kinds, inputs)
    x = x.detach().clone().requires_grad_()
    mod.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    with relu_pattern(pattern) as seen:
        outs = mod(graph, x, *args, **kw)
    torch.cuda.synchronize()
    fwd = dict(_kernels.launch_counts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator(device=x.device).manual_seed(cot_seed)
    loss = sum((o * torch.randn(o.shape, generator=gen, device=o.device)
                ).sum() for o in outs)
    _kernels.reset_launch_counts()
    if loss.requires_grad:  # AtomicConv: no parameter, atoms compared
        loss.backward()
    torch.cuda.synchronize()
    bwd = dict(_kernels.launch_counts)
    tensors = {f"out{i}": o.detach() for i, o in enumerate(outs)}
    tensors["dx"] = torch.zeros_like(x) if x.grad is None else x.grad
    for k, p in mod.named_parameters():
        tensors[f"grad {k}"] = (torch.zeros_like(p) if p.grad is None
                                else p.grad)
    return tensors, fwd, bwd, seen


def run_conv_zoo(gp, g, x, tag: dict) -> dict:
    """Each conv of ``zoo_convs`` at in 128 and out 256 (4 heads of 64)
    on the weighted graph's plans (``gp``: the hub plan and the bf16 shell
    plan) and on the same graph without a plan (``g``), on the card: one
    forward and one backward each, the launches counted around each half
    (on ``gp`` the forward's B1 and B1w launches must be the table's, on
    ``g`` none), every output and gradient of ``gp`` against ``g``'s at
    rtol = 2e-2, atol = 2e-2 * max|ref| per tensor, ``g``'s pass
    following the planned pass's ReLU pattern (``relu_pattern``, as
    ``check_grads`` does), the max convs' also its picks
    (``following_plan_max``), PNA's also its roundings
    (``following_plan_rounding``); the error against ``g``'s pass on its
    own pattern is reported beside it), and the forward's time on both
    graphs. Returns
    each conv's forward launches on ``gp``."""
    import torch

    rel = gp._relation()
    inputs = zoo_inputs(rel.num_src, rel.num_edges_padded, x.device.type)
    launches = {}
    t_phase = time.perf_counter()
    for i, (name, mod, kinds, (n_b1, n_b1w)) in enumerate(zoo_convs(
            x.device.type)):
        mod.eval()
        got, fwd, bwd, pattern = zoo_pass(mod, gp, x, kinds, inputs, i)
        expect_no_other_launch(fwd, {"shell_prefix_sum": n_b1,
                                     "shell_prefix_gspmm": n_b1w},
                               f"{name} on the planned graph")
        ref, fwd_plain, bwd_plain, _p = zoo_pass(mod, g, x, kinds, inputs,
                                                 i)
        expect_no_other_launch(fwd_plain, {}, f"{name} without a plan")
        expect_no_other_launch(bwd_plain, {}, f"{name}'s backward without "
                               "a plan")
        own = None
        if name in ZOO_MAX or pattern:  # on the plan path's pieces
            own = ref
            with contextlib.ExitStack() as stack:
                if name in ZOO_MAX:  # its picks
                    stack.enter_context(following_plan_max(rel.shell_plan))
                if name in ZOO_STD:  # and PNA's std on its roundings
                    stack.enter_context(following_plan_rounding())
                ref, _f, _b, _p = zoo_pass(mod, g, x, kinds, inputs, i,
                                           pattern or None)
        errs = {}
        for k, r in ref.items():
            scale = r.abs().max().item()
            err = (got[k] - r).abs().max().item()
            if not torch.allclose(got[k], r, rtol=2e-2, atol=2e-2 * scale):
                raise RuntimeError(f"{name} planned vs plain, {k}: max abs "
                                   f"err {err} (max |ref| {scale})")
            errs[k] = err / max(scale, 1e-30)
        xi, args, kw = zoo_args(x, kinds, inputs)
        with torch.inference_mode():
            ms = {"planned": time_ms(lambda: mod(gp, xi, *args, **kw), 3),
                  "plain": time_ms(lambda: mod(g, xi, *args, **kw), 3)}
        launches[name] = {"shell_prefix_sum": n_b1,
                          "shell_prefix_gspmm": n_b1w}
        extra = {}
        if own is not None:  # the plain path on its own pieces
            extra["max_rel_err_vs_plain_own_pattern"] = max(
                (got[k] - r).abs().max().item()
                / max(r.abs().max().item(), 1e-30) for k, r in own.items())
        emit({"phase": "conv_zoo", "conv": name, **extra,
              "forward_launches": {k: v for k, v in fwd.items() if v},
              "backward_launches": {k: v for k, v in bwd.items() if v},
              "forward_ms": ms, "max_rel_err_vs_plain": max(errs.values()),
              "worst": max(errs, key=errs.get),
              "tolerance": "rtol=2e-2, atol=2e-2*max|ref| per tensor",
              **tag})
        del mod, got, ref
        torch.cuda.empty_cache()
    emit({"phase": "conv_zoo_total", "convs": len(launches),
          "seconds": time.perf_counter() - t_phase, **tag})
    return launches


# ---------------------------------------------------------------------------
# R-GCN on ogbn-mag (B1's hub caller on bipartite relations)
# ---------------------------------------------------------------------------

# ogbn-mag's published counts (OGB): nodes by type, edges by relation, in
# the order of dgl_tpu/data/synthetic.py:324-395's generator
MAG_NODES = {"paper": 736_389, "author": 1_134_649, "institution": 8_740,
             "field": 59_965}
MAG_EDGES = {("paper", "cites", "paper"): 5_416_271,
             ("author", "writes", "paper"): 7_145_660,
             ("author", "affiliated_with", "institution"): 1_043_998,
             ("paper", "has_topic", "field"): 7_505_078}
# 128-wide features (ogbn-mag's paper features), 349 venues; OGB's R-GCN
# baseline for ogbn-mag: hidden_channels=64, num_layers=2
MAG_FEAT, MAG_HIDDEN, MAG_CLASSES = 128, 64, 349
MAG_RGCN_DIV = 8  # the homogeneous RGCN cell's cut of every count


def mag_graph(div: int = 1, seed: int = 0):
    """The ogbn-mag-shaped heterograph of ``dgl_tpu/data/synthetic.py:
    324-395`` (``synthetic_hetero_graph``) at ogbn-mag's counts divided by
    ``div``, vectorised: 75 % of the citations go to a paper of the
    citing paper's class, paper features are Gaussian class centroids
    times 2 plus unit noise, the other types' unit noise, and a 60/20/20
    split of the papers. The recipe is the reference's; its draws are not
    (the reference loops over the citations in Python). Returns the edge
    lists, node counts, features, labels and masks as numpy arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nodes = {nt: round(n / div) for nt, n in MAG_NODES.items()}
    n_paper = nodes["paper"]
    labels = rng.integers(0, MAG_CLASSES, n_paper)
    order = np.argsort(labels, kind="stable")
    starts = np.searchsorted(labels[order], np.arange(MAG_CLASSES + 1))
    data = {}
    for cet, ne in MAG_EDGES.items():
        st, _, dt = cet
        ne = round(ne / div)
        src = rng.integers(0, nodes[st], ne)
        if st == dt == "paper":
            c = labels[src]  # every class a citing paper has is non-empty
            lo, hi = starts[c], starts[c + 1]
            pick = order[lo + (rng.random(ne) * (hi - lo)).astype(np.int64)]
            dst = np.where(rng.random(ne) < 0.75, pick,
                           rng.integers(0, n_paper, ne))
        else:
            dst = rng.integers(0, nodes[dt], ne)
        data[cet] = (src, dst)
    centroids = rng.standard_normal((MAG_CLASSES, MAG_FEAT),
                                    dtype=np.float32) * 2.0
    feats = {"paper": centroids[labels] + rng.standard_normal(
        (n_paper, MAG_FEAT), dtype=np.float32)}
    for nt, n in nodes.items():
        if nt != "paper":
            feats[nt] = rng.standard_normal((n, MAG_FEAT), dtype=np.float32)
    perm = rng.permutation(n_paper)
    n_train, n_val = int(n_paper * 0.6), int(n_paper * 0.2)
    masks = {}
    for name, sl in (("train_mask", perm[:n_train]),
                     ("val_mask", perm[n_train:n_train + n_val]),
                     ("test_mask", perm[n_train + n_val:])):
        masks[name] = np.zeros(n_paper, bool)
        masks[name][sl] = True
    return {"data": data, "nodes": nodes, "feats": feats, "labels": labels,
            "masks": masks}


def hetero_rgcn(etypes, dims, seed):
    """The R-GCN of ``examples/rgcn_hetero.py:16-37`` as user code: two
    ``HeteroGraphConv(aggregate="sum")`` layers of
    ``GraphConv(allow_zero_in_degree=True)``, one a relation, ReLU between
    them, widths ``dims``; the paper logits out (its ``["paper"]``).
    Weights from ``seed``."""
    import torch
    from torch import nn

    from dgl_tpu_torch.nn import GraphConv, HeteroGraphConv

    class _Model(nn.Module):
        def __init__(self):
            super().__init__()
            gen = torch.Generator().manual_seed(seed)
            self.layer0 = HeteroGraphConv(
                {et: GraphConv(dims[0], dims[1], allow_zero_in_degree=True,
                               generator=gen) for et in etypes},
                aggregate="sum")
            self.layer1 = HeteroGraphConv(
                {et: GraphConv(dims[1], dims[2], allow_zero_in_degree=True,
                               generator=gen) for et in etypes},
                aggregate="sum")

        def forward(self, graph, inputs):
            h = {k: torch.relu(v)
                 for k, v in self.layer0(graph, inputs).items()}
            return self.layer1(graph, h)["paper"]

    return _Model()


def hgt_model(ntypes, in_feats, head_size, heads, num_etypes, classes,
              n_out, dropout=0.2, seed=0, device="cuda"):
    """The HGT of DGL's example (``examples/pytorch/hgt/model.py``,
    ``train_acm.py``) as user code of the port's modules: a
    ``HeteroLinear`` input adapter a node type into ``heads * head_size``
    and GELU (the exact, erf form, torch's default), the node types
    concatenated in ``ntypes`` (``to_homogeneous``'s) order, two
    ``HGTConv`` layers with ``use_norm``, and ``out``, an ``nn.Linear`` to
    ``classes`` on the first ``n_out`` rows (the paper rows).
    ``forward(graph, feats, ntype, etype)``. Weights from ``seed``."""
    import torch
    from torch import nn

    from dgl_tpu_torch.nn import HeteroLinear, HGTConv

    class _Model(nn.Module):
        def __init__(self):
            super().__init__()
            gen = torch.Generator().manual_seed(seed)
            hid = heads * head_size
            self.adapt = HeteroLinear({nt: in_feats for nt in ntypes}, hid,
                                      generator=gen, device=device)
            for i in range(2):
                self.add_module(f"layer{i}", HGTConv(
                    hid, head_size, heads, len(ntypes), num_etypes,
                    dropout=dropout, use_norm=True, generator=gen,
                    device=device))
            self.out = nn.Linear(hid, classes)
            with torch.no_grad():
                nn.init.xavier_uniform_(self.out.weight, generator=gen)
                self.out.bias.zero_()
            self.out.to(device)

        def forward(self, graph, feats, ntype, etype):
            h = self.adapt(feats)
            h = torch.cat([nn.functional.gelu(h[nt]) for nt in ntypes])
            h = self.layer0(graph, h, ntype, etype)
            h = self.layer1(graph, h, ntype, etype)
            return self.out(h[:n_out])

    return _Model()


def run_mag_core(gp, g, x, tag) -> dict:
    """``multi_update_all`` over the four relations (one B1 launch each)
    and one ``pull``, on the plan graph and counted, each held against the
    plain branch on the graph without plans at rtol = 2e-2,
    atol = 2e-2 * max|ref|."""
    import torch

    import dgl_tpu_torch.function as fn
    from dgl_tpu_torch import _kernels

    out = {}
    for what, graph in (("plan", gp), ("plain", g)):
        with graph.local_scope(), torch.inference_mode():
            graph.ndata["h"] = x
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            graph.multi_update_all(
                {cet: (fn.copy_u("h", "m"), fn.sum("m", "o"))
                 for cet in graph.canonical_etypes}, "sum")
            torch.cuda.synchronize()
            multi = dict(_kernels.launch_counts)
            rows = torch.arange(0, graph.num_nodes("paper"), 7,
                                device=x["paper"].device)
            _kernels.reset_launch_counts()
            graph.pull(rows, fn.copy_u("h", "m"), fn.sum("m", "p"),
                       etype="writes")
            torch.cuda.synchronize()
            pull = dict(_kernels.launch_counts)
            out[what] = ({nt: graph.nodes[nt].data["o"]
                          for nt in ("paper", "institution", "field")},
                         graph.nodes["paper"].data["p"], multi, pull)
    expect_no_other_launch(out["plan"][2], {"shell_prefix_sum": 4},
                           "multi_update_all over the hub plans")
    expect_no_other_launch(out["plan"][3], {"shell_prefix_sum": 1},
                           "pull over the writes hub plan")
    expect_no_other_launch(out["plain"][2], {}, "the plain multi_update_all")
    errs = {}
    pairs = [(f"multi_update_all {nt}", out["plan"][0][nt],
              out["plain"][0][nt]) for nt in out["plan"][0]]
    pairs.append(("pull writes", out["plan"][1], out["plain"][1]))
    for what, got, ref in pairs:
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        if not torch.allclose(got, ref, rtol=2e-2, atol=2e-2 * scale):
            raise RuntimeError(f"{what} vs the plain branch: max abs err "
                               f"{err} (max |ref| {scale})")
        errs[what] = err / scale
    result = {"multi_update_all_launches": out["plan"][2],
              "pull_launches": out["plan"][3], "max_rel_err_vs_plain": errs}
    emit({"phase": "mag_core", "tolerance": "rtol=2e-2, atol=2e-2*max|ref|",
          **result, **tag})
    return result


def run_mag(rate: float, tag: dict) -> dict:
    """R-GCN on ogbn-mag at its published counts and widths, over hub
    plans on every relation (B1 on bipartite relations); returns B1's
    entry of the kernel table for this path."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.ops import hub_spmm

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mag = mag_graph()
    data_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    g = dt.heterograph(mag["data"], mag["nodes"])
    graph_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    gp = g.with_spmm_plans(num_hubs=2048)  # int8 hubs
    torch.cuda.synchronize()
    plans_s = time.perf_counter() - t1
    x = {nt: torch.from_numpy(v).cuda() for nt, v in mag["feats"].items()}
    y = torch.from_numpy(mag["labels"]).cuda()
    mask = torch.from_numpy(mag["masks"]["train_mask"]).float().cuda()
    etypes = g.etypes
    plans = {}
    for cet, rel in gp._relations.items():
        p = rel.hub_plan
        if p is None or rel.bitmap_plan is not None or (
                rel.dense_adj is not None):
            raise RuntimeError(f"{cet}: the plans are not the hub plan alone")
        plans[cet[1]] = {
            "num_src": p.num_src, "num_dst": p.num_dst, "hubs": p.num_hubs,
            "coverage": p.coverage, "precision": p.precision,
            "a_hub_gb": p.a_hub.numel() * p.a_hub.element_size() / 1e9,
            "shell_levels": len(p.shell_rows),
            "reverse_shell_levels": len(p.rev_shell_rows),
            "residual": p.res_dst is not None,
            "reverse_residual": p.res_src is not None}
    del mag
    model = hetero_rgcn(etypes, (MAG_FEAT, MAG_HIDDEN, MAG_CLASSES),
                        0).cuda().eval()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    emit({"phase": "mag_graph", "nodes": dict(g._num_src_nodes),
          "edges": {c[1]: g.num_edges(c) for c in g.canonical_etypes},
          "data_s": data_s, "graph_s": graph_s, "plans_s": plans_s,
          "setup_s": setup_s, "plans": plans, **tag})

    # the main path: one counted forward (4 relations in layer 0, 2 in
    # layer 1: author has no input there)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        out = model(gp, x)
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    expect_no_other_launch(launches, {"shell_prefix_sum": 6},
                           "the R-GCN forward")
    with torch.inference_mode():
        ref = model(g, x)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    if (tuple(out.shape) != (MAG_NODES["paper"], MAG_CLASSES)
            or not torch.isfinite(out).all()
            or not torch.allclose(out, ref, rtol=2e-2, atol=2e-2 * scale)):
        raise RuntimeError(f"R-GCN hub path vs exact f32 path: max abs err "
                           f"{err} (max |ref| {scale}), shape "
                           f"{tuple(out.shape)}")
    emit({"phase": "mag_main_path", "model": "HeteroGraphConv(GraphConv) "
          "R-GCN 128-64-349, 2 layers", "launches": launches,
          "expected_shell_prefix_sum": 6, "peak_memory_gib": peak,
          "max_abs_err_vs_exact_f32": err, "max_rel_err": err / scale,
          "tolerance": "rtol=2e-2, atol=2e-2*max|ref|", **tag})
    del out, ref

    # gradients against the exact path, then one counted step: 3 backward
    # launches (layer 1's cites, layer 0's cites and writes; institution
    # and field reach no loss)
    model.train()
    grad_check = check_grads(model, gp, g, x, y, mask, "R-GCN")
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    want = {c[1]: gp._relations[c].hub_plan for c in gp.canonical_etypes}
    tables = {"writes": want["writes"], "affiliated_with":
              want["affiliated_with"]}
    with recording(hub_spmm, "shell_prefix_sum") as rec:
        loss, step_launches, step_peak, step_s = counted_step(
            model, opt, gp, x, y, mask, {"shell_prefix_sum": 9}, "R-GCN")
    expect_no_other_launch(step_launches, {"shell_prefix_sum": 9},
                           "the R-GCN step")
    losses = run_steps(model, opt, gp, x, y, mask, loss, falling=True)
    emit({"phase": "mag_train_main_path", "launches": step_launches,
          "expected_shell_prefix_sum": 9, "peak_memory_gib": step_peak,
          "first_step_s": step_s, "losses": losses,
          "grads_vs_exact_f32": grad_check, **tag})

    # B1 against its plain version on the two extremes' real tables:
    # writes (1.13M author rows into 736,389 papers) both ways, and
    # affiliated_with (into 8,740 institutions, fewer than the hubs)
    # forward; its backward never runs on the path (institution reaches
    # no loss), so a seeded table of dz's shape stands in
    found = {}
    for args, _kw in rec:
        for et, p in tables.items():
            if args[1] is p.shell_idx:
                found[f"{et} fwd"] = (p, False, args[0])
            elif args[1] is p.rev_shell_idx:
                found[f"{et} bwd"] = (p, True, args[0])
    del rec
    aff = tables["affiliated_with"]
    dz = np.random.default_rng(7).standard_normal((aff.num_dst, MAG_HIDDEN),
                                                  dtype=np.float32)
    found["affiliated_with bwd (seeded dz)"] = (
        aff, True, torch.from_numpy(dz).cuda().to(torch.bfloat16))
    if sorted(found) != sorted(["writes fwd", "writes bwd",
                                "affiliated_with fwd",
                                "affiliated_with bwd (seeded dz)"]):
        raise RuntimeError(f"recorded B1 calls: {sorted(found)}")
    shapes = {}
    with torch.inference_mode():
        for label, (p, reverse, xg) in found.items():
            shapes[label] = check_b1(p, reverse, xg.contiguous(),
                                     cold_bags(p, reverse), rate)
            emit({"phase": "kernel_vs_plain", "kernel": "shell_prefix_sum",
                  "shape": f"mag {label} F={xg.shape[1]}", **shapes[label],
                  **tag})
    del found

    core = run_mag_core(gp, g, x, tag)
    model.eval()
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(gp, x), 5)
        exact_ms = time_ms(lambda: model(g, x), 3)
        prof = device_profile(lambda: model(gp, x), 3)
    model.train()
    step = lambda: train_step(model, opt, gp, x, y, mask)  # noqa: E731
    timing = {"forward_ms": fwd_ms, "exact_f32_path_forward_ms": exact_ms,
              "step_ms": time_ms(step, 3)}
    emit({"phase": "mag_timing", **timing, **tag})
    emit({"phase": "mag_forward_profile", "calls": 3, **prof, **tag})
    emit({"phase": "mag_train_profile", "calls": 2,
          **device_profile(step, 2), **tag})
    t0 = time.perf_counter()
    train_ids = torch.nonzero(mask).flatten().cpu().numpy()
    del gp, opt
    torch.cuda.empty_cache()
    run_mag_minibatch(g, x, y, train_ids, tag)
    run_mag_etype_sampler(g, tag)
    run_explain_rgcn(g, x, tag)
    emit({"phase": "mag_samplers_total", "seconds": time.perf_counter() - t0,
          **tag})
    main = shapes["writes fwd"]
    return {
        "name": "shell_prefix_sum",
        "route": "cuda",
        "source": "dgl_tpu_torch/csrc/shell_prefix_sum.cu",
        "replaces": "dgl_tpu/ops/shell_pallas.py:110",
        "launches": launches["shell_prefix_sum"],
        "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shape": f"R-GCN ogbn-mag, writes fwd F={MAG_HIDDEN}, n_out="
                 f"{MAG_NODES['paper']}, times per call; launches: the "
                 "R-GCN forward",
        "launches_train_step": step_launches["shell_prefix_sum"],
        "shapes": {k: {f: v[f] for f in ("F", "n_out", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms", "max_abs_err")}
                   for k, v in shapes.items()},
        "forward_ms": fwd_ms, "train_step_ms": timing["step_ms"],
        "core": core,
    }


def run_rgcn_homogeneous(tag: dict) -> dict:
    """``RGCN(128, 64, 349, num_rels=4, num_bases=2)`` over
    ``to_homogeneous`` of the ogbn-mag recipe with every count divided by
    ``MAG_RGCN_DIV`` (no plan, no hand kernel: every count must stay 0),
    one forward and one step held against the same model on the CPU at
    rtol = 1e-4, atol = 1e-4 * max|ref|."""
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.models import RGCN

    t0 = time.perf_counter()
    mag = mag_graph(MAG_RGCN_DIV, seed=1)
    hg = dt.heterograph(mag["data"], mag["nodes"], device="cpu")
    homo = dt.to_homogeneous(hg)
    x = torch.cat([torch.from_numpy(mag["feats"][nt]) for nt in hg.ntypes])
    etypes = homo.edata[dt.ETYPE]
    n_paper = mag["nodes"]["paper"]  # paper is the first type
    y = torch.from_numpy(mag["labels"])
    mask = torch.from_numpy(mag["masks"]["train_mask"]).float()
    del mag, hg
    gen = torch.Generator().manual_seed(0)
    cpu = RGCN(MAG_FEAT, MAG_HIDDEN, MAG_CLASSES, num_rels=4, num_bases=2,
               generator=gen, device="cpu")
    card = RGCN(MAG_FEAT, MAG_HIDDEN, MAG_CLASSES, num_rels=4, num_bases=2)
    card.load_state_dict(cpu.state_dict())
    homo_c = homo.to("cuda")
    xc, ec, yc, mc = x.cuda(), etypes.cuda(), y.cuda(), mask.cuda()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def step(model, graph, xx, ee, yy, mm):
        model.zero_grad(set_to_none=True)
        out = model(graph, xx, ee)
        loss = masked_loss(out[:n_paper], yy, mm)
        loss.backward()
        return out.detach(), loss.detach(), {
            k: p.grad for k, p in model.named_parameters()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        fwd = card(homo_c, xc, ec)
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    expect_no_other_launch(launches, {}, "the homogeneous RGCN forward")
    fwd_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    out_c, loss_c, grads_c = step(card, homo_c, xc, ec, yc, mc)
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    t1 = time.perf_counter()
    out, loss, grads = step(cpu, homo, x, etypes, y, mask)
    cpu_s = time.perf_counter() - t1
    errs = {}
    pairs = [("forward", fwd, out), ("train forward", out_c, out),
             ("loss", loss_c, loss)] + [(f"grad {k}", grads_c[k], v)
                                         for k, v in grads.items()]
    for what, got, ref in pairs:
        got = got.cpu()
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        if not torch.allclose(got, ref, rtol=1e-4, atol=1e-4 * scale):
            raise RuntimeError(f"RGCN on the card vs the CPU, {what}: max "
                               f"abs err {err} (max |ref| {scale})")
        errs[what] = err / max(scale, 1e-30)
    opt = torch.optim.Adam(card.parameters(), lr=LR)
    train = lambda: train_step(  # noqa: E731
        _Sliced(card, ec, n_paper), opt, homo_c, xc, yc, mc)
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: card(homo_c, xc, ec), 3)
    result = {"nodes": homo.num_nodes(), "edges": homo.num_edges(),
              "setup_s": setup_s, "launches": launches,
              "forward_ms": fwd_ms, "step_ms": time_ms(train, 3),
              "forward_peak_memory_gib": fwd_peak,
              "step_peak_memory_gib": step_peak, "cpu_step_s": cpu_s,
              "max_rel_err_vs_cpu": errs}
    emit({"phase": "rgcn_homogeneous", "model": "RGCN 128-64-349, 4 "
          "relations, 2 bases, self-loop", "cut": f"every ogbn-mag count / "
          f"{MAG_RGCN_DIV}", "tolerance": "rtol=1e-4, atol=1e-4*max|ref|",
          **result, **tag})
    emit({"phase": "rgcn_homogeneous_train_profile", "calls": 2,
          **device_profile(train, 2), **tag})
    return result


class _Sliced:
    """``model(graph, x, etypes)[:n]`` as ``train_step`` calls a model."""

    def __init__(self, model, etypes, n):
        self.model, self.etypes, self.n = model, etypes, n

    def __call__(self, graph, x):
        return self.model(graph, x, self.etypes)[:self.n]


# ---------------------------------------------------------------------------
# HGT on ogbn-mag (no hand kernel: the reference's route is XLA)
# ---------------------------------------------------------------------------

# DGL's HGT example (examples/pytorch/hgt/train_acm.py): n_hid 256 as 4
# heads of 64, 2 layers, use_norm, dropout 0.2
HGT_HEADS, HGT_HEAD_SIZE, HGT_DROPOUT = 4, 64, 0.2
# every per-edge (E, 256) f32 tensor takes E KB: 21.6 GB at ogbn-mag's
# 21.1M edges, 2.7 GB at 1/8 (PERF.md section 4 has the reckoning)
HGT_DIV = 8
HGT_CHECK_DIV = 32  # the card-vs-CPU comparison's cut (CPU time)
HGT_STEPS = 4


class _HGTCall:
    """``model(graph, feats, ntype, etype)`` as ``train_step`` calls a
    model."""

    def __init__(self, model, ntype, etype):
        self.model, self.ntype, self.etype = model, ntype, etype

    def __call__(self, graph, feats):
        return self.model(graph, feats, self.ntype, self.etype)


def hgt_inputs(div: int, seed: int):
    """``to_homogeneous`` of the ogbn-mag recipe at 1/``div`` of its counts,
    on the CPU: the graph, per-type features, node and edge type ids, the
    paper labels and train mask, the node types and the paper count."""
    import torch

    import dgl_tpu_torch as dt

    mag = mag_graph(div, seed=seed)
    hg = dt.heterograph(mag["data"], mag["nodes"], device="cpu")
    homo = dt.to_homogeneous(hg)
    return {"graph": homo,
            "feats": {nt: torch.from_numpy(mag["feats"][nt])
                      for nt in hg.ntypes},
            "ntype": homo.ndata[dt.NTYPE], "etype": homo.edata[dt.ETYPE],
            "y": torch.from_numpy(mag["labels"]),
            "mask": torch.from_numpy(mag["masks"]["train_mask"]).float(),
            "ntypes": tuple(hg.ntypes), "n_paper": mag["nodes"]["paper"],
            "num_etypes": len(hg.canonical_etypes)}


def hgt_on(data, device):
    """``data``'s tensors and graph on ``device``."""
    return {**data, "graph": data["graph"].to(device),
            "feats": {k: v.to(device) for k, v in data["feats"].items()},
            **{k: data[k].to(device) for k in ("ntype", "etype", "y",
                                                "mask")}}


def hgt_for(data, seed=0, device="cuda"):
    return hgt_model(data["ntypes"], MAG_FEAT, HGT_HEAD_SIZE, HGT_HEADS,
                     data["num_etypes"], MAG_CLASSES, data["n_paper"],
                     dropout=HGT_DROPOUT, seed=seed, device=device)


def check_hgt_vs_cpu(tag: dict) -> dict:
    """The HGT at 1/``HGT_CHECK_DIV`` of ogbn-mag's counts on the card
    against the same model on the CPU (dropout off): one forward (every
    count 0) and one step's output, loss and gradients at rtol = 1e-4,
    atol = 1e-4 * max|ref|."""
    import torch

    from dgl_tpu_torch import _kernels

    cpu_data = hgt_inputs(HGT_CHECK_DIV, seed=2)
    data = hgt_on(cpu_data, "cuda")
    cpu = hgt_for(cpu_data, device="cpu").eval()
    card = hgt_for(data).eval()
    card.load_state_dict(cpu.state_dict())

    def step(model, d):
        model.zero_grad(set_to_none=True)
        out = model(d["graph"], d["feats"], d["ntype"], d["etype"])
        loss = masked_loss(out, d["y"], d["mask"])
        loss.backward()
        return out.detach(), loss.detach(), {
            k: p.grad for k, p in model.named_parameters()}

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        fwd = card(data["graph"], data["feats"], data["ntype"],
                   data["etype"])
    torch.cuda.synchronize()
    expect_no_other_launch(dict(_kernels.launch_counts), {},
                           "the HGT forward")
    out_c, loss_c, grads_c = step(card, data)
    t0 = time.perf_counter()
    out, loss, grads = step(cpu, cpu_data)
    cpu_s = time.perf_counter() - t0
    errs = {}
    pairs = [("forward", fwd, out), ("train forward", out_c, out),
             ("loss", loss_c, loss)] + [(f"grad {k}", grads_c[k], v)
                                         for k, v in grads.items()]
    for what, got, ref in pairs:
        got = got.cpu()
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        if not torch.allclose(got, ref, rtol=1e-4, atol=1e-4 * scale):
            raise RuntimeError(f"HGT on the card vs the CPU, {what}: max "
                               f"abs err {err} (max |ref| {scale})")
        errs[what] = err / max(scale, 1e-30)
    g = cpu_data["graph"]
    result = {"cut": f"every ogbn-mag count / {HGT_CHECK_DIV}",
              "nodes": g.num_nodes(), "edges": g.num_edges(),
              "cpu_step_s": cpu_s, "max_rel_err_vs_cpu": max(errs.values()),
              "worst": max(errs, key=errs.get)}
    emit({"phase": "hgt_vs_cpu", "tolerance": "rtol=1e-4, "
          "atol=1e-4*max|ref|", **result, **tag})
    return result


def run_hgt(tag: dict) -> dict:
    """DGL's HGT (``hgt_model``: per-type adapters into 256 and GELU, two
    ``HGTConv(256, 64, 4, 4 ntypes, 4 etypes, dropout=0.2,
    use_norm=True)``, a linear classifier to 349 on the paper rows) over
    ``to_homogeneous`` of the ogbn-mag recipe at 1/``HGT_DIV`` of its
    counts: the check against the CPU (``check_hgt_vs_cpu``), then one
    counted forward (eval; every count 0) and one counted training step
    (dropout 0.2, masked cross-entropy on the paper train split, Adam at
    1e-2; every count 0) with their peak memory, ``HGT_STEPS - 1`` more
    steps with finite, falling losses, the forward and step times and
    their profiles."""
    import torch

    from dgl_tpu_torch import _kernels

    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    check = check_hgt_vs_cpu(tag)
    t0 = time.perf_counter()
    cpu_data = hgt_inputs(HGT_DIV, seed=1)
    data = hgt_on(cpu_data, "cuda")
    model = hgt_for(data)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    g, feats = data["graph"], data["feats"]
    call = _HGTCall(model, data["ntype"], data["etype"])
    model.eval()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        out = call(g, feats)
    torch.cuda.synchronize()
    fwd_launches = dict(_kernels.launch_counts)
    fwd_peak = torch.cuda.max_memory_allocated() / 2**30
    expect_no_other_launch(fwd_launches, {}, "the HGT forward")
    if tuple(out.shape) != (data["n_paper"], MAG_CLASSES) or not (
            torch.isfinite(out).all()):
        raise RuntimeError(f"bad HGT output {tuple(out.shape)}")
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: call(g, feats), 3)
        fwd_prof = device_profile(lambda: call(g, feats), 2)
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    loss, step_launches, step_peak, _s = counted_step(
        call, opt, g, feats, data["y"], data["mask"], {}, "HGT")
    expect_no_other_launch(step_launches, {}, "the HGT training step")
    losses = [loss] + [train_step(call, opt, g, feats, data["y"],
                                  data["mask"])
                       for _ in range(HGT_STEPS - 1)]
    losses = torch.stack(losses).tolist()
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"HGT training loss not finite or not falling: "
                           f"{losses}")
    train = lambda: train_step(  # noqa: E731
        call, opt, g, feats, data["y"], data["mask"])
    step_ms = time_ms(train, 3)
    step_prof = device_profile(train, 2)
    result = {"nodes": g.num_nodes(), "edges": g.num_edges(),
              "setup_s": setup_s, "forward_launches": fwd_launches,
              "step_launches": step_launches, "forward_ms": fwd_ms,
              "step_ms": step_ms, "forward_peak_memory_gib": fwd_peak,
              "step_peak_memory_gib": step_peak, "losses": losses,
              "check": check}
    emit({"phase": "hgt", "model": "HGT 128-(4x64)x2-349, use_norm, "
          "dropout 0.2, 4 node and 4 edge types", "cut": f"every ogbn-mag "
          f"count / {HGT_DIV}", **result, **tag})
    emit({"phase": "hgt_forward_profile", "calls": 2, **fwd_prof, **tag})
    emit({"phase": "hgt_train_profile", "calls": 2, **step_prof, **tag})
    return result


# -- the sparse-matrix API and the graph utilities (phases sparse_gcn,
# gcn_recipe and batched_readout) ------------------------------------------

SPARSE_GCN_DIMS = (IN_FEATS, HIDDEN, HIDDEN, CLASSES)  # examples/sparse/gcn.py
SPARSE_OP_WIDTH, SPARSE_OP_HEADS = 16, 4
RECIPE_SEEDS, RECIPE_KHOP_SEEDS = 1024, 64
SMALL_GRAPH_NODES, SMALL_GRAPH_EDGES = 2000, 10_000  # khop/line graph
# OGB's GIN baseline for ogbg-molhiv (ogb/examples/graphproppred/mol:
# 5 layers, embedding 300, mean readout, batch 32); molhiv's mean graph:
# 25.5 nodes and 27.5 undirected edges
GIN_LAYERS, GIN_DIM, GIN_BATCH = 5, 300, 32
MOL_NODES, MOL_EDGES = 25.5, 27.5
READOUT_GRAPHS = 4096


def sparse_gcn_matrix(g):
    """DGL's sparse-API GCN matrix (``examples/sparse/gcn.py``) on ``g``'s
    device: ``gs = to_bidirected(remove_self_loop(g))``, ``A = gs.adj()``,
    ``A_hat = A + I`` (a merge of patterns on the host), ``D =
    diag(A_hat.sum(0) ** -0.5)`` and ``D @ A_hat @ D`` (two host spspmm).
    Returns ``gs`` and the matrix."""
    import dgl_tpu_torch as dt
    from dgl_tpu_torch import sparse as dsp

    gs = dt.to_bidirected(dt.remove_self_loop(g))
    A = gs.adj()
    A_hat = A + dsp.identity(A.shape, device=g.device)
    D = dsp.diag(A_hat.sum(0) ** -0.5)
    return gs, D @ A_hat @ D


def sparse_gcn_params(dims, seed: int, device):
    """Xavier-uniform weights and small biases from ``torch.Generator``
    seed ``seed``, as leaf tensors on ``device``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        bound = math.sqrt(6.0 / (a + b))
        w = (torch.rand(a, b, generator=gen) * 2 - 1) * bound
        bias = (torch.rand(b, generator=gen) * 2 - 1) * 0.1
        params.append((w.to(device).requires_grad_(),
                       bias.to(device).requires_grad_()))
    return params


def sparse_gcn_forward(A_norm, x, params):
    """``A_norm @ (X @ W) + b`` a layer, ReLU between them."""
    import torch

    h = x
    for i, (w, b) in enumerate(params):
        h = A_norm @ (h @ w) + b
        if i != len(params) - 1:
            h = torch.relu(h)
    return h


def graphconv_stack(params, device):
    """``GraphConv(norm="both")`` layers holding ``params``."""
    import torch

    from dgl_tpu_torch.nn import GraphConv

    convs = torch.nn.ModuleList(
        GraphConv(w.shape[0], w.shape[1], device=device) for w, _ in params)
    with torch.no_grad():
        for conv, (w, b) in zip(convs, params):
            conv.weight.copy_(w)
            conv.bias.copy_(b)
    return convs


def graphconv_forward(convs, g, x):
    import torch

    h = x
    for i, conv in enumerate(convs):
        h = conv(g, h)
        if i != len(convs) - 1:
            h = torch.relu(h)
    return h


def held_against(got, ref, tol: float, what: str) -> dict:
    """``held`` for one tensor of ``ref``'s shape (any devices)."""
    if tuple(got.shape) != tuple(ref.shape):
        raise RuntimeError(f"{what}: shape {tuple(got.shape)} vs "
                           f"{tuple(ref.shape)}")
    return {"max_rel_err": held({"t": got}, {"t": ref}, tol, what)["t"]}


def same_matrix(a, b, what: str) -> dict:
    """Two sparse matrices with equal indices and values within 1e-5."""
    import torch

    if a.shape != b.shape or a.nnz != b.nnz:
        raise RuntimeError(f"{what}: shape/nnz {a.shape}/{a.nnz} vs "
                           f"{b.shape}/{b.nnz}")
    for f in ("row", "col"):
        if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()):
            raise RuntimeError(f"{what}: {f} differs")
    return held_against(a.val, b.val, 1e-5, what)


def sparse_op_cases(A, seed: int = 6):
    """Every sparse op of phase a on matrix ``A`` (its device), with dense
    operands drawn from ``seed``: name -> thunk giving a tensor or a
    SparseMatrix."""
    import numpy as np
    import torch

    from dgl_tpu_torch import sparse as dsp

    n, m = A.shape
    dev = A.val.device
    rng = np.random.default_rng(seed)

    def put(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev)

    d, h = SPARSE_OP_WIDTH, SPARSE_OP_HEADS
    x1, x2 = put(n, d), put(d, m)
    b1, b2 = put(n, d, h), put(d, m, h)
    v = put(n)
    AH = dsp.val_like(A, put(A.val.shape[0], h))
    D = dsp.diag(put(n).abs() + 0.5)
    cases = {
        "softmax dim=1": lambda: dsp.softmax(A, 1),
        "softmax dim=0": lambda: dsp.softmax(A, 0),
        "sddmm": lambda: dsp.sddmm(A, x1, x2),
        f"bsddmm H={h}": lambda: dsp.bsddmm(AH, b1, b2),
        "sp_add_v": lambda: dsp.sp_add_v(A, v),
        "spspmm D @ A": lambda: dsp.spspmm(D, A),
        "coalesce": lambda: A.coalesce(),
    }
    for op in ("smax", "smin", "smean", "sprod"):
        for dim in (0, 1, None):
            cases[f"{op} dim={dim}"] = (
                lambda op=op, dim=dim: getattr(dsp, op)(A, dim))
    return cases


def matrix_to(A, device):
    """A sparse matrix moved to ``device``."""
    from dgl_tpu_torch.sparse import SparseMatrix

    return SparseMatrix(A._rel.to(device), A.val.to(device))


def run_sparse_gcn(tag: dict, device="cuda") -> dict:
    """Phase a: DGL's sparse-API GCN at ogbn-arxiv's GCN widths on the zipf
    graph; no hand kernel (the spmm's reversed relation has no plan)."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.sparse import SparseMatrix

    src, dst = zipf_graph(0)
    g = dt.graph((src, dst), num_nodes=N_NODES, device=device)
    t0 = time.perf_counter()
    gs, A_norm = sparse_gcn_matrix(g)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if not isinstance(A_norm, SparseMatrix):
        raise RuntimeError("the GCN matrix is not a SparseMatrix")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(N_NODES, IN_FEATS)).astype(np.float32)).to(device)
    y = torch.from_numpy(np.random.default_rng(4).integers(
        0, CLASSES, N_NODES)).to(device)
    mask = torch.ones(N_NODES, device=device)
    params = sparse_gcn_params(SPARSE_GCN_DIMS, 0, device)

    def loss_of(out):
        return masked_loss(out, y, mask)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    with relu_pattern() as pattern:
        out = sparse_gcn_forward(A_norm, x, params)
    loss_of(out).backward()
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    expect_no_other_launch(launches, {}, "the sparse GCN forward and "
                                         "backward")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if tuple(out.shape) != (N_NODES, CLASSES) or not torch.isfinite(
            out).all():
        raise RuntimeError(f"sparse GCN: bad output {tuple(out.shape)}")
    grads = [(w.grad.clone(), b.grad.clone()) for w, b in params]
    emit({"phase": "sparse_gcn_main_path", "model": "sparse-API GCN "
          "128-256-256-40, A_norm = D^-1/2 (A + I) D^-1/2",
          "graph": {"nodes": N_NODES, "edges": N_EDGES,
                    "bidirected_edges": gs.num_edges(),
                    "A_norm_nnz": A_norm.nnz},
          "setup_s": setup_s, "launches": launches,
          "hand_kernels": "none: spmm runs g-SpMM on the reversed relation, "
                          "which carries no plan",
          "peak_memory_gib": peak, **tag})

    # 1. the same function as GraphConv(norm="both") on gs plus self-loops,
    # on the sparse pass's ReLU pattern (a pre-activation within rounding
    # of 0 would otherwise swap a unit's gradient: see check_grads)
    gl = dt.add_self_loop(gs)
    convs = graphconv_stack(params, device)
    with relu_pattern(pattern):
        ref = graphconv_forward(convs, gl, x)
    loss_of(ref).backward()
    with torch.no_grad(), relu_pattern() as own:
        graphconv_forward(convs, gl, x)
    flips = int(sum((a != b).sum().item() for a, b in zip(pattern, own)))
    vs_conv = {"output": held_against(out, ref, 1e-4, "sparse GCN vs "
                                      "GraphConv"),
               "relu_sign_differences_own_pattern": flips}
    for i, ((gw, gb), conv) in enumerate(zip(grads, convs)):
        vs_conv[f"grad W{i}"] = held_against(gw, conv.weight.grad, 1e-4,
                                             f"sparse GCN grad W{i}")
        vs_conv[f"grad b{i}"] = held_against(gb, conv.bias.grad, 1e-4,
                                             f"sparse GCN grad b{i}")
    # 2. the same sparse GCN on the CPU, its matrix built there
    t0 = time.perf_counter()
    g_cpu = g.to("cpu")
    _, A_cpu = sparse_gcn_matrix(g_cpu)
    matrix_err = same_matrix(A_norm, A_cpu, "A_norm on the card vs the CPU")
    p_cpu = [(w.detach().cpu().requires_grad_(),
              b.detach().cpu().requires_grad_()) for w, b in params]
    with relu_pattern([m.cpu() for m in pattern]):
        out_cpu = sparse_gcn_forward(A_cpu, x.cpu(), p_cpu)
    masked_loss(out_cpu, y.cpu(), mask.cpu()).backward()
    vs_cpu = {"A_norm": matrix_err,
              "output": held_against(out, out_cpu, 1e-4, "sparse GCN vs "
                                     "the CPU")}
    for i, ((gw, gb), (w, b)) in enumerate(zip(grads, p_cpu)):
        vs_cpu[f"grad W{i}"] = held_against(gw, w.grad, 1e-4,
                                            f"CPU grad W{i}")
        vs_cpu[f"grad b{i}"] = held_against(gb, b.grad, 1e-4,
                                            f"CPU grad b{i}")
    emit({"phase": "sparse_gcn_checks", "vs_graphconv_both": vs_conv,
          "vs_cpu": vs_cpu, "cpu_s": time.perf_counter() - t0,
          "tolerance": "rtol=1e-4, atol=1e-4*max|ref| (the same f32 sums "
                       "in another order), on the sparse pass's ReLU "
                       "pattern", **tag})
    del convs, ref, gl, out_cpu, p_cpu, pattern, own

    # 3. every sparse op, the card against the CPU, and its time
    ops, on_cpu = sparse_op_cases(A_norm), sparse_op_cases(A_cpu)
    op_results = {}
    for name, fn in ops.items():
        got, want = fn(), on_cpu[name]()
        if isinstance(got, SparseMatrix):
            err = same_matrix(got, want, name)
        else:
            err = held_against(got, want, 1e-5, name)
        host = name.startswith(("spspmm", "coalesce"))
        op_results[name] = {**err, "ms": time_ms(fn, 2 if host else 10,
                                                 warmup=1)}
    emit({"phase": "sparse_ops", "matrix": "A_norm", "nnz": A_norm.nnz,
          "width": SPARSE_OP_WIDTH, "ops": op_results,
          "tolerance": "indices exact, values rtol=1e-5, "
                       "atol=1e-5*max|ref|", **tag})
    del ops, on_cpu, A_cpu, g_cpu

    # 4. a few Adam steps (the loss must fall), times and profiles
    opt = torch.optim.Adam([t for p in params for t in p], lr=LR)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_of(sparse_gcn_forward(A_norm, x, params))
        loss.backward()
        opt.step()
        return loss.detach()

    losses = torch.stack([step() for _ in range(TRAIN_STEPS)]).tolist()
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"sparse GCN training loss: {losses}")
    with torch.no_grad():
        fwd_ms = time_ms(lambda: sparse_gcn_forward(A_norm, x, params), 5)
        prof = device_profile(lambda: sparse_gcn_forward(A_norm, x, params),
                              2)
    step_ms = time_ms(step, 3)
    emit({"phase": "sparse_gcn_timing", "forward_ms": fwd_ms,
          "train_step_ms": step_ms, "losses": losses,
          "forward_profile": prof, "step_profile": device_profile(step, 2),
          **tag})
    return {"setup_s": setup_s, "forward_ms": fwd_ms, "step_ms": step_ms}


def same_graph_on(a, b, what: str) -> None:
    """Two graphs (any devices) with equal schema, counts, relation arrays
    (dtypes included), frames and batch sizes."""
    import torch

    def eq(x, y, where):
        if not isinstance(x, torch.Tensor):
            if x != y:
                raise RuntimeError(f"{what}: {where} differs")
            return
        x, y = x.detach().cpu(), y.detach().cpu()
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            raise RuntimeError(f"{what}: {where} differs")

    if (a.canonical_etypes != b.canonical_etypes
            or a._num_src_nodes != b._num_src_nodes
            or a._num_dst_nodes != b._num_dst_nodes):
        raise RuntimeError(f"{what}: schema or counts differ")
    for cet, ra in a._relations.items():
        rb = b._relations[cet]
        eq(ra.num_edges, rb.num_edges, f"{cet} num_edges")
        for f in ra.ARRAY_FIELDS:
            eq(getattr(ra, f), getattr(rb, f), f"{cet} {f}")
    for name in ("_node_frames", "_dst_frames", "_edge_frames"):
        fa, fb = getattr(a, name), getattr(b, name)
        if {k for k, v in fa.items() if v} != {k for k, v in fb.items()
                                               if v}:
            raise RuntimeError(f"{what}: {name} keys differ")
        for k, frame in fa.items():
            if set(frame) != set(fb.get(k, {})):
                raise RuntimeError(f"{what}: {name}[{k}] keys differ")
            for key, v in frame.items():
                eq(v, fb[k][key], f"{name}[{k}][{key}]")
    eq(a.batch_size, b.batch_size, "batch_size")
    if a._batch_num_nodes is not None:
        for nt in a.ntypes:
            eq(a.batch_num_nodes(nt), b.batch_num_nodes(nt), "batch nodes")
        for cet in a.canonical_etypes:
            eq(a.batch_num_edges(cet), b.batch_num_edges(cet), "batch edges")


def same_result(a, b, what: str) -> None:
    """Transform results (graphs, tensors, host arrays, tuples and lists of
    them) equal."""
    import numpy as np
    import torch

    from dgl_tpu_torch import Graph

    if isinstance(a, Graph):
        same_graph_on(a, b, what)
    elif isinstance(a, (tuple, list)):
        if len(a) != len(b):
            raise RuntimeError(f"{what}: lengths {len(a)} vs {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            same_result(x, y, f"{what}[{i}]")
    elif isinstance(a, dict):
        if set(a) != set(b):
            raise RuntimeError(f"{what}: keys {set(a)} vs {set(b)}")
        for k in a:
            same_result(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, torch.Tensor):
        if not torch.equal(a.cpu(), b.cpu()) or a.dtype != b.dtype:
            raise RuntimeError(f"{what}: tensors differ")
    elif isinstance(a, np.ndarray):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise RuntimeError(f"{what}: arrays differ")
    elif a != b:
        raise RuntimeError(f"{what}: {a} != {b}")


def recipe_transforms(n: int, e: int, seed: int = 9):
    """The host transforms phase b times: name -> fn(module, g) with their
    random arguments drawn once from ``seed`` for a graph of ``n`` nodes
    and ``e`` edges."""
    import numpy as np

    rng = np.random.default_rng(seed)
    drop = rng.choice(e, e // 10, replace=False)
    new_u, new_v = rng.integers(0, n, 1000), rng.integers(0, n, 1000)
    gone = rng.choice(n, 1000, replace=False)
    half_nodes = np.sort(rng.choice(n, n // 2, replace=False))
    half_edges = rng.choice(e, e // 2, replace=False)
    seeds = rng.choice(n, RECIPE_SEEDS, replace=False)
    khop_seeds = rng.choice(n, RECIPE_KHOP_SEEDS, replace=False)
    return {
        "to_simple": lambda m, g: m.to_simple(g, writeback_mapping=True),
        "reverse": lambda m, g: m.reverse(g),
        "add_reverse_edges": lambda m, g: m.add_reverse_edges(g),
        "to_bidirected": lambda m, g: m.to_bidirected(g, copy_ndata=True),
        "remove_edges 10%": lambda m, g: m.remove_edges(g, drop,
                                                        store_ids=True),
        "add_edges 1000": lambda m, g: m.add_edges(g, new_u, new_v),
        "add_nodes 1000": lambda m, g: m.add_nodes(g, 1000),
        "remove_nodes 1000": lambda m, g: m.remove_nodes(g, gone),
        "node_subgraph half": lambda m, g: m.node_subgraph(g, half_nodes),
        "edge_subgraph half": lambda m, g: m.edge_subgraph(g, half_edges),
        "in_subgraph 1024": lambda m, g: m.in_subgraph(g, seeds),
        "out_subgraph 1024": lambda m, g: m.out_subgraph(g, seeds),
        "khop_in_subgraph k=2, 64": lambda m, g: m.khop_in_subgraph(
            g, khop_seeds, 2),
        "to_block 1024": lambda m, g: m.to_block(m.in_subgraph(g, seeds),
                                                 seeds),
        "compact_graphs 1024": lambda m, g: m.compact_graphs(
            m.in_subgraph(g, seeds)),
    }


def run_gcn_recipe(tag: dict, device="cuda") -> dict:
    """Phase b: ``examples/gcn_cora.py``'s recipe at arxiv scale
    (``add_self_loop(remove_self_loop(g))``, ``with_spmm_plans(weighted=
    True)``, ``GCN(128, 256, 40, num_layers=3)``): B1 on every layer's
    ``copy_u`` sum; then the host transforms, card against CPU."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.models import GCN

    src, dst = zipf_graph(0)
    g = dt.graph((src, dst), num_nodes=N_NODES, device=device)
    t0 = time.perf_counter()
    gr = dt.add_self_loop(dt.remove_self_loop(g))
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gp = gr.with_spmm_plans(weighted=True)
    torch.cuda.synchronize()
    plans_s = time.perf_counter() - t0
    rel = gp._relation()
    if rel.hub_plan is None or rel.shell_plan is None:
        raise RuntimeError("the recipe's graph lacks its hub or shell plan")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(N_NODES, IN_FEATS)).astype(np.float32)).to(device)
    y = torch.from_numpy(np.random.default_rng(4).integers(
        0, CLASSES, N_NODES)).to(device)
    mask = torch.ones(N_NODES, device=device)
    model = GCN(IN_FEATS, HIDDEN, CLASSES, num_layers=LAYERS,
                generator=torch.Generator().manual_seed(0),
                device=device).eval()
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        out = model(gp, x)
    torch.cuda.synchronize()
    fwd_launches = dict(_kernels.launch_counts)
    expect_no_other_launch(fwd_launches, {"shell_prefix_sum": LAYERS},
                           "the GCN recipe's forward")
    with torch.inference_mode():
        ref = model(gr, x)
    vs_exact = held_against(out, ref, 2e-2, "GCN recipe vs the graph "
                            "without plans")
    grads = check_grads(model, gp, gr, x, y, mask, "GCN recipe")
    emit({"phase": "gcn_recipe_main_path", "model": "GCN 128-256-256-40, "
          "norm both, add_self_loop(remove_self_loop(g)) with "
          "with_spmm_plans(weighted=True)", "edges": gr.num_edges(),
          "transform_s": transform_s, "plans_s": plans_s,
          "launches": fwd_launches, "vs_exact_f32": vs_exact,
          "grads_vs_exact_f32": grads,
          "tolerance": "rtol=2e-2, atol=2e-2*max|ref|", **tag})
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    loss, step_launches, peak, step_s = counted_step(
        model, opt, gp, x, y, mask,
        {"shell_prefix_sum": 2 * LAYERS - 1, "shell_prefix_gspmm": 0},
        "GCN recipe")
    expect_no_other_launch(step_launches,
                           {"shell_prefix_sum": 2 * LAYERS - 1},
                           "the GCN recipe's step")
    losses = run_steps(model, opt, gp, x, y, mask, loss, falling=True)
    step = lambda: train_step(model, opt, gp, x, y, mask)  # noqa: E731
    step_ms = time_ms(step, 5)
    model.eval()
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(gp, x), 10)
        exact_ms = time_ms(lambda: model(gr, x), 5)
    model.train()
    emit({"phase": "gcn_recipe_training", "launches": step_launches,
          "losses": losses, "peak_memory_gib": peak, "first_step_s": step_s,
          "forward_ms": fwd_ms, "exact_path_forward_ms": exact_ms,
          "train_step_ms": step_ms, "step_profile": device_profile(step, 2),
          **tag})
    del model, opt, gp, out, ref

    # the host transforms at this scale, card against CPU
    rng = np.random.default_rng(5)
    g.ndata["x"] = torch.from_numpy(rng.normal(size=(N_NODES, 4)).astype(
        np.float32)).to(device)
    g.edata["w"] = torch.from_numpy(rng.random(N_EDGES).astype(
        np.float32)).to(device)
    g_cpu = g.to("cpu")
    g.edges()  # the card graph's host arrays are read on first use
    timings = {}
    for name, fn in recipe_transforms(N_NODES, N_EDGES).items():
        t0 = time.perf_counter()
        got = fn(dt, g)
        torch.cuda.synchronize()
        timings[name] = {"card_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        want = fn(dt, g_cpu)
        timings[name]["cpu_s"] = time.perf_counter() - t0
        same_result(got, want, name)
        out_g = got[0] if isinstance(got, tuple) else got
        timings[name]["edges"] = out_g.num_edges()
    small = dt.rand_graph(SMALL_GRAPH_NODES, SMALL_GRAPH_EDGES, seed=3,
                          device=device)
    small_cpu = dt.rand_graph(SMALL_GRAPH_NODES, SMALL_GRAPH_EDGES, seed=3,
                              device="cpu")
    for name, fn in (("khop_graph k=2", lambda s: dt.khop_graph(s, 2)),
                     ("line_graph", lambda s: dt.line_graph(s))):
        t0 = time.perf_counter()
        got = fn(small)
        torch.cuda.synchronize()
        timings[name] = {"card_s": time.perf_counter() - t0,
                         "graph": f"rand_graph({SMALL_GRAPH_NODES}, "
                                  f"{SMALL_GRAPH_EDGES})",
                         "edges": got.num_edges()}
        same_result(got, fn(small_cpu), name)
    ind = gr.in_degrees().cpu().numpy().astype(np.int64)
    outd = gr.out_degrees().cpu().numpy().astype(np.int64)
    deg = dt.to_bidirected(gr).in_degrees().cpu().numpy().astype(np.int64)
    emit({"phase": "graph_transforms", "graph": {"nodes": N_NODES,
                                                 "edges": N_EDGES},
          "transforms": timings,
          "two_hop_paths_recipe_graph": int((ind * outd).sum()),
          "two_hop_paths_bidirected": int((deg * deg).sum()),
          "two_hop_paths": "line_graph's and khop_graph(k=2)'s edge count "
                           "at zipf scale: sum of in * out degrees",
          "check": "card result equal to the CPU result (arrays, dtypes, "
                   "frames)", **tag})
    return {"forward_launches": fwd_launches["shell_prefix_sum"],
            "step_launches": step_launches["shell_prefix_sum"],
            "forward_ms": fwd_ms, "step_ms": step_ms}


def molhiv_graphs(count: int, seed: int, device):
    """``count`` random graphs with ogbg-molhiv's mean size: node counts
    Poisson(25.5) (at least 2), undirected edge counts Poisson(27.5), drawn
    with ``rand_graph`` and made undirected with ``to_bidirected``."""
    import numpy as np

    import dgl_tpu_torch as dt

    rng = np.random.default_rng(seed)
    nodes = np.maximum(rng.poisson(MOL_NODES, count), 2)
    edges = np.maximum(rng.poisson(MOL_EDGES, count), 1)
    return [dt.to_bidirected(dt.rand_graph(int(n), int(e), seed=seed + i,
                                           device=device))
            for i, (n, e) in enumerate(zip(nodes, edges))]


def gin_model(device, seed: int = 0):
    """Five ``GINConv`` layers (sum) with a 300-300 MLP each and ReLU
    between them, ``mean_nodes`` and a linear to one logit: OGB's GIN for
    ogbg-molhiv, fed 300-wide node embeddings; weights drawn after
    ``torch.manual_seed(seed)``."""
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch.nn import GINConv

    class GIN(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.convs = torch.nn.ModuleList(
                GINConv(torch.nn.Sequential(
                    torch.nn.Linear(GIN_DIM, GIN_DIM), torch.nn.ReLU(),
                    torch.nn.Linear(GIN_DIM, GIN_DIM)), "sum", device=device)
                for _ in range(GIN_LAYERS))
            self.out = torch.nn.Linear(GIN_DIM, 1)

        def forward(self, g, h):
            for i, conv in enumerate(self.convs):
                h = conv(g, h)
                if i != len(self.convs) - 1:
                    h = torch.relu(h)
            with g.local_scope():
                g.ndata["h"] = h
                return self.out(dt.mean_nodes(g, "h"))[:, 0]

    torch.manual_seed(seed)
    return GIN().to(device)


def readout_cases(bg, seed: int = 7):
    """The readouts of phase c over batch ``bg`` (its device)."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt

    rng = np.random.default_rng(seed)
    dev = bg.device
    g = bg.local_var()
    g.ndata["x"] = torch.from_numpy(rng.normal(
        size=(bg.num_nodes(), 8)).astype(np.float32)).to(dev)
    g.edata["w"] = torch.from_numpy(rng.normal(
        size=(bg.num_edges(), 8)).astype(np.float32)).to(dev)
    gf = torch.from_numpy(rng.normal(size=(bg.batch_size, 8)).astype(
        np.float32)).to(dev)
    return g, {
        "sum_nodes": lambda: dt.sum_nodes(g, "x"),
        "mean_nodes": lambda: dt.mean_nodes(g, "x"),
        "max_nodes": lambda: dt.max_nodes(g, "x"),
        "sum_edges": lambda: dt.sum_edges(g, "w"),
        "mean_edges": lambda: dt.mean_edges(g, "w"),
        "max_edges": lambda: dt.max_edges(g, "w"),
        "softmax_nodes": lambda: dt.softmax_nodes(g, "x"),
        "topk_nodes k=5 sortby=0": lambda: dt.topk_nodes(g, "x", 5,
                                                         sortby=0),
        "broadcast_nodes": lambda: dt.broadcast_nodes(g, gf),
    }


def run_batched_readout(tag: dict, device="cuda") -> dict:
    """Phase c: graph classification at OGB's GIN widths for ogbg-molhiv
    (no hand kernel), then the readouts and batch utilities on a batch of
    4,096 such graphs, card against CPU."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels

    t0 = time.perf_counter()
    graphs = molhiv_graphs(GIN_BATCH, 0, device)
    bg = dt.batch(graphs)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(bg.num_nodes(), GIN_DIM)).astype(
        np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, 2, GIN_BATCH).astype(
        np.float32)).to(device)
    model = gin_model(device)
    bce = torch.nn.functional.binary_cross_entropy_with_logits
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = bce(model(bg, x), y)
        loss.backward()
        opt.step()
        return loss.detach()

    # the first step, counted; its logits and gradients against the CPU's
    # on its ReLU pattern (check_grads explains why)
    model_cpu = gin_model("cpu")
    model_cpu.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    with relu_pattern() as pattern:
        out = model(bg, x)
    loss = bce(out, y)
    loss.backward()
    torch.cuda.synchronize()
    expect_no_other_launch(dict(_kernels.launch_counts), {},
                           "the GIN forward and backward")
    with relu_pattern([m.cpu() for m in pattern]):
        out_cpu = model_cpu(bg.to("cpu"), x.cpu())
    bce(out_cpu, y.cpu()).backward()
    with torch.no_grad(), relu_pattern() as own:
        model_cpu(bg.to("cpu"), x.cpu())
    checks = {"logits": held_against(out, out_cpu, 1e-4,
                                     "GIN logits vs the CPU"),
              "relu_sign_differences_own_pattern": int(sum(
                  (a.cpu() != b).sum().item() for a, b in zip(pattern,
                                                              own)))}
    cpu_grads = dict(model_cpu.named_parameters())
    for k, p in model.named_parameters():
        checks[f"grad {k}"] = held_against(p.grad, cpu_grads[k].grad, 1e-4,
                                           f"GIN grad {k}")
    opt.step()
    losses = [loss.item()] + torch.stack(
        [step() for _ in range(TRAIN_STEPS - 1)]).tolist()
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"GIN training loss: {losses}")
    with torch.no_grad():
        fwd_ms = time_ms(lambda: model(bg, x), 10)
        fwd_prof = device_profile(lambda: model(bg, x), 5)
    step_ms = time_ms(step, 10)
    step_prof = device_profile(step, 5)
    emit({"phase": "batched_readout_gin", "model": "GIN 5 x GINConv(sum, "
          "MLP 300-300), mean_nodes, linear to 1, BCE, Adam 1e-3",
          "batch": {"graphs": GIN_BATCH, "nodes": bg.num_nodes(),
                    "edges": bg.num_edges()}, "batch_s": batch_s,
          "vs_cpu": checks, "tolerance": "rtol=1e-4, atol=1e-4*max|ref|, "
          "the CPU on the card pass's ReLU pattern", "losses": losses, "forward_ms": fwd_ms, "train_step_ms": step_ms,
          "forward_profile": fwd_prof, "step_profile": step_prof, **tag})

    # the readouts and batch utilities on 4,096 graphs, card against CPU
    t0 = time.perf_counter()
    many_cpu = molhiv_graphs(READOUT_GRAPHS, 100, "cpu")
    big_cpu = dt.batch(many_cpu)
    big = big_cpu.to(device)
    build_s = time.perf_counter() - t0
    g_card, on_card = readout_cases(big)
    g_host, on_cpu = readout_cases(big_cpu)
    results = {}
    for name, fn in on_card.items():
        got, want = fn(), on_cpu[name]()
        if isinstance(got, tuple):
            err = held_against(got[0], want[0], 1e-5, name)
            same_result(got[1], want[1], f"{name} ids")
        else:
            err = held_against(got, want, 1e-5, name)
        results[name] = {**err, "ms": time_ms(fn, 10)}
    t0 = time.perf_counter()
    parts = dt.unbatch(g_card)
    unbatch_s = time.perf_counter() - t0
    for i, (a, b) in enumerate(zip(parts, dt.unbatch(g_host))):
        same_graph_on(a, b, f"unbatch graph {i}")
    same_graph_on(dt.batch(parts), g_host, "batch(unbatch(bg))")
    for gid in (0, READOUT_GRAPHS // 3, READOUT_GRAPHS - 1):
        same_graph_on(dt.slice_batch(g_card, gid, store_ids=True),
                      dt.slice_batch(g_host, gid, store_ids=True),
                      f"slice_batch {gid}")
    shape = (READOUT_GRAPHS + 8, big.num_nodes() + 100,
             big.num_edges() + 100)
    t0 = time.perf_counter()
    padded, gmask = dt.pad_batch(parts, *shape)
    pad_s = time.perf_counter() - t0
    ref_pad, ref_mask = dt.pad_batch(dt.unbatch(g_host), *shape)
    same_graph_on(padded, ref_pad, "pad_batch")
    same_result(gmask, ref_mask, "pad_batch mask")
    emit({"phase": "batched_readout_ops", "graphs": READOUT_GRAPHS,
          "nodes": big.num_nodes(), "edges": big.num_edges(),
          "build_s": build_s, "ops": results, "unbatch_s": unbatch_s,
          "pad_batch_s": pad_s, "pad_batch_shape": shape,
          "tolerance": "values rtol=1e-5, atol=1e-5*max|ref|; ids, "
                       "graphs and masks exact", **tag})
    return {"forward_ms": fwd_ms, "step_ms": step_ms}



# -- the rest of the graph utilities (phases sign_diffusion, gdc_gcn,
# graphormer, gin_glob, point_cloud and graph_utils) -----------------------

# DGL's SIGN example (examples/pytorch/sign: R = 3 hops) at arxiv widths
SIGN_HOPS, SIGN_OPS = 3, ("gcn", "ppr", "raw")
# Graphormer-base (examples/core/Graphormer; the paper's base model):
# 12 layers, hidden 768, 32 heads; over ogbg-molhiv-sized graphs with its
# 9 atom features (random floats here), one logit
GRAPHORMER = dict(num_layers=12, hidden=768, heads=32, max_degree=64,
                  max_dist=5)
GRAPHORMER_GRAPHS, GRAPHORMER_CHECK_GRAPHS, MOL_ATOM_FEATS = 128, 16, 9
GLOB_GRAPHS, GLOB_FEAT = 4096, 64
# DGL's DGCNN on ModelNet40 (examples/pytorch/pointcloud/edgeconv: k = 20,
# batch 32 clouds of 1,024 points, the first EdgeConv 3 -> 64); PointNet++
# samples 512 of them
CLOUDS, CLOUD_POINTS, CLOUD_K, CLOUD_OUT, FPS_POINTS = 32, 1024, 20, 64, 512
# examples/tree_lstm.py: random trees of up to 12 nodes, x 16, h 32
TREES, TREE_MAX_NODES, TREE_X, TREE_H = 256, 12, 16, 32


def record_b1():
    """``recording`` of kernel B1's wrapper as the hub plan calls it."""
    from dgl_tpu_torch.ops import hub_spmm

    return recording(hub_spmm, "shell_prefix_sum")


def b1_calls_exact(calls, what: str) -> float:
    """Each recorded B1 call run again against its plain version on the
    card at rtol = atol = 1e-5 (the same f32 sums in the same order);
    returns the largest abs error."""
    import torch

    from dgl_tpu_torch.ops.shell_prefix import (shell_prefix_sum,
                                                shell_prefix_sum_plain)

    worst = 0.0
    for a, k in calls:
        got = shell_prefix_sum(*a, **k)
        want = shell_prefix_sum_plain(*a, base=k.get("base"))
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise RuntimeError(f"{what}: B1 vs plain, max abs err {err}")
        worst = max(worst, err)
    return worst


def strip_plans(g):
    """The graph without its plans (the same relation arrays)."""
    g2 = g.local_var()
    g2._relations = {c: r._copy_with(hub_plan=None, shell_plan=None,
                                     bitmap_plan=None, dense_adj=None)
                     for c, r in g._relations.items()}
    return g2


def sign_hops(g, op):
    """``SIGNDiffusion(k=3)`` of ``ndata['feat']`` with ``op``: its hops."""
    from dgl_tpu_torch.transforms import SIGNDiffusion

    SIGNDiffusion(SIGN_HOPS, diffuse_op=op)(g)
    return [g.ndata.pop(f"out_feat_{i}") for i in range(1, SIGN_HOPS + 1)]


def run_sign_diffusion(tag: dict, device="cuda") -> dict:
    """Phase sign_diffusion: SIGN's precomputed diffusions (k = 3) at F =
    128 on the arxiv zipf graph with ``reorder_for_spmm``'s hub plan, B1 a
    hop, for each op; each hop against the graph without plans at the
    plan bound, that graph's card result against the CPU's at 1e-5."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels

    t0 = time.perf_counter()
    src, dst = zipf_graph(0)
    gp, _perm = dt.transforms.reorder_for_spmm(
        dt.graph((src, dst), num_nodes=N_NODES, device=device),
        num_hubs=2048, precision="int8")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if gp._relation().hub_plan is None:
        raise RuntimeError("sign_diffusion: the graph has no hub plan")
    g_plain = strip_plans(gp)
    g_cpu = g_plain.to("cpu")
    x = torch.from_numpy(np.random.default_rng(11).normal(
        size=(N_NODES, IN_FEATS)).astype(np.float32))
    for g in (gp, g_plain, g_cpu):
        g.ndata["feat"] = x.to(g.device)
    out = {"setup_s": setup_s, "launches": {}, "vs_plain": {},
           "plain_vs_cpu": {}, "ms": {}, "plain_ms": {}}
    worst = 0.0
    for op in SIGN_OPS:
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        with torch.inference_mode(), record_b1() as calls:
            hops = sign_hops(gp, op)
        torch.cuda.synchronize()
        launches = dict(_kernels.launch_counts)
        expect_no_other_launch(launches, {"shell_prefix_sum": SIGN_HOPS},
                               f"SIGNDiffusion({op})")
        out["launches"][op] = launches["shell_prefix_sum"]
        worst = max(worst, b1_calls_exact(calls, f"SIGN {op}"))
        del calls
        with torch.inference_mode():
            plain = sign_hops(g_plain, op)
            cpu = sign_hops(g_cpu, op)
            out["vs_plain"][op] = [
                held_against(a, b, 2e-2, f"SIGN {op} hop {i + 1} vs the "
                             "graph without plans")["max_rel_err"]
                for i, (a, b) in enumerate(zip(hops, plain))]
            out["plain_vs_cpu"][op] = [
                held_against(a, b, 1e-5, f"SIGN {op} hop {i + 1}, card "
                             "vs CPU")["max_rel_err"]
                for i, (a, b) in enumerate(zip(plain, cpu))]
            out["ms"][op] = time_ms(lambda: sign_hops(gp, op), 5)
            out["plain_ms"][op] = time_ms(lambda: sign_hops(g_plain, op), 3)
    with torch.inference_mode():
        prof = device_profile(lambda: sign_hops(gp, "gcn"), 2)
    out["b1_max_abs_err_vs_plain"] = worst
    emit({"phase": "sign_diffusion", "transform": "SIGNDiffusion(k=3), F = "
          f"{IN_FEATS}, reorder_for_spmm(num_hubs=2048, int8)",
          "nodes": N_NODES, "edges": N_EDGES, **out,
          "tolerance": "each hop vs the graph without plans rtol=2e-2, "
                       "atol=2e-2*max|ref|; that graph card vs CPU 1e-5; "
                       "B1 vs plain 1e-5", "gcn_profile": prof, **tag})
    return out


def run_gdc_gcn(rate: float, tag: dict, device="cuda") -> dict:
    """Phase gdc_gcn: ``GDC("ppr")`` and ``GDC("heat")`` at their defaults
    on the Cora-sized graph (dense n x n on the host), the diffused graph
    card against CPU; then the weighted GCN 1433-16-7 with the diffusion's
    weights over ``with_spmm_plans(weighted=True)``: B1w launches counted,
    output and gradients against the graph without plans, every recorded
    B1w call against its plain version."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.ops import shell_prefix
    from dgl_tpu_torch.transforms import GDC

    src, dst = cora_graph()
    g = dt.graph((src, dst), num_nodes=CORA_N, device=device)
    g_cpu = g.to("cpu")
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(CORA_N, CORA_FEAT)).astype(
        np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, CORA_CLASSES, CORA_N)).to(device)
    mask = torch.ones(CORA_N, device=device)
    dims = (CORA_FEAT, DENSE_OUT, CORA_CLASSES)
    result = {}
    for diffusion in ("ppr", "heat"):
        t0 = time.perf_counter()
        gd = GDC(diffusion)(g)
        torch.cuda.synchronize()
        diffuse_s = time.perf_counter() - t0
        same_graph_on(gd, GDC(diffusion)(g_cpu), f"GDC({diffusion})")
        t0 = time.perf_counter()
        gp = gd.with_spmm_plans(weighted=True, bitmap=False,
                                dense_attn=False)
        torch.cuda.synchronize()
        plans_s = time.perf_counter() - t0
        if gp._relation().shell_plan is None:
            raise RuntimeError("GDC graph: no shell plan")
        # a sparsified diffusion can leave a node without in-edges
        model = weighted_gcn(dims, 0.5, 0, allow_zero_in_degree=True).to(
            device).eval()
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        with torch.inference_mode(), recording(
                shell_prefix, "shell_prefix_gspmm") as calls:
            out = model(gp, x)
        torch.cuda.synchronize()
        fwd_launches = dict(_kernels.launch_counts)
        expect_no_other_launch(fwd_launches, {"shell_prefix_gspmm": 2},
                               f"the GDC({diffusion}) GCN forward")
        with torch.inference_mode():
            ref = model(gd, x)
        vs_exact = held_against(out, ref, 2e-2, f"GDC({diffusion}) GCN vs "
                                "the graph without plans")
        plan = gp._relation().shell_plan
        csr = weights_csr(gp._relation(), gp.edata["w"], False)
        kernel = {}
        with torch.inference_mode():
            for i, (a, k) in enumerate(calls):
                r = check_gspmm(a, k, plan, False, csr, rate)
                r.pop("ptxas_key")
                kernel[f"layer{i} F={r['F']}"] = r
        del calls
        model.train()
        grads = check_grads(model, gp, gd, x, y, mask, f"GDC({diffusion}) "
                            "GCN")
        opt = torch.optim.Adam(model.parameters(), lr=LR)
        # the backward sums dZ over both layers: layer 0 projects 1433 ->
        # 16 first, so its aggregation's input needs a gradient too
        loss, step_launches, peak, _ = counted_step(
            model, opt, gp, x, y, mask, {"shell_prefix_gspmm": 4},
            f"GDC({diffusion}) GCN")
        expect_no_other_launch(step_launches, {"shell_prefix_gspmm": 4},
                               f"the GDC({diffusion}) GCN step")
        losses = run_steps(model, opt, gp, x, y, mask, loss, falling=False)
        model.eval()
        with torch.inference_mode():
            fwd_ms = time_ms(lambda: model(gp, x), 10)
            exact_ms = time_ms(lambda: model(gd, x), 10)
        model.train()
        step_ms = time_ms(lambda: train_step(model, opt, gp, x, y, mask), 5)
        result[diffusion] = {
            "edges": gd.num_edges(), "diffuse_s": diffuse_s,
            "plans_s": plans_s, "forward_launches": fwd_launches,
            "step_launches": step_launches, "vs_exact_f32": vs_exact,
            "grads_vs_exact_f32": grads, "losses": losses,
            "forward_ms": fwd_ms, "exact_path_forward_ms": exact_ms,
            "train_step_ms": step_ms, "peak_memory_gib": peak,
            "kernel_vs_plain": kernel}
        emit({"phase": f"gdc_gcn_{diffusion}", "model": "GDC "
              f"{diffusion} (defaults) then GraphConv(norm='none') "
              "1433-16-7 with its weights", "nodes": CORA_N, **result[
                  diffusion], "tolerance": "diffused graph card vs CPU "
              "exact; GCN vs the graph without plans rtol=2e-2, "
              "atol=2e-2*max|ref|; B1w vs plain exact", **tag})
    return result


def graphormer_model(device, seed: int = 0):
    import torch

    from dgl_tpu_torch.models import Graphormer

    return Graphormer(MOL_ATOM_FEATS, GRAPHORMER["hidden"], 1,
                      num_layers=GRAPHORMER["num_layers"],
                      num_heads=GRAPHORMER["heads"],
                      max_degree=GRAPHORMER["max_degree"],
                      max_dist=GRAPHORMER["max_dist"],
                      generator=torch.Generator().manual_seed(seed),
                      device=device)


def with_atoms(graphs, seed: int):
    """``ndata['feat']``: 9 random floats a node (molhiv's atom features)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    for g in graphs:
        g.ndata["feat"] = torch.from_numpy(rng.normal(
            size=(g.num_nodes(), MOL_ATOM_FEATS)).astype(np.float32)).to(
            g.device)
    return graphs


def run_graphormer(tag: dict, device="cuda") -> dict:
    """Phase graphormer: ``prepare_batch`` of 128 molhiv-sized graphs
    (host BFS distances) and Graphormer-base (12 x 768, 32 heads) forward
    and BCE/Adam step; no hand kernel. The card against the CPU (in f64)
    on the first 16 graphs (dropout off), output and gradients at 1e-4."""
    import numpy as np
    import torch

    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.models import prepare_batch

    graphs = with_atoms(molhiv_graphs(GRAPHORMER_GRAPHS, 21, device), 22)
    t0 = time.perf_counter()
    batch = prepare_batch(graphs, max_dist=GRAPHORMER["max_dist"])
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    y = torch.from_numpy(np.random.default_rng(23).integers(
        0, 2, GRAPHORMER_GRAPHS).astype(np.float32)).to(device)
    model = graphormer_model(device)
    bce = torch.nn.functional.binary_cross_entropy_with_logits

    # the card against the CPU on a slice of the batch, dropout off, the
    # CPU on the card pass's ReLU pattern (check_grads explains why) and in
    # f64: the last layer's query gradients reach the loss through one
    # softmax row a graph, a difference of near-equal terms, so two f32
    # passes differ there by about 1e-4 of max|ref| (9.99e-5 in a run
    # against an f32 CPU); against f64 the check sees the card's rounding
    model.eval()
    cpu_model = graphormer_model("cpu").double()
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    cpu_model.eval()
    part = prepare_batch(graphs[:GRAPHORMER_CHECK_GRAPHS],
                         max_dist=GRAPHORMER["max_dist"])
    checks = {}
    outs = {}
    pattern = None

    def inputs(dev, dtype):
        return [t.to(dev, dtype) if t.is_floating_point() else t.to(dev)
                for t in part]

    for name, m, dev, dtype in (("card", model, device, torch.float32),
                                ("cpu", cpu_model, "cpu", torch.float64)):
        m.zero_grad(set_to_none=True)
        with relu_pattern(pattern and [t.cpu() for t in pattern]) as seen:
            o = m(*inputs(dev, dtype))[:, 0]
        pattern = seen
        bce(o, y[:GRAPHORMER_CHECK_GRAPHS].to(dev, dtype)).backward()
        outs[name] = (o.detach().float(), {k: p.grad.float() for k, p in
                                           m.named_parameters()})
    with torch.no_grad(), relu_pattern() as own:
        cpu_model(*inputs("cpu", torch.float64))
    checks["relu_sign_differences_own_pattern"] = int(sum(
        (a.cpu() != b).sum().item() for a, b in zip(pattern, own)))
    checks["logits"] = held_against(outs["card"][0], outs["cpu"][0], 1e-4,
                                    "Graphormer logits vs CPU")
    # k_proj's bias shifts every score of a query alike: its gradient is 0
    # in exact arithmetic, held at the scale of all the gradients
    zero = {k for k in outs["cpu"][1] if k.endswith("attn.k_proj.bias")}
    checks["grads"] = held(outs["card"][1], outs["cpu"][1], 1e-4,
                           "Graphormer gradients vs CPU", zero=zero)
    del outs, cpu_model

    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = bce(model(*batch)[:, 0], y)
        loss.backward()
        opt.step()
        return loss.detach()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    losses = [step()]
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    expect_no_other_launch(dict(_kernels.launch_counts), {},
                           "the Graphormer step")
    losses = torch.stack(losses + [step() for _ in range(TRAIN_STEPS - 1)]
                         ).tolist()
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"Graphormer losses {losses}")
    model.eval()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fwd_ms = time_ms(lambda: model(*batch), 5)
        fwd_peak = torch.cuda.max_memory_allocated() / 2**30
        fwd_prof = device_profile(lambda: model(*batch), 2)
    model.train()
    step_ms = time_ms(step, 3)
    result = {"graphs": GRAPHORMER_GRAPHS, "padded_nodes":
              int(batch[0].shape[1]), "prepare_batch_s": prepare_s,
              "forward_ms": fwd_ms, "train_step_ms": step_ms,
              "forward_peak_memory_gib": fwd_peak,
              "step_peak_memory_gib": step_peak, "losses": losses}
    emit({"phase": "graphormer", "model": "Graphormer {num_layers} x "
          "{hidden}, {heads} heads, max_degree {max_degree}, max_dist "
          "{max_dist}, 9 -> 1, BCE, Adam 1e-4".format(**GRAPHORMER), **result,
          "vs_cpu": checks, "check_graphs": GRAPHORMER_CHECK_GRAPHS,
          "tolerance": "rtol=1e-4, atol=1e-4*max|ref| (k_proj biases: of "
                       "the largest gradient), the CPU in f64 on the card "
                       "pass's ReLU pattern", "forward_profile": fwd_prof,
          "step_profile": device_profile(step, 2), **tag})
    return result


def glob_modules(device, seed: int = 0):
    """Every pooling class of ``nn.glob`` at width 64, weights from
    ``seed``."""
    import torch

    from dgl_tpu_torch.nn import glob

    gen = torch.Generator().manual_seed(seed)
    kw = dict(generator=gen, device=device)
    F = GLOB_FEAT
    torch.manual_seed(seed)
    return {
        "SumPooling": glob.SumPooling(), "AvgPooling": glob.AvgPooling(),
        "MaxPooling": glob.MaxPooling(),
        "SortPooling k=10": glob.SortPooling(10),
        "GlobalAttentionPooling": glob.GlobalAttentionPooling(
            torch.nn.Linear(F, 1), torch.nn.Linear(F, F)).to(device),
        "Set2Set n_iters=3": glob.Set2Set(F, 3, **kw),
        "WeightAndSum": glob.WeightAndSum(F, **kw),
        "SetTransformerEncoder sab x2": glob.SetTransformerEncoder(
            F, 4, 16, 2 * F, n_layers=2, **kw),
        "SetTransformerEncoder isab m=8": glob.SetTransformerEncoder(
            F, 4, 16, 2 * F, n_layers=1, block_type="isab", m=8, **kw),
        "SetTransformerDecoder k=4": glob.SetTransformerDecoder(
            F, 4, 16, 2 * F, n_layers=1, k=4, **kw),
    }


def run_gin_glob(tag: dict, device="cuda") -> dict:
    """Phase gin_glob: ``models.GIN`` (5 x 300, sum readout, one logit)
    over the 32 molhiv-sized graphs of phase batched_readout, forward and
    step, card against CPU; then every ``nn.glob`` pooling class over
    4,096 such graphs, card against CPU at 1e-5."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.models import GIN

    bg = dt.batch(molhiv_graphs(GIN_BATCH, 0, device))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(bg.num_nodes(), GIN_DIM)).astype(
        np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, 2, GIN_BATCH).astype(
        np.float32)).to(device)
    bce = torch.nn.functional.binary_cross_entropy_with_logits
    model = GIN(GIN_DIM, GIN_DIM, 1, num_layers=GIN_LAYERS,
                generator=torch.Generator().manual_seed(0), device=device)
    cpu_model = GIN(GIN_DIM, GIN_DIM, 1, num_layers=GIN_LAYERS,
                    device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    checks, grads = {}, {}
    for name, m, g, xx, yy in (("card", model, bg, x, y),
                               ("cpu", cpu_model.eval(), bg.to("cpu"),
                                x.cpu(), y.cpu())):
        m.eval()
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        out = m(g, xx)[:, 0]
        bce(out, yy).backward()
        torch.cuda.synchronize()
        expect_no_other_launch(dict(_kernels.launch_counts), {},
                               "the GIN forward and backward")
        grads[name] = (out.detach(), {k: p.grad for k, p in
                                      m.named_parameters()})
    checks["logits"] = held_against(grads["card"][0], grads["cpu"][0], 1e-5,
                                    "GIN logits vs CPU")
    checks["grads"] = held(grads["card"][1], grads["cpu"][1], 1e-4,
                           "GIN gradients vs CPU")
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = bce(model(bg, x)[:, 0], y)
        loss.backward()
        opt.step()
        return loss.detach()

    losses = torch.stack([step() for _ in range(TRAIN_STEPS)]).tolist()
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"GIN losses {losses}")
    model.eval()
    with torch.no_grad():
        fwd_ms = time_ms(lambda: model(bg, x), 10)
    model.train()
    step_ms = time_ms(step, 10)
    emit({"phase": "gin_glob_gin", "model": "models.GIN 5 x 300, sum "
          "readout, per-layer logits summed, 1 logit, BCE, Adam 1e-3",
          "batch": {"graphs": GIN_BATCH, "nodes": bg.num_nodes(),
                    "edges": bg.num_edges()}, "vs_cpu": checks,
          "tolerance": "logits rtol=1e-5, atol=1e-5*max|ref|; gradients "
                       "1e-4", "losses": losses, "forward_ms": fwd_ms,
          "train_step_ms": step_ms,
          "step_profile": device_profile(step, 5), **tag})

    t0 = time.perf_counter()
    big_cpu = dt.batch(molhiv_graphs(GLOB_GRAPHS, 100, "cpu"))
    big = big_cpu.to(device)
    build_s = time.perf_counter() - t0
    feat = torch.from_numpy(np.random.default_rng(3).normal(
        size=(big.num_nodes(), GLOB_FEAT)).astype(np.float32))
    card_mods, cpu_mods = glob_modules(device), glob_modules("cpu")
    pools = {}
    with torch.no_grad():
        for name, mod in card_mods.items():
            cpu_mods[name].load_state_dict({k: v.cpu() for k, v in
                                            mod.state_dict().items()})
            mod.eval()
            cpu_mods[name].eval()
            xg = feat.to(device)
            got = mod(big, xg)
            want = cpu_mods[name](big_cpu, feat)
            pools[name] = {**held_against(got, want, 1e-5, name),
                           "shape": list(got.shape),
                           "ms": time_ms(lambda: mod(big, xg), 5)}
    emit({"phase": "gin_glob_pooling", "graphs": GLOB_GRAPHS,
          "nodes": big.num_nodes(), "edges": big.num_edges(),
          "feat": GLOB_FEAT, "build_s": build_s, "pooling": pools,
          "tolerance": "rtol=1e-5, atol=1e-5*max|ref|", **tag})
    return {"gin_forward_ms": fwd_ms, "gin_step_ms": step_ms}


def knn_near_ties(got_src, want_src, x, k: int) -> int:
    """kNN source lists (query-major, ``k`` a query) equal on two devices
    but for slots whose two neighbours' float64 squared distances to the
    query agree within 1e-5 of the largest squared norm (a float32
    rounding tie; ``tests/test_torch_transforms_pe.py`` states the rule);
    returns the number of such slots."""
    import numpy as np

    got = got_src.cpu().numpy().reshape(-1, k)
    want = want_src.cpu().numpy().reshape(-1, k)
    x = x.cpu().numpy().astype(np.float64)
    differ = got != want
    if differ.any():
        q = np.nonzero(differ)[0]
        dg = ((x[q] - x[got[differ]]) ** 2).sum(-1)
        dw = ((x[q] - x[want[differ]]) ** 2).sum(-1)
        tol = 1e-5 * float((x * x).sum(1).max())
        if not np.all(np.abs(dg - dw) <= tol):
            raise RuntimeError(f"kNN lists differ beyond near-ties: "
                               f"{np.abs(dg - dw).max()} > {tol}")
    return int(differ.sum())


def run_point_cloud(tag: dict, device="cuda") -> dict:
    """Phase point_cloud: DGCNN's graph, ``SegmentedKNNGraph(20)`` over 32
    clouds of 1,024 random 3-D points, and its first ``EdgeConv`` 3 -> 64;
    PointNet++'s ``farthest_point_sampler`` of 512 points a cloud; the
    segmented ``knn`` query. Each against the CPU."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch.geometry import farthest_point_sampler
    from dgl_tpu_torch.nn import EdgeConv, SegmentedKNNGraph

    pos_cpu = torch.from_numpy(np.random.default_rng(31).random(
        (CLOUDS, CLOUD_POINTS, 3)).astype(np.float32))
    pos = pos_cpu.to(device)
    flat, flat_cpu = pos.reshape(-1, 3), pos_cpu.reshape(-1, 3)
    segs = [CLOUD_POINTS] * CLOUDS
    knn = SegmentedKNNGraph(CLOUD_K)
    t0 = time.perf_counter()
    g = knn(flat, segs)
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t0
    g_cpu = knn(flat_cpu, segs)
    if not torch.equal(g.edges()[1].cpu(), g_cpu.edges()[1]):
        raise RuntimeError("SegmentedKNNGraph: destinations differ")
    swaps = knn_near_ties(g.edges()[0], g_cpu.edges()[0], flat_cpu, CLOUD_K)
    conv = EdgeConv(3, CLOUD_OUT, generator=torch.Generator().manual_seed(0),
                    device=device)
    conv_cpu = EdgeConv(3, CLOUD_OUT, device="cpu")
    conv_cpu.load_state_dict({k: v.cpu() for k, v in
                              conv.state_dict().items()})
    with torch.no_grad():
        h = conv(g, flat)
        conv_check = held_against(h, conv_cpu(g.to("cpu"), flat_cpu), 1e-5,
                                  "EdgeConv on the kNN graph vs CPU")
        conv_ms = time_ms(lambda: conv(g, flat), 10)
    knn_ms = time_ms(lambda: knn(flat, segs), 3)
    t0 = time.perf_counter()
    picks = farthest_point_sampler(pos, FPS_POINTS)
    torch.cuda.synchronize()
    fps_s = time.perf_counter() - t0
    same_result(picks, farthest_point_sampler(pos_cpu, FPS_POINTS),
                "farthest_point_sampler")
    fps_ms = time_ms(lambda: farthest_point_sampler(pos, FPS_POINTS), 3)
    query = dt.knn(CLOUD_K, flat, segs)
    same_result(query, dt.knn(CLOUD_K, flat_cpu, segs), "knn query")
    result = {"clouds": CLOUDS, "points": CLOUD_POINTS, "k": CLOUD_K,
              "edges": g.num_edges(), "knn_graph_first_s": knn_s,
              "knn_graph_ms": knn_ms, "near_tie_swaps_vs_cpu": swaps,
              "edgeconv_vs_cpu": conv_check, "edgeconv_ms": conv_ms,
              "fps_points": FPS_POINTS, "fps_first_s": fps_s,
              "fps_ms": fps_ms}
    emit({"phase": "point_cloud", **result, "check": "kNN edges equal to "
          "the CPU's but near-ties (knn_near_ties); EdgeConv rtol=1e-5, "
          "atol=1e-5*max|ref|; FPS picks and the knn query exact", **tag})
    return result


def tree_lstm_forest(count: int, seed: int, device):
    """``examples/tree_lstm.py``'s random trees (edges child -> parent),
    batched, with 16-wide node inputs."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt

    rng = np.random.default_rng(seed)
    trees = []
    for _ in range(count):
        n = int(rng.integers(3, TREE_MAX_NODES))
        parents = [int(rng.integers(0, i)) for i in range(1, n)]
        trees.append(dt.graph((np.arange(1, n), np.array(parents)),
                              num_nodes=n, device=device))
    forest = dt.batch(trees)
    forest.ndata["x"] = torch.from_numpy(rng.normal(
        size=(forest.num_nodes(), TREE_X)).astype(np.float32)).to(device)
    return forest


def tree_lstm_states(forest, weights):
    """The Child-Sum Tree-LSTM cell of ``examples/tree_lstm.py`` through
    ``prop_nodes_topo``, leaves first: a UDF mailbox reduce over the
    children, the gates in the apply function. Returns every node's h."""
    import torch

    import dgl_tpu_torch as dt

    w = {k: v.to(forest.device) for k, v in weights.items()}
    g = forest.local_var()
    zeros = torch.zeros((g.num_nodes(), TREE_H), device=g.device)
    g.ndata.update({"iou_x": g.ndata["x"] @ w["W_iou"], "h": zeros,
                    "c": zeros, "h_sum": zeros, "c_f": zeros})

    def msg(edges):
        return {"h": edges.src["h"], "c": edges.src["c"]}

    def reduce(nodes):
        mask = nodes.mailbox_mask[..., None]
        f = torch.sigmoid(nodes.mailbox["h"] @ w["U_f"] + w["b_f"])
        return {"h_sum": (nodes.mailbox["h"] * mask).sum(1),
                "c_f": (f * nodes.mailbox["c"] * mask).sum(1)}

    def apply(nodes):
        iou = (nodes.data["iou_x"] + nodes.data["h_sum"] @ w["U_iou"]
               + w["b_iou"])
        i, o, u = iou.split(TREE_H, dim=-1)
        c = torch.sigmoid(i) * torch.tanh(u) + nodes.data["c_f"]
        return {"h": torch.sigmoid(o) * torch.tanh(c), "c": c}

    dt.prop_nodes_topo(g, msg, reduce, apply)
    return g.ndata["h"]


def utility_cases(n: int, seed: int = 14):
    """Phase graph_utilities' calls on a graph of ``n`` nodes: name ->
    fn(module, g), random arguments drawn once from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tags = rng.integers(0, 40, n)
    tf = lambda m: m.transforms  # noqa: E731
    return {
        "rcmk_perm": lambda m, g: m.rcmk_perm(g),
        "reorder_graph rcmk": lambda m, g: m.reorder_graph(g, "rcmk"),
        "sort_csr_by_tag 40": lambda m, g: m.sort_csr_by_tag(g, tags),
        "sort_csc_by_tag 40": lambda m, g: m.sort_csc_by_tag(g, tags),
        "to_levi": lambda m, g: m.transforms.to_levi(g),
        "adj_sum_graph g + reverse": lambda m, g: m.adj_sum_graph(
            [g, m.reverse(g)], "w"),
        "shortest_dist root 0 paths": lambda m, g: m.shortest_dist(
            g, root=0, return_paths=True),
        "bfs_nodes_generator": lambda m, g: tuple(
            m.traversal.bfs_nodes_generator(g, 0)),
        "bfs_edges_generator": lambda m, g: tuple(
            m.traversal.bfs_edges_generator(g, 0)),
        # (these two write one frame of their input: their values)
        "GCNNorm": lambda m, g: tf(m).GCNNorm()(g.local_var()).edata["w"],
        "RowFeatNormalizer": lambda m, g: tf(m).RowFeatNormalizer(
            True, node_feat_names=["x"])(g.local_var()).ndata["x"],
        "FeatMask": lambda m, g: tf(m).FeatMask(
            node_feat_names=["x"], seed=1)(g.local_var()),
        "DropNode 0.1": lambda m, g: tf(m).DropNode(0.1, seed=2)(g),
        "DropEdge 0.1": lambda m, g: tf(m).DropEdge(0.1, seed=3)(g),
        "AddEdge 0.1": lambda m, g: tf(m).AddEdge(0.1, seed=4)(g),
        "NodeShuffle": lambda m, g: tf(m).NodeShuffle(seed=5)(g),
        "AddReverse": lambda m, g: tf(m).AddReverse()(g),
        "AddSelfLoop": lambda m, g: tf(m).AddSelfLoop()(g),
    }


def small_cases(seed: int = 15):
    """The calls whose algorithms grow faster than the edges, on
    ``rand_graph(2000, 10000)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = rng.random(SMALL_GRAPH_EDGES).astype(np.float32)
    pts = rng.random((SMALL_GRAPH_NODES, 3)).astype(np.float32)
    return {
        "metapath_reachable_graph 2 hops": lambda m, g:
            m.metapath_reachable_graph(g, ["_E", "_E"]),
        "adj_product_graph g @ g": lambda m, g: m.adj_product_graph(
            g, g, "w"),
        "dfs_edges_generator": lambda m, g: tuple(
            m.traversal.dfs_edges_generator(g, 0)),
        "dfs_labeled_edges_generator": lambda m, g:
            m.traversal.dfs_labeled_edges_generator(g, 0, False, True, True),
        "neighbor_matching": lambda m, g: m.geometry.neighbor_matching(
            g, torch_like(w, g)),
        "radius_graph 0.05": lambda m, g: m.radius_graph(
            torch_like(pts, g), 0.05, get_distances=True),
        "khop_graph via KHopGraph(2)": lambda m, g:
            m.transforms.KHopGraph(2)(g),
    }


def torch_like(a, g):
    """A numpy array as a tensor on ``g``'s device."""
    import torch

    return torch.from_numpy(a).to(g.device)


def dense_cases():
    """The dense n x n utilities, at Cora's size."""
    return {
        "random_walk_pe k=16": lambda m, g: m.random_walk_pe(g, 16),
        "lap_pe k=8": lambda m, g: m.lap_pe(g, 8, return_eigval=True),
        "svd_pe k=8": lambda m, g: m.svd_pe(g, 8),
        "double_radius_node_labeling": lambda m, g:
            m.double_radius_node_labeling(g, 0, 1),
        "shortest_dist all pairs": lambda m, g: m.shortest_dist(g),
    }


DEVICE_VALUES = ("GCNNorm", "RowFeatNormalizer")  # rtol 1e-5, not exact


def timed_pair(cases, g, g_cpu, timings, **info):
    """Each case on the card graph and the CPU graph, timed, results
    equal (``same_result``), but for the values the card computes
    (``DEVICE_VALUES``), held at rtol = 1e-5, atol = 1e-5 * max|ref|."""
    import torch

    import dgl_tpu_torch as dt

    for name, fn in cases.items():
        t0 = time.perf_counter()
        got = fn(dt, g)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = fn(dt, g_cpu)
        cpu_s = time.perf_counter() - t0
        err = {}
        if name in DEVICE_VALUES:
            err = held_against(got, want, 1e-5, name)
        else:
            same_result(got, want, name)
        timings[name] = {"card_s": card_s, "cpu_s": cpu_s, **err, **info}


def run_graph_utils(tag: dict, device="cuda") -> dict:
    """Phase graph_utilities: every other new utility at the largest size
    its algorithm allows, card against CPU (indices and host numpy exact,
    device values within 1e-5), seconds each: the dense ones at Cora's
    size (``ppr`` and ``heat_kernel``: phase gdc_gcn), the linear ones on
    the arxiv zipf graph, the others on ``rand_graph(2000, 10000)``; then
    ``laplacian_lambda_max`` over 256 molhiv-sized graphs and the
    Child-Sum Tree-LSTM over ``prop_nodes_topo`` on 256 random trees."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt

    timings = {}
    src, dst = cora_graph()
    g = dt.graph((src, dst), num_nodes=CORA_N, device=device)
    timed_pair(dense_cases(), g, g.to("cpu"), timings,
               graph=f"Cora-sized, {CORA_N} nodes")
    src, dst = zipf_graph(0)
    g = dt.graph((src, dst), num_nodes=N_NODES, device=device)
    rng = np.random.default_rng(16)
    g.ndata["x"] = torch.from_numpy(rng.random((N_NODES, 4)).astype(
        np.float32)).to(device)
    g.edata["w"] = torch.from_numpy(rng.random(N_EDGES).astype(
        np.float32)).to(device)
    g_cpu = g.to("cpu")
    g.edges()  # the card graph's host arrays are read on first use
    timed_pair(utility_cases(N_NODES), g, g_cpu, timings, graph="arxiv zipf")
    small = dt.rand_graph(SMALL_GRAPH_NODES, SMALL_GRAPH_EDGES, seed=3,
                          device=device)
    small.edata["w"] = torch.from_numpy(np.random.default_rng(17).random(
        SMALL_GRAPH_EDGES).astype(np.float32)).to(device)
    timed_pair(small_cases(), small, small.to("cpu"), timings,
               graph=f"rand_graph({SMALL_GRAPH_NODES}, {SMALL_GRAPH_EDGES})")

    mols = dt.batch(molhiv_graphs(256, 41, device))
    t0 = time.perf_counter()
    lam = dt.laplacian_lambda_max(mols)
    lam_s = time.perf_counter() - t0
    lam_cpu = dt.laplacian_lambda_max(mols.to("cpu"))
    if not np.allclose(lam, lam_cpu, rtol=1e-9, atol=0):
        raise RuntimeError("laplacian_lambda_max: card and CPU differ")
    timings["laplacian_lambda_max 256 molhiv graphs"] = {
        "card_s": lam_s, "max_rel_diff_vs_cpu": float(np.max(
            np.abs(np.subtract(lam, lam_cpu)) / np.abs(lam_cpu))),
        "tolerance": "rtol=1e-9 (ARPACK's random start)"}

    forest = tree_lstm_forest(TREES, 18, device)
    gen = torch.Generator().manual_seed(19)
    shapes = {"W_iou": (TREE_X, 3 * TREE_H), "U_iou": (TREE_H, 3 * TREE_H),
              "b_iou": (3 * TREE_H,), "U_f": (TREE_H, TREE_H),
              "b_f": (TREE_H,)}
    weights = {k: torch.randn(s, generator=gen) * 0.3
               for k, s in shapes.items()}
    t0 = time.perf_counter()
    with torch.no_grad():
        h = tree_lstm_states(forest, weights)
        torch.cuda.synchronize()
        tree_s = time.perf_counter() - t0
        h_cpu = tree_lstm_states(forest.to("cpu"), weights)
    frontiers = len(dt.traversal.topological_nodes_generator(forest))
    timings["prop_nodes_topo Tree-LSTM"] = {
        "card_s": tree_s, "trees": TREES, "nodes": forest.num_nodes(),
        "frontiers": frontiers,
        **held_against(h, h_cpu, 1e-5, "Tree-LSTM card vs CPU")}
    emit({"phase": "graph_utilities", "utilities": timings,
          "check": "card result equal to the CPU's (indices, host values, "
                   "graphs, frames); device values rtol=1e-5, "
                   "atol=1e-5*max|ref|", **tag})
    return timings


# ---------------------------------------------------------------------------
# the host samplers and dataloading: products-scale GraphSAGE (node
# classification and link prediction), the minibatch R-GCN on ogbn-mag,
# and every host sampler card against CPU
# ---------------------------------------------------------------------------

PRODUCTS_N, PRODUCTS_PAIRS = 2_449_029, 61_859_140  # ogbn-products
PRODUCTS_FEAT, PRODUCTS_CLASSES, PRODUCTS_HIDDEN = 100, 47, 256
# examples/pytorch/graphsage/node_classification.py: fanouts, batch, Adam
PRODUCTS_FANOUTS, PRODUCTS_BATCH, PRODUCTS_LR = [10, 10, 10], 1024, 1e-3
PRODUCTS_STEPS = 5
STEADY_STEPS = 3  # after the main path: the loader's steady state
DRAIN = 2 + 2  # the DataLoader's num_prefetch, plus two: see timed_training
PRODUCTS_INFER_BATCH = 4096
# examples/pytorch/graphsage/link_pred.py
LINK_PRED_FANOUTS, LINK_PRED_BATCH = [15, 10, 5], 512
# examples/pytorch/ogb/ogbn-mag/hetero_rgcn.py
MAG_MB_FANOUTS, MAG_MB_BATCH = [25, 20], 1024
SAMPLER_SEEDS = 1024  # the per-seed samplers' seeds in host_samplers
DEEPWALK_SEEDS, DEEPWALK_STEPS = 256, 3


def products_graph(seed: int = 45, device="cuda") -> dict:
    """A synthetic graph at ogbn-products' counts: the SBM recipe of
    ``dgl_tpu/data/synthetic.py:114-126`` (47 classes, homophily 0.8,
    gaussian 100-wide features, the recipe's 60 % train split), its
    61,859,140 pairs stored both ways in order (edge ``i``'s reverse is
    ``i +- 61,859,140``), neither deduplicated nor sorted. Returns the
    graph on ``device`` with ``feat`` and ``label``, its copy on the CPU,
    the train ids, the reverse edge ids and the set-up seconds."""
    import numpy as np

    import dgl_tpu_torch as dt

    t0 = time.perf_counter()
    n, e = PRODUCTS_N, PRODUCTS_PAIRS
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, PRODUCTS_CLASSES, n)
    src = rng.integers(0, n, e)
    intra = rng.random(e) < 0.8
    order = np.argsort(labels, kind="stable")
    gstart = np.searchsorted(labels[order], np.arange(PRODUCTS_CLASSES + 1))
    lo = gstart[labels[src]]
    width = np.maximum(gstart[labels[src] + 1] - lo, 1)
    same = order[lo + (rng.random(e) * width).astype(np.int64)]
    dst = np.where(intra, same, rng.integers(0, n, e))
    del intra, lo, width, same
    centroids = rng.normal(size=(PRODUCTS_CLASSES, PRODUCTS_FEAT)) * 2.0
    feat = (centroids[labels] + rng.normal(size=(n, PRODUCTS_FEAT))).astype(
        np.float32)
    train = np.sort(rng.permutation(n)[:int(n * 0.6)])
    data_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    g = dt.graph((np.concatenate([src, dst]), np.concatenate([dst, src])),
                 num_nodes=n, device=device)
    del src, dst
    graph_s = time.perf_counter() - t1
    g.ndata["feat"] = _on(feat, device)
    g.ndata["label"] = _on(labels, device)
    reverse = np.concatenate([np.arange(e, 2 * e), np.arange(e)])
    t1 = time.perf_counter()
    g_cpu = g.to("cpu")
    return {"g": g, "g_cpu": g_cpu, "train": train, "reverse": reverse,
            "data_s": data_s, "graph_s": graph_s,
            "cpu_copy_s": time.perf_counter() - t1,
            "setup_s": time.perf_counter() - t0}


def _on(a, device):
    import numpy as np
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def block_edges(blocks) -> int:
    """The sampled edges of a batch's blocks: a ragged block's edges, a
    fixed-shape block's unmasked slots."""
    total = 0
    for b in blocks:
        for cet, rel in b._relations.items():
            mask = b._edge_frames.get(cet, {}).get("_mask")
            total += rel.num_edges if mask is None else int(mask.sum())
    return total


def first_batches(make_sampler, g, g_cpu, ids, batch, device, count=2):
    """The loader's first ``count`` batches sampled inline (each timed,
    before any sampling thread exists), the first one over the CPU graph,
    and the same batches with the prefetch thread, each from a sampler and
    loader of the same seeds; the CPU's and the thread's must equal the
    inline ones. Returns the threaded loader's iterator (the batches it
    gave first in front), and the inline batches' host seconds, the first
    one's (the host library's build, the int64 CSC) first."""
    import itertools

    from dgl_tpu_torch.dataloading import DataLoader

    def loader(graph, dev, thread):
        return DataLoader(graph, ids, make_sampler(), batch_size=batch,
                          shuffle=True, seed=0, device=dev,
                          use_prefetch_thread=thread)

    inline, sample_s = [], []
    inline_it = iter(loader(g, device, False))
    for _ in range(count + 1):  # the first pays the one-time host work
        t0 = time.perf_counter()
        inline.append(next(inline_it))
        _sync(device)
        sample_s.append(time.perf_counter() - t0)
    del inline_it
    cpu = next(iter(loader(g_cpu, "cpu", False)))
    same_result(inline[0], cpu, "the first batch on the card vs the CPU")
    del cpu
    it = iter(loader(g, device, True))
    threaded = [next(it) for _ in range(count)]
    for i, (a, b) in enumerate(zip(threaded, inline)):
        same_result(a, b, f"batch {i} with the prefetch thread vs without")
    return itertools.chain(threaded, it), sample_s


def sage_loss(model, blocks, pattern=None):
    """node_classification.py's loss over the blocks' own features and
    labels, the ReLUs recorded (or following ``pattern``)."""
    import torch.nn.functional as F

    with relu_pattern(pattern) as seen:
        logits = model(blocks, blocks[0].srcdata["feat"])
        loss = F.cross_entropy(logits, blocks[-1].dstdata["label"])
    return loss, seen


def step_vs_cpu(model, make_cpu_model, loss_fn, batch, tol=1e-4,
                batch_cpu=None) -> dict:
    """The first step's loss and gradients on the card against the CPU's
    (dropout off, the CPU pass on the card pass's ReLU pattern) at
    rtol = ``tol``, atol = ``tol`` * max|ref|; the CPU's batch is
    ``batch_cpu``, or ``batch`` moved to the CPU."""
    from dgl_tpu_torch.dataloading.dataloader import to_device

    model_cpu = make_cpu_model()
    model_cpu.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    model.eval()
    model_cpu.eval()
    loss, pattern = loss_fn(model, batch)
    loss.backward()
    ref, _ = loss_fn(model_cpu, to_device(batch, "cpu") if batch_cpu is None
                     else batch_cpu, [p.cpu() for p in pattern])
    ref.backward()
    got = {"loss": loss.detach()}
    want = {"loss": ref.detach()}
    for (k, p), q in zip(model.named_parameters(), model_cpu.parameters()):
        if q.grad is not None:
            got[k], want[k] = p.grad, q.grad
    errs = held(got, want, tol, "the first step on the card vs the CPU")
    model.zero_grad(set_to_none=True)
    model.train()
    return errs


def train_loop(model, opt, loss_fn, batches, steps, device):
    """``steps`` steps over the next batches of the iterator ``batches``,
    with the launch counts read around them; returns the losses, the
    wall time a step (waits on the sampler included), the card's time a
    step, the sampled edges a second and the launch counts."""
    import torch

    from dgl_tpu_torch import _kernels

    _sync(device)
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    losses, step_s, edges = [], [], 0
    t0 = time.perf_counter()
    for _ in range(steps):
        batch = next(batches)
        t1 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)[0]
        loss.backward()
        opt.step()
        _sync(device)
        step_s.append(time.perf_counter() - t1)
        losses.append(loss.item())
        edges += block_edges(batch[-1])
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    expect_no_other_launch(launches, {}, "a minibatch training loop")
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"non-finite minibatch losses: {losses}")
    return {"losses": losses, "launches": launches,
            "ms_per_step": wall / steps * 1e3,
            "step_ms": sum(step_s) / steps * 1e3,
            "edges_per_s": edges / wall, "sampled_edges": edges,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}


def timed_training(model, opt, loss_fn, batches, device) -> dict:
    """The main path (``PRODUCTS_STEPS`` counted steps, the first batches
    already prefetched), then the loader's buffer drained (``DRAIN``
    batches taken without a step: the ``num_prefetch`` queued, the one its
    thread holds, and one that waits for the thread), then
    ``STEADY_STEPS`` more, each of which waits for a batch the thread
    starts sampling as the step before it starts, as an epoch's later
    steps do: ``ms_per_step`` and ``edges_per_s`` are theirs. Then two
    profiled steps."""
    res = train_loop(model, opt, loss_fn, batches, PRODUCTS_STEPS, device)
    t0 = time.perf_counter()
    for _ in range(DRAIN):
        next(batches)
    drain_s = time.perf_counter() - t0
    steady = train_loop(model, opt, loss_fn, batches, STEADY_STEPS, device)
    res.update({"counted_ms_per_step": res["ms_per_step"],
                "drained_batches": DRAIN, "drain_ms": drain_s * 1e3,
                "steady_step_ms": steady["step_ms"],
                "ms_per_step": steady["ms_per_step"],
                "edges_per_s": steady["edges_per_s"],
                "steady_losses": steady["losses"]})
    res.update(profiled_steps(model, opt, loss_fn, batches))
    return res


def profiled_steps(model, opt, loss_fn, it) -> dict:
    """``device_profile`` of two more loader steps (one warm inside the
    trace): the device's idle share while the loop waits on the
    sampler."""
    def step():
        batch = next(it)
        opt.zero_grad(set_to_none=True)
        loss_fn(model, batch)[0].backward()
        opt.step()

    prof = device_profile(step, 1)
    return {k: prof[k] for k in ("wall_ms_per_call",
                                 "device_busy_ms_per_call",
                                 "device_idle_share",
                                 "kernel_launches_per_call")}


def run_products_sage(pg, tag: dict, device="cuda") -> dict:
    """Phase products_sage_minibatch: node_classification.py's GraphSAGE
    100-256-256-47 (mean) over ``NeighborSampler([10, 10, 10])`` blocks
    through the ``DataLoader`` (batch 1,024, shuffled, the prefetch
    thread), Adam at 1e-3; then the same with ``LaborSampler``, and one
    batch of 4,096 nodes through ``MultiLayerFullNeighborSampler(1)``
    into the first layer."""
    import numpy as np
    import torch

    from dgl_tpu_torch.dataloading import (DataLoader, LaborSampler,
                                           MultiLayerFullNeighborSampler,
                                           NeighborSampler)
    from dgl_tpu_torch.models import GraphSAGE

    g, g_cpu, train = pg["g"], pg["g_cpu"], pg["train"]

    def model_on(dev):
        return GraphSAGE(PRODUCTS_FEAT, PRODUCTS_HIDDEN, PRODUCTS_CLASSES,
                         num_layers=3, dropout=0.5,
                         generator=torch.Generator().manual_seed(0),
                         device=dev)

    out = {}
    for name, make in (
            ("neighbor", lambda: NeighborSampler(PRODUCTS_FANOUTS, seed=0)),
            ("labor", lambda: LaborSampler(PRODUCTS_FANOUTS, seed=0))):
        t_phase = time.perf_counter()
        batches, sample_s = first_batches(make, g, g_cpu, train,
                                          PRODUCTS_BATCH, device)
        first = next(batches)
        model = model_on(device)
        check = step_vs_cpu(model, lambda: model_on("cpu"), sage_loss,
                            first[2])
        opt = torch.optim.Adam(model.parameters(), lr=PRODUCTS_LR)
        res = timed_training(model, opt, lambda m, b: sage_loss(m, b[2]),
                             itertools.chain([first], batches), device)
        del batches
        blocks = first[2]
        res.update({
            "sampler": name,
            "sample_ms": float(np.mean(sample_s[1:])) * 1e3,
            "first_sample_ms": sample_s[0] * 1e3,
            "frontier_nodes": [b.num_src_nodes() for b in blocks]
            + [blocks[-1].num_dst_nodes()],
            "block_edges": [b.num_edges() for b in blocks],
            "first_step_vs_cpu": check,
            "tolerance": "rtol=1e-4, atol=1e-4*max|ref| (dropout off, the "
                         "CPU on the card pass's ReLU pattern)",
            "phase_s": time.perf_counter() - t_phase})
        emit({"phase": "products_sage_minibatch", **res, **tag})
        out[name] = res

    # the first step of layer-wise inference: every in-edge of 4,096 nodes
    # into the first layer
    ids = np.random.default_rng(1).permutation(PRODUCTS_N)[
        :PRODUCTS_INFER_BATCH]
    layer = model.sage0.eval()
    full = []
    for graph, dev in ((g, device), (g_cpu, "cpu")):
        t0 = time.perf_counter()
        batch = next(iter(DataLoader(graph, ids,
                                     MultiLayerFullNeighborSampler(1),
                                     batch_size=PRODUCTS_INFER_BATCH,
                                     device=dev, use_prefetch_thread=False)))
        _sync(dev)
        sample = time.perf_counter() - t0
        block = batch[2][0]
        lay = layer if dev == device else model_on("cpu").sage0.eval()
        if dev != device:
            lay.load_state_dict({k: v.cpu()
                                 for k, v in layer.state_dict().items()})
        with torch.no_grad():
            t0 = time.perf_counter()
            h = lay(block, block.srcdata["feat"])
            _sync(dev)
        full.append((batch, h, sample, time.perf_counter() - t0))
    same_result(full[0][0], full[1][0], "the full-neighbour block")
    err = held_against(full[0][1], full[1][1], 1e-4, "layer-wise inference")
    res = {"seeds": PRODUCTS_INFER_BATCH,
           "block_edges": full[0][0][2][0].num_edges(),
           "src_nodes": full[0][0][2][0].num_src_nodes(),
           "sample_ms": full[0][2] * 1e3, "layer_ms": full[0][3] * 1e3,
           "cpu_sample_ms": full[1][2] * 1e3, "cpu_layer_ms": full[1][3] * 1e3,
           "vs_cpu": err}
    emit({"phase": "products_layerwise_inference", **res, **tag})
    out["layerwise_inference"] = res
    return out


def link_loss(model, batch, pattern=None):
    """link_pred.py's loss: the dot product of the endpoints' encodings,
    ``-log sigmoid(pos) - log sigmoid(-neg)``, each a mean."""
    import torch.nn.functional as F

    from dgl_tpu_torch.nn import EdgePredictor

    _, pair, neg, blocks = batch
    with relu_pattern(pattern) as seen:
        h = model(blocks, blocks[0].srcdata["feat"])
    score = EdgePredictor("dot")
    ps, pd = pair.edges()
    ns, nd = neg.edges()
    pos = score(h[ps.long()], h[pd.long()]).squeeze(-1)
    negs = score(h[ns.long()], h[nd.long()]).squeeze(-1)
    loss = -F.logsigmoid(pos).mean() - F.logsigmoid(-negs).mean()
    return loss, seen


def run_products_link(pg, tag: dict, device="cuda") -> dict:
    """Phase products_link_prediction: link_pred.py's recipe over the
    products graph: ``as_edge_prediction_sampler(NeighborSampler([15, 10,
    5]), exclude="reverse_id", negative_sampler=Uniform(1))``, batch 512
    seed edges, a 3-layer SAGE encoder 100-256-256-256 and the dot-product
    scorer, Adam at 1e-3, 5 steps."""
    import numpy as np
    import torch

    from dgl_tpu_torch.base import EID, NID
    from dgl_tpu_torch.dataloading import (NeighborSampler, Uniform,
                                           as_edge_prediction_sampler)
    from dgl_tpu_torch.models import GraphSAGE

    t_phase = time.perf_counter()
    g, g_cpu, reverse = pg["g"], pg["g_cpu"], pg["reverse"]

    def make():
        return as_edge_prediction_sampler(
            NeighborSampler(LINK_PRED_FANOUTS, seed=0), exclude="reverse_id",
            reverse_eids=reverse, negative_sampler=Uniform(1, seed=0))

    def model_on(dev):
        return GraphSAGE(PRODUCTS_FEAT, PRODUCTS_HIDDEN, PRODUCTS_HIDDEN,
                         num_layers=3, dropout=0.0,
                         generator=torch.Generator().manual_seed(0),
                         device=dev)

    seed_edges = np.arange(g.num_edges())
    batches, sample_s = first_batches(make, g, g_cpu, seed_edges,
                                      LINK_PRED_BATCH, device)
    firsts = [next(batches), next(batches)]
    # no seed edge, and no reverse of one, in the batches' blocks
    order = np.random.default_rng(0).permutation(seed_edges.shape[0])
    src, dst = g._relation().host_edges()
    leaks = 0
    for i, (_, pair, neg, blocks) in enumerate(firsts):
        seeds = order[i * LINK_PRED_BATCH:(i + 1) * LINK_PRED_BATCH]
        banned = torch.from_numpy(np.concatenate([seeds, reverse[seeds]]))
        nid = pair.ndata[NID].cpu().numpy()
        ps, pd = (t.cpu().numpy() for t in pair.edges())
        if not np.array_equal(
                np.sort(nid[ps].astype(np.int64) * PRODUCTS_N + nid[pd]),
                np.sort(src[seeds].astype(np.int64) * PRODUCTS_N
                        + dst[seeds])):
            raise RuntimeError("the pair graph holds other edges than the "
                               "batch's seed edges")
        for b in blocks:
            leaks += int(torch.isin(b.edata[EID].cpu(), banned).sum())
    if leaks:
        raise RuntimeError(f"{leaks} seed edges or their reverses in the "
                           "link prediction blocks")
    model = model_on(device)
    check = step_vs_cpu(model, lambda: model_on("cpu"), link_loss,
                        firsts[0])
    opt = torch.optim.Adam(model.parameters(), lr=PRODUCTS_LR)
    res = timed_training(model, opt, link_loss,
                         itertools.chain(firsts, batches), device)
    del batches
    blocks = firsts[0][3]
    res.update({
        "sample_ms": float(np.mean(sample_s[1:])) * 1e3,
        "first_sample_ms": sample_s[0] * 1e3,
        "frontier_nodes": [b.num_src_nodes() for b in blocks]
        + [blocks[-1].num_dst_nodes()],
        "block_edges": [b.num_edges() for b in blocks],
        "pair_edges": firsts[0][1].num_edges(),
        "negative_edges": firsts[0][2].num_edges(),
        "excluded_leaks": leaks, "first_step_vs_cpu": check,
        "tolerance": "rtol=1e-4, atol=1e-4*max|ref| (the CPU on the card "
                     "pass's ReLU pattern)",
        "phase_s": time.perf_counter() - t_phase})
    emit({"phase": "products_link_prediction", **res, **tag})
    return res


def rgcn_blocks(model, blocks, inputs, pattern=None):
    """``hetero_rgcn``'s two layers over two blocks: the paper logits."""
    import torch

    with relu_pattern(pattern) as seen:
        h = {k: torch.relu(v)
             for k, v in model.layer0(blocks[0], inputs).items()}
        out = model.layer1(blocks[1], h)["paper"]
    return out, seen


def run_mag_minibatch(g, feats, labels, train, tag: dict,
                      device="cuda") -> dict:
    """Phase mag_rgcn_minibatch: ``hetero_rgcn``'s 128-64-349 R-GCN over
    ``HeteroFixedShapeNeighborSampler`` blocks of ``run_mag``'s graph,
    fanouts [25, 20] (hetero_rgcn.py's) on every relation into a sampled
    type, 1,024 paper seeds a batch, Adam at 1e-2, 5 steps."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from dgl_tpu_torch.base import NID
    from dgl_tpu_torch.dataloading import HeteroFixedShapeNeighborSampler
    from dgl_tpu_torch.dataloading.dataloader import to_device

    t_phase = time.perf_counter()
    g_cpu = g.to("cpu")
    fanouts = [{cet: f for cet in g.canonical_etypes}
               for f in MAG_MB_FANOUTS]

    def make(dev):
        return HeteroFixedShapeNeighborSampler(
            g, fanouts, MAG_MB_BATCH, seed_ntype="paper", seed=0,
            device=dev)

    sampler = make(device)
    seeds = np.random.default_rng(2).permutation(train)[
        :MAG_MB_BATCH * (PRODUCTS_STEPS + 1)].reshape(-1, MAG_MB_BATCH)
    seeds[-1, -5:] = -1  # a short batch: the last one's tail is padding
    batches, sample_s = [], []
    for s in seeds:
        t0 = time.perf_counter()
        batches.append(sampler.sample_blocks(g, s[s >= 0]))
        _sync(device)
        sample_s.append(time.perf_counter() - t0)
    cpu = make("cpu").sample_blocks(g_cpu, seeds[0])
    same_result(batches[0], cpu, "the hetero blocks on the card vs the CPU")
    shapes = {tuple((tuple(b._num_src_nodes.items()),
                     tuple(b._num_dst_nodes.items()),
                     tuple((c, r.num_edges_padded)
                           for c, r in b._relations.items()))
                    for b in blk) for _, _, blk in batches}
    if len(shapes) != 1:
        raise RuntimeError(f"hetero block shapes vary: {len(shapes)}")

    def inputs(blocks, x):
        src = blocks[0]._node_frames
        return {nt: x[nt][src[nt][NID]] * src[nt]["_mask"][:, None]
                for nt in blocks[0].srctypes}

    def loss_fn(model, batch, pattern=None, x=feats, y=labels):
        blocks = batch[2]
        logits, seen = rgcn_blocks(model, blocks, inputs(blocks, x), pattern)
        dst = blocks[-1]._dst_frames["paper"]
        m = dst["_mask"].to(torch.float32)
        ce = F.cross_entropy(logits, y[dst[NID]], reduction="none")
        return (ce * m).sum() / m.sum(), seen

    model = hetero_rgcn(g.etypes, (MAG_FEAT, MAG_HIDDEN, MAG_CLASSES),
                        0).to(device)
    feats_cpu = {k: v.cpu() for k, v in feats.items()}
    labels_cpu = labels.cpu()

    def cpu_loss(m, b, pattern=None):
        return loss_fn(m, b, pattern, feats_cpu, labels_cpu)

    # hetero_rgcn makes its GraphConvs on the card: the CPU copy moves
    model_cpu = hetero_rgcn(g.etypes, (MAG_FEAT, MAG_HIDDEN, MAG_CLASSES),
                            0).cpu()
    model_cpu.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    loss, pattern = loss_fn(model, batches[0])
    loss.backward()
    ref, _ = cpu_loss(model_cpu, to_device(batches[0], "cpu"),
                      [p.cpu() for p in pattern])
    ref.backward()
    got, want = {"loss": loss.detach()}, {"loss": ref.detach()}
    for (k, p), q in zip(model.named_parameters(), model_cpu.parameters()):
        if q.grad is not None:
            got[k], want[k] = p.grad, q.grad
    check = held(got, want, 1e-4, "the R-GCN minibatch step vs the CPU")
    model.zero_grad(set_to_none=True)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    # each step samples its batch inline, as a loop over the sampler does:
    # ms_per_step counts the sampling, step_ms the card's part alone
    inline = (sampler.sample_blocks(g, s[s >= 0]) for s in seeds[1:])
    res = train_loop(model, opt, loss_fn, inline, PRODUCTS_STEPS, device)
    prof = device_profile(lambda: loss_fn(model, batches[0])[0].backward(),
                          2)
    res.update({
        "sample_ms": float(np.mean(sample_s[1:])) * 1e3,
        "first_sample_ms": sample_s[0] * 1e3,
        "slot_caps": [{nt: c for nt, c in layer.items()}
                      for layer in sampler.caps],
        "real_edges_first_batch": {
            str(c): int(b._edge_frames[c]["_mask"].sum())
            for b in batches[0][2] for c in b.canonical_etypes},
        "first_step_vs_cpu": check,
        "tolerance": "rtol=1e-4, atol=1e-4*max|ref| (the CPU on the card "
                     "pass's ReLU pattern)",
        "step_device_idle_share": prof["device_idle_share"],
        "phase_s": time.perf_counter() - t_phase})
    emit({"phase": "mag_rgcn_minibatch", **res, **tag})
    return res


def timed_on_both(cases, g, g_cpu, timings, **info):
    """Each case (a function of the graph) on the card graph and on the
    CPU graph, timed, the results equal (``same_result``). A first,
    untimed call on the card pays the one-time host work (the int64
    index and float64 weight copies, which the two graphs share)."""
    for name, fn in cases.items():
        fn(g)
        _sync(g.device)
        t0 = time.perf_counter()
        got = fn(g)
        _sync(g.device)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = fn(g_cpu)
        cpu_s = time.perf_counter() - t0
        same_result(got, want, name)
        timings[name] = {"card_s": card_s, "cpu_s": cpu_s, **info}


def per_seed_cases(seeds, reverse_half: int):
    """The samplers that pick per seed, each a function of the graph
    (which holds ``w`` and ``timestamp``)."""
    import numpy as np

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import sampling as S
    from dgl_tpu_torch.dataloading import (CappedNeighborSampler,
                                           FixedShapeNeighborSampler)

    excl = np.concatenate([np.arange(0, reverse_half, 997),
                           np.arange(reverse_half, 2 * reverse_half, 991)])
    return {
        "sample_neighbors prob": lambda g: S.sample_neighbors(
            g, seeds, 10, prob="w", seed=1),
        "sample_neighbors replace": lambda g: S.sample_neighbors(
            g, seeds, 25, replace=True, seed=2),
        "sample_neighbors exclude_edges": lambda g: S.sample_neighbors(
            g, seeds, 10, exclude_edges=excl, seed=3),
        "Graph.sample_neighbors out": lambda g: g.sample_neighbors(
            seeds, 5, edge_dir="out", seed=4),
        "sample_neighbors_fixed prob": lambda g: S.sample_neighbors_fixed(
            g, seeds, 10, prob="w", seed=5),
        "select_topk": lambda g: S.select_topk(g, 5, "w", nodes=seeds),
        "sample_neighbors_fused": lambda g: S.sample_neighbors_fused(
            g, seeds, 10, seed=6),
        "temporal_sample_neighbors": lambda g: S.temporal_sample_neighbors(
            g, seeds[:256], 10, seed=7),
        "sample_labors": lambda g: S.sample_labors(g, seeds, 10,
                                                   random_seed=8),
        "sample_labors importance_sampling=2": lambda g: S.sample_labors(
            g, seeds, 10, importance_sampling=2, random_seed=9),
        "FixedShapeNeighborSampler prob": lambda g: FixedShapeNeighborSampler(
            [10, 10], len(seeds), prob="w", seed=10,
            device=g.device).sample_blocks(g, seeds),
        "CappedNeighborSampler": lambda g: CappedNeighborSampler(
            [10, 10], 4096, False, seed=11).sample(g, seeds),
        "in_subgraph_sample": lambda g: S.in_subgraph_sample(g, seeds[:64]),
        "random_walk": lambda g: S.random_walk(g, seeds, length=40, seed=12),
        "random_walk restart_prob": lambda g: S.random_walk(
            g, seeds[:256], length=20, restart_prob=0.1, seed=13),
        "node2vec_random_walk": lambda g: S.node2vec_random_walk(
            g, seeds[:64], 0.5, 2.0, 10, seed=14),
        "dt.in_subgraph": lambda g: dt.in_subgraph(g, seeds[:64]),
    }


def other_cases(n: int):
    """The samplers that do not pick per seed, on the arxiv zipf graph."""
    import numpy as np

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import sampling as S
    from dgl_tpu_torch.dataloading import (NeighborSampler, SAINTSampler,
                                           ShaDowKHopSampler, SpotTarget,
                                           Uniform,
                                           as_edge_prediction_sampler)

    seeds = np.random.default_rng(15).permutation(n)[:1024]
    tags = np.random.default_rng(16).integers(0, 4, n)

    def biased(g):
        return S.sample_neighbors_biased(dt.sort_csc_by_tag(g, tags), seeds,
                                         10, bias=[0.5, 1.0, 2.0, 0.0],
                                         seed=17)

    def spot(g):
        eids = np.arange(0, g.num_edges(), 1009)
        return as_edge_prediction_sampler(
            NeighborSampler([5, 5], seed=18),
            exclude=SpotTarget(g, degree_threshold=20),
            negative_sampler=Uniform(2, seed=18)).sample(g, eids)

    return {
        "sample_neighbors_biased": biased,
        "global_uniform_negative_sampling": lambda g: (
            S.global_uniform_negative_sampling(g, 100_000, seed=19)),
        "SAINTSampler node": lambda g: SAINTSampler(
            "node", 8000, seed=20).sample(g),
        "SAINTSampler edge": lambda g: SAINTSampler(
            "edge", 20000, seed=20).sample(g),
        "SAINTSampler walk": lambda g: SAINTSampler(
            "walk", (2000, 4), seed=20).sample(g),
        "ShaDowKHopSampler": lambda g: ShaDowKHopSampler(
            [10, 5], seed=21).sample(g, seeds[:256]),
        "SpotTarget edge prediction": spot,
        "pack_traces": lambda g: S.pack_traces(*S.random_walk(
            g, seeds, length=10, restart_prob=0.2, seed=22)),
    }


def bipartite_cases(n: int):
    """PinSAGE and the device sampler on graphs of two node types built
    from the zipf graph's edges (items -> users)."""
    import numpy as np
    import torch

    from dgl_tpu_torch import sampling as S
    from dgl_tpu_torch.sampling.device_sampler import _pick

    seeds = np.random.default_rng(23).permutation(n)[:1024]

    def pinsage(g):
        return S.PinSAGESampler(g, "item", "user", 3, 0.5, 10, 10,
                                seed=24)(seeds)

    def device_sampler(g):
        """One layer of ``DeviceNeighborSampler.sample_from`` over the one
        edge type from the graph's device generator, and the picks the
        same draws give through ``_pick`` on the CPU."""
        one = g.edge_type_subgraph(["liked-by"])
        gen = torch.Generator(device=one.device).manual_seed(25)
        state = gen.get_state()
        ids = torch.from_numpy(seeds[:512]).to(one.device)
        mfg = S.DeviceNeighborSampler([10]).sample_from(gen, one, ids)
        gen.set_state(state)
        u = torch.rand((ids.shape[0], 10), generator=gen,
                       device=one.device).cpu()
        rel = one._relation().to("cpu")
        indptr = rel.csc_indptr.to(torch.int32)
        start = indptr[ids.cpu()]
        deg = indptr[ids.cpu() + 1] - start
        pos, mask = _pick(u, start, deg, 10, "unique")
        want = rel.csc_indices.to(torch.int32)[pos.clamp(
            max=rel.csc_indices.shape[0] - 1).long()]
        if not (torch.equal(mfg.masks[0].cpu(), mask)
                and torch.equal(mfg.nbrs[0].cpu()[mask], want[mask])):
            raise RuntimeError("DeviceNeighborSampler.sample_from: the "
                               "picks differ from _pick's on its draws")
        # the draws are each device's own: what both must give is the
        # agreement with _pick above
        return int(mfg.nbrs[0].shape[0])

    return {"PinSAGESampler": pinsage,
            "DeviceNeighborSampler.sample_from": device_sampler}


def run_host_samplers(pg, tag: dict, device="cuda") -> dict:
    """Phase host_samplers: every host sampler once with the graph on the
    card and once with it on the CPU, the results equal; each one's time
    on each. The per-seed samplers on the products graph (1,024 seeds),
    the rest on the arxiv zipf graph, PinSAGE and the device sampler on
    item -> user graphs of the zipf graph's edges; then DeepWalk (dim 128,
    walks of 40, window 5) steps on the zipf graph, the loss against the
    CPU."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch.nn import DeepWalk

    t_phase = time.perf_counter()
    timings = {}
    g, g_cpu = pg["g"], pg["g_cpu"]
    rng = np.random.default_rng(26)
    w = rng.random(g.num_edges()).astype(np.float32)
    ts = rng.random(g.num_nodes()).astype(np.float32)
    for graph in (g, g_cpu):
        graph.edata["w"] = _on(w, graph.device)
        graph.ndata["timestamp"] = _on(ts, graph.device)
    del w
    seeds = np.random.default_rng(27).permutation(PRODUCTS_N)[
        :SAMPLER_SEEDS]
    timed_on_both(per_seed_cases(seeds, PRODUCTS_PAIRS), g, g_cpu, timings,
                  graph="products")
    for graph in (g, g_cpu):
        del graph.edata["w"], graph.ndata["timestamp"]

    src, dst = zipf_graph(0)
    z = dt.graph((src, dst), num_nodes=N_NODES, device=device)
    z_cpu = z.to("cpu")
    timed_on_both(other_cases(N_NODES), z, z_cpu, timings, graph="arxiv zipf")
    counts = {"item": N_NODES, "user": N_NODES}
    data = {("item", "liked-by", "user"): (src, dst),
            ("user", "likes", "item"): (dst, src)}
    b = dt.heterograph(data, counts, device=device)
    timed_on_both(bipartite_cases(N_NODES), b, b.to("cpu"), timings,
                  graph="arxiv zipf, item -> user")

    # DeepWalk: the batches are host draws (equal on both sides), the loss
    # and its SGD steps on each device
    losses = {}
    for dev, graph in ((device, z), ("cpu", z_cpu)):
        model = DeepWalk(N_NODES, emb_dim=128, walk_length=40, window_size=5,
                         generator=torch.Generator().manual_seed(0),
                         device=dev)
        opt = torch.optim.SGD(model.parameters(), lr=0.5)
        rng = np.random.default_rng(28)
        t0 = time.perf_counter()
        out = []
        for _ in range(DEEPWALK_STEPS):
            batch = model.sample_batch(
                graph, rng.integers(0, N_NODES, DEEPWALK_SEEDS), rng)
            opt.zero_grad(set_to_none=True)
            loss = model(*batch)
            loss.backward()
            opt.step()
            out.append(loss.detach())
        _sync(dev)
        losses[dev] = (torch.stack(out).cpu(), time.perf_counter() - t0,
                       batch[0].shape[0])
    err = held_against(losses[device][0], losses["cpu"][0], 1e-4,
                       "DeepWalk losses card vs CPU")
    if not torch.isfinite(losses[device][0]).all():
        raise RuntimeError("DeepWalk: non-finite loss")
    timings["DeepWalk"] = {
        "card_s": losses[device][1], "cpu_s": losses["cpu"][1],
        "steps": DEEPWALK_STEPS, "pairs_last_step": losses[device][2],
        "losses": losses[device][0].tolist(), "vs_cpu": err,
        "tolerance": "rtol=1e-4, atol=1e-4*max|ref|"}
    emit({"phase": "host_samplers", "samplers": timings,
          "check": "card result equal to the CPU's (ids, graphs, frames); "
                   "DeepWalk's losses at 1e-4",
          "phase_s": time.perf_counter() - t_phase, **tag})
    return timings


def run_mag_etype_sampler(g, tag: dict) -> dict:
    """``sample_etype_neighbors`` over ``to_homogeneous`` of the mag graph
    (edge ids grouped by type), card against CPU."""
    import numpy as np

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import sampling as S

    t0 = time.perf_counter()
    h = dt.to_homogeneous(g)
    homo_s = time.perf_counter() - t0
    counts = [g.num_edges(c) for c in g.canonical_etypes]
    offset = np.concatenate([[0], np.cumsum(counts)])
    seeds = np.random.default_rng(29).permutation(h.num_nodes())[:4096]
    cases = {
        "sample_etype_neighbors": lambda x: S.sample_etype_neighbors(
            x, seeds, offset, np.array([10, 10, 5, 5]), seed=30),
        "sample_etype_neighbors keep-all and exclude": lambda x: (
            S.sample_etype_neighbors(x, seeds[:256], offset,
                                     np.array([-1, 5, 2, -1]),
                                     exclude_edges=np.arange(0, offset[-1],
                                                             97), seed=31)),
    }
    timings = {}
    timed_on_both(cases, h, h.to("cpu"), timings,
                  graph="to_homogeneous(mag)")
    emit({"phase": "host_samplers_mag", "samplers": timings,
          "to_homogeneous_s": homo_s, **tag})
    return timings


# ---------------------------------------------------------------------------
# GraphBolt: DGL's GraphBolt node-classification recipe at ogbn-products'
# counts from an on-disk dataset, the LABOR stage and the fused CSC
# sampling graph on the same graph, and the on-device backend
# ---------------------------------------------------------------------------

GB_HOT_ROWS = 262_144  # the card's feature cache: a tenth of the nodes
GB_TIMED_STEPS = 10
GB_STAGED_BATCHES = 1  # batches after the first run stage by stage
GB_DEVICE_STEPS = 40


def rss_mib() -> float:
    """This process's resident memory (``VmRSS``), MiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def mapped(path: str) -> bool:
    """Whether ``path`` is mapped into this process."""
    with open("/proc/self/maps") as f:
        return any(line.rstrip().endswith(path) for line in f)


def gb_pipeline(train, graph, store, device, batch=PRODUCTS_BATCH,
                fanouts=PRODUCTS_FANOUTS):
    """The recipe's datapipe: ``ItemSampler`` (batch 1,024, shuffled, seed
    0) -> ``NeighborSamplerStage([10, 10, 10])`` -> ``FeatureFetcher`` ->
    ``CopyTo``."""
    from dgl_tpu_torch import graphbolt as gb

    dp = gb.ItemSampler(train, batch, shuffle=True, seed=0)
    dp = gb.NeighborSamplerStage(dp, graph, fanouts, batch_size=batch,
                                 seed=0, device=device)
    dp = gb.FeatureFetcher(dp, store, ["feat"])
    return gb.CopyTo(dp, device)


def gb_loss(model, mb, pattern=None):
    """node_classification.py's loss over a GraphBolt batch: the logits of
    the real seed slots (the fixed-shape blocks' first ``len(labels)``
    output rows) against the labels, the ReLUs recorded (or following
    ``pattern``)."""
    import torch.nn.functional as F

    with relu_pattern(pattern) as seen:
        logits = model(mb.blocks, mb.node_features["feat"])
        loss = F.cross_entropy(logits[:mb.labels.shape[0]], mb.labels)
    return loss, seen


def gb_step(model, opt, mb, device) -> float:
    """One Adam step over a GraphBolt batch; its loss."""
    opt.zero_grad(set_to_none=True)
    loss = gb_loss(model, mb)[0]
    loss.backward()
    opt.step()
    _sync(device)
    return loss.item()


def same_gb_batch(a, b, what: str) -> None:
    """Two GraphBolt batches with equal seeds, labels, input ids, fetched
    features (exactly) and blocks."""
    import numpy as np

    for k in ("seeds", "labels"):
        same_result(getattr(a, k), getattr(b, k), f"{what}: {k}")
    if not np.array_equal(a.input_nodes, b.input_nodes):
        raise RuntimeError(f"{what}: input ids differ")
    same_result(a.node_features, b.node_features, f"{what}: features")
    same_result(a.blocks, b.blocks, f"{what}: blocks")


def staged_batches(copy, count: int, device):
    """``count`` batches of the pipeline ending in the CopyTo stage
    ``copy``, each stage applied in turn and timed (the sampler, the
    fetch, the copy), and the fetch's disk reads alone (the batch's rows
    that miss the card's cache, read again); returns the batches and the
    ms of each stage, a list per stage."""
    import numpy as np

    fetch = copy.source
    sample = fetch.source
    cache = fetch.store[("node", "_N", "feat")]
    items = iter(sample.source)
    batches, ms = [], {"sample": [], "fetch": [], "copy": [], "disk": []}
    for _ in range(count):
        mb = next(items)
        t0 = time.perf_counter()
        mb = sample._apply(mb)
        t1 = time.perf_counter()
        mb = fetch._apply(mb)
        _sync(device)
        t2 = time.perf_counter()
        mb = copy._apply(mb)
        _sync(device)
        t3 = time.perf_counter()
        miss = mb.input_nodes[~np.isin(mb.input_nodes, cache._hot_sorted)]
        t4 = time.perf_counter()
        cache._fb.read(miss)
        for k, v in (("sample", t1 - t0), ("fetch", t2 - t1),
                     ("copy", t3 - t2), ("disk", time.perf_counter() - t4)):
            ms[k].append(v * 1e3)
        batches.append(mb)
    return batches, ms


def run_graphbolt_products(pg, tag: dict, device="cuda") -> dict:
    """Phase graphbolt_products: DGL's GraphBolt ``node_classification.py``
    from disk. ``pg``'s graph, features, labels and train split go through
    ``gb.OnDiskDataset.write`` into a directory under ``build/`` (removed
    after) and load back; the loaded graph's CSC equals ``pg["g"]``'s. The
    features are a ``DiskBasedFeature`` (pread) behind
    ``HBMFeatureCache.from_degrees`` with ``GB_HOT_ROWS`` rows on the card.
    The first batch (blocks, input ids, features) equals the same
    pipeline's over the CPU graph with the features in memory; the first
    step (dropout off) is held against the CPU at 1e-4. Then
    ``GB_STAGED_BATCHES`` more batches stage by stage (each stage timed)
    and stepped, one warm step and ``GB_TIMED_STEPS`` steps through
    ``gb.DataLoader`` (its prefetch thread) with the launch counts read
    around them, and two profiled steps."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch import graphbolt as gb
    from dgl_tpu_torch.models import GraphSAGE

    t_phase = time.perf_counter()
    g, g_cpu = pg["g"], pg["g_cpu"]
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    path = tempfile.mkdtemp(prefix="graphbolt_products_", dir=build)
    try:
        src, dst = g._relation().host_edges()
        t0 = time.perf_counter()
        gb.OnDiskDataset.write(
            path, name="ogbn-products", src=src.astype(np.int64),
            dst=dst.astype(np.int64), num_nodes=g.num_nodes(),
            features={"feat": g_cpu.ndata["feat"].numpy()},
            labels=g_cpu.ndata["label"].numpy(), train_ids=pg["train"],
            device=device)
        write_s = time.perf_counter() - t0
        del src, dst
        files = {n: os.path.getsize(os.path.join(path, n))
                 for n in sorted(os.listdir(path))}
        t0 = time.perf_counter()
        ds = gb.OnDiskDataset(path, device)
        graph, train = ds.graph, ds.train_set
        disk = ds.feature[("node", "_N", "feat")]
        _sync(device)
        load_s = time.perf_counter() - t0
        if not isinstance(disk, gb.DiskBasedFeature) or disk._io != "pread":
            raise RuntimeError("the on-disk features do not read by pread")
        rel, ref_rel = graph._relation(), g._relation()
        for f in ("csc_indptr", "csc_indices", "csc_eids"):
            if not np.array_equal(rel.host_arrays(f)[0],
                                  ref_rel.host_arrays(f)[0]):
                raise RuntimeError(f"the loaded graph's {f} differs")
        deg = np.diff(rel.host_arrays("csc_indptr")[0])
        t0 = time.perf_counter()
        cache = gb.HBMFeatureCache.from_degrees(disk, deg, GB_HOT_ROWS,
                                                device=device)
        _sync(device)
        cache_s = time.perf_counter() - t0
        store = gb.FeatureStore({("node", "_N", "feat"): cache})
        # the CPU's batch reads the features from memory: the card's rows
        # come through the disk and the cache, the CPU's do not
        store_cpu = gb.FeatureStore({("node", "_N", "feat"): gb.NumpyFeature(
            g_cpu.ndata["feat"].numpy())})

        def model_on(dev):
            return GraphSAGE(PRODUCTS_FEAT, PRODUCTS_HIDDEN,
                             PRODUCTS_CLASSES, num_layers=3, dropout=0.5,
                             generator=torch.Generator().manual_seed(0),
                             device=dev)

        # the first batch against the CPU's, then the staged batches
        staged, stage_ms = staged_batches(
            gb_pipeline(train, graph, store, device),
            1 + GB_STAGED_BATCHES, device)
        t0 = time.perf_counter()
        first_cpu = next(iter(gb_pipeline(train, g_cpu, store_cpu, "cpu")))
        cpu_batch_s = time.perf_counter() - t0
        first = staged[0]
        same_gb_batch(first, first_cpu, "the first batch, card vs CPU")
        if not np.array_equal(first.input_nodes,
                              first.blocks[0].srcdata["_ID"].cpu().numpy()):
            raise RuntimeError("input ids are not blocks[0].srcdata[NID]")
        model = model_on(device)
        check = step_vs_cpu(model, lambda: model_on("cpu"), gb_loss, first,
                            batch_cpu=first_cpu)
        del first_cpu, store_cpu
        opt = torch.optim.Adam(model.parameters(), lr=PRODUCTS_LR)
        staged_step_ms = []
        for mb in staged[1:]:
            t0 = time.perf_counter()
            gb_step(model, opt, mb, device)
            staged_step_ms.append((time.perf_counter() - t0) * 1e3)
        sizes = {"src_slots": [b.num_src_nodes() for b in first.blocks],
                 "dst_slots": [b.num_dst_nodes() for b in first.blocks],
                 "edge_slots": [b.num_edges() for b in first.blocks],
                 "real_edges": block_edges(first.blocks),
                 "distinct_input_nodes": int(np.unique(
                     first.input_nodes).shape[0])}
        del staged, first, mb

        # the main path: a fresh pipeline through the loader's thread, one
        # warm step, then the timed steps with the counts read around them
        loader = iter(gb.DataLoader(gb_pipeline(train, graph, store,
                                                device)))
        warm_loss = gb_step(model, opt, next(loader), device)
        hits0, miss0 = cache.hits, cache.misses
        torch.cuda.reset_peak_memory_stats()
        rss0 = rss_mib()
        _kernels.reset_launch_counts()
        losses, step_s = [], []
        t0 = time.perf_counter()
        for _ in range(GB_TIMED_STEPS):
            mb = next(loader)
            t1 = time.perf_counter()
            losses.append(gb_step(model, opt, mb, device))
            step_s.append(time.perf_counter() - t1)
        wall = time.perf_counter() - t0
        launches = dict(_kernels.launch_counts)
        rss1 = rss_mib()
        peak = torch.cuda.max_memory_allocated() / 2**30
        expect_no_other_launch(launches, {}, "the GraphBolt recipe")
        if not all(map(math.isfinite, [warm_loss] + losses)):
            raise RuntimeError(f"non-finite GraphBolt losses: {losses}")
        if mapped(os.path.join(path, "feat.npy")):
            raise RuntimeError("the pread path mapped the feature file")
        hits, misses = cache.hits - hits0, cache.misses - miss0
        prof = profiled_steps(model, opt, gb_loss, loader)
        # the last batch's cache misses three ways: the pread path as the
        # fetch takes it (by blocks where the rows lie dense), one pread a
        # row, and through a map of the file
        miss = mb.input_nodes[~np.isin(mb.input_nodes, cache._hot_sorted)]
        want = g_cpu.ndata["feat"].numpy()[miss]
        mm = gb.DiskBasedFeature(os.path.join(path, "feat.npy"), io="mmap")
        read_ms = {}
        for how, read in (
                ("pread", disk.read),
                ("pread a row", lambda i: disk._pread(
                    i, disk._row_bytes).view(want.dtype).reshape(want.shape)),
                ("mmap", mm.read)):
            t0 = time.perf_counter()
            rows = read(miss)
            read_ms[how] = (time.perf_counter() - t0) * 1e3
            if not np.array_equal(rows, want):
                raise RuntimeError(f"{how}: rows differ from the graph's")
        disk.close()
        del loader, mb, rows, want, mm
        res = {
            "recipe": "examples/graphbolt/node_classification.py: "
                      "ItemSampler(1024, shuffle) -> NeighborSamplerStage("
                      "[10, 10, 10]) -> FeatureFetcher(DiskBasedFeature "
                      "pread behind HBMFeatureCache) -> CopyTo -> "
                      "DataLoader; GraphSAGE 100-256-256-47 (mean, dropout "
                      "0.5), Adam 1e-3",
            "files_bytes": files, "write_s": write_s, "load_s": load_s,
            "cache_build_s": cache_s, "hot_rows": GB_HOT_ROWS,
            "hot_table_mib": GB_HOT_ROWS * PRODUCTS_FEAT * 4 / 2**20,
            "sample_ms": float(np.mean(stage_ms["sample"][1:])),
            "fetch_ms": float(np.mean(stage_ms["fetch"][1:])),
            "fetch_disk_read_ms": float(np.mean(stage_ms["disk"][1:])),
            "miss_rows": int(miss.shape[0]),
            "miss_rows_read_ms": read_ms,
            "copy_ms": float(np.mean(stage_ms["copy"][1:])),
            "first_batch_stage_ms": {k: v[0] for k, v in stage_ms.items()},
            "staged_step_ms": staged_step_ms,
            "step_ms": sum(step_s) / GB_TIMED_STEPS * 1e3,
            "ms_per_step": wall / GB_TIMED_STEPS * 1e3,
            "timed_steps": GB_TIMED_STEPS, "losses": [warm_loss] + losses,
            "cache_hits": hits, "cache_misses": misses,
            "cache_hit_rate": hits / max(hits + misses, 1),
            "block_sizes": sizes, "launches": launches,
            "peak_memory_gib": peak, "rss_growth_mib": rss1 - rss0,
            "rss_mib": rss1, "feature_file_mapped": False,
            "cpu_first_batch_s": cpu_batch_s, "first_step_vs_cpu": check,
            "tolerance": "batch exact; the first step rtol=1e-4, "
                         "atol=1e-4*max|ref| (dropout off, the CPU on the "
                         "card pass's ReLU pattern)",
            "reads": "from the page cache the write has just filled",
            **prof, "phase_s": time.perf_counter() - t_phase}
    finally:
        shutil.rmtree(path, ignore_errors=True)
    emit({"phase": "graphbolt_products", **res, **tag})
    return res


def run_graphbolt_layer_and_fused_csc(pg, tag: dict, device="cuda") -> dict:
    """Phase graphbolt_layer_and_fused_csc: the first batch of
    ``gb.LayerNeighborSampler([10, 10, 10])`` over the products graph, and
    ``gb.from_dglgraph`` of it with ``SamplePerLayer`` + ``CompactPerLayer``
    (3 layers of fanout 10, 1,024 seeds) into ``to_dgl_blocks`` and
    ``in_subgraph`` of the seeds: card against CPU, exactly, each timed;
    then the small cases: the graph cache stages, the CPU and card
    feature caches and ``all_to_all`` at world size 1."""
    import numpy as np
    import torch

    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch import graphbolt as gb

    t_phase = time.perf_counter()
    g, g_cpu = pg["g"], pg["g_cpu"]
    train = gb.ItemSet(pg["train"], names="seeds")
    timings = {}

    def both(name, run):
        out = []
        for graph, dev in ((g, device), (g_cpu, "cpu")):
            t0 = time.perf_counter()
            out.append(run(graph, dev))
            _sync(dev)
            timings.setdefault(name, {})[
                "card_s" if dev == device else "cpu_s"] = (
                time.perf_counter() - t0)
        return out

    _kernels.reset_launch_counts()

    def labor(graph, dev):
        dp = gb.ItemSampler(train, PRODUCTS_BATCH, shuffle=True, seed=0)
        dp = gb.LayerNeighborSampler(dp, graph, PRODUCTS_FANOUTS, seed=0)
        mb = next(iter(dp))
        return [mb.input_nodes, mb.blocks]

    labor_out = both("LayerNeighborSampler first batch", labor)
    same_result(*labor_out, "LayerNeighborSampler card vs CPU")
    blocks = labor_out[0][1]
    timings["LayerNeighborSampler first batch"].update(
        frontier_nodes=[b.num_src_nodes() for b in blocks],
        block_edges=[b.num_edges() for b in blocks])
    del labor_out, blocks

    fused = both("from_dglgraph", lambda graph, dev: gb.from_dglgraph(graph))
    for f in ("csc_indptr", "indices", "_eids"):
        if not np.array_equal(getattr(fused[0], f), getattr(fused[1], f)):
            raise RuntimeError(f"from_dglgraph's {f}, card vs CPU")
    seeds = np.random.default_rng(2).permutation(pg["train"])[
        :PRODUCTS_BATCH]

    def fused_of(dev):
        return fused[0] if dev == device else fused[1]

    def per_layer(graph, dev):
        dp = gb.ItemSampler(gb.ItemSet(seeds, names="seeds"), PRODUCTS_BATCH)
        for fanout in PRODUCTS_FANOUTS:
            dp = gb.CompactPerLayer(gb.SamplePerLayer(
                dp, fused_of(dev), fanout, seed=0))
        mb = next(iter(dp))
        return mb.sampled_subgraphs, mb.to_dgl_blocks(device=dev)

    name = "SamplePerLayer + CompactPerLayer x3, to_dgl_blocks"
    (subs, blocks), (subs_c, blocks_c) = both(name, per_layer)
    for i, (a, b) in enumerate(zip(subs, subs_c)):
        same_result([a.sampled_csc.indptr, a.sampled_csc.indices,
                      a.original_row_node_ids, a.original_column_node_ids,
                      a.original_edge_ids],
                     [b.sampled_csc.indptr, b.sampled_csc.indices,
                      b.original_row_node_ids, b.original_column_node_ids,
                      b.original_edge_ids], f"sampled layer {i}")
    same_result(blocks, blocks_c, "to_dgl_blocks card vs CPU")
    timings[name].update(
        rows=[len(s.original_row_node_ids) for s in subs],
        edges=[s.num_sampled_edges() for s in subs])
    ins = both("in_subgraph", lambda graph, dev: fused_of(dev).in_subgraph(
        seeds))
    same_result([ins[0].sampled_csc.indptr, ins[0].sampled_csc.indices,
                 ins[0].original_edge_ids],
                [ins[1].sampled_csc.indptr, ins[1].sampled_csc.indices,
                 ins[1].original_edge_ids], "in_subgraph card vs CPU")
    timings["in_subgraph"]["edges"] = ins[0].num_sampled_edges()
    del fused, subs, subs_c, blocks, blocks_c, ins

    # the small cases: the graph cache stages, the feature caches on the
    # card and on the CPU, all_to_all at world size 1
    fg = gb.from_dglgraph(g_cpu.subgraph(np.arange(20_000)))
    cache = gb.GPUGraphCache(capacity=4_000)

    def insub_batches(stage):
        return list(stage(gb.ItemSampler(gb.ItemSet(np.arange(4_000)),
                                         1_000)))

    for _ in range(2):
        cached = insub_batches(lambda dp: gb.CombineCachedAndFetchedInSubgraph(
            gb.FetchCachedInsubgraphData(dp, fg, cache), fg, cache))
    direct = insub_batches(lambda dp: gb.FetchInsubgraphData(dp, fg))
    for a, b in zip(cached, direct):
        sa, sb = a.sampled_subgraphs[0], b.sampled_subgraphs[0]
        same_result([sa.sampled_csc.indptr, sa.sampled_csc.indices,
                     sa.original_edge_ids],
                    [sb.sampled_csc.indptr, sb.sampled_csc.indices,
                     sb.original_edge_ids], "graph cache vs direct fetch")
    rng = np.random.default_rng(3)
    table = rng.normal(size=(50_000, PRODUCTS_FEAT)).astype(np.float32)
    ids = rng.integers(0, 50_000, 20_000)
    base = gb.NumpyFeature(table)
    want = torch.from_numpy(table[ids])
    for what, make in (
            ("cpu_cached_feature", lambda dev: gb.cpu_cached_feature(
                base, 400 * 5_000)),
            ("gpu_cached_feature", lambda dev: gb.gpu_cached_feature(
                base, 400 * 5_000, device=dev)),
            ("HBMFeatureCache", lambda dev: gb.HBMFeatureCache(
                base, np.arange(0, 50_000, 7), device=dev))):
        outs = []
        for dev in (device, "cpu"):
            feat = make(dev)
            t0 = time.perf_counter()
            outs.append(torch.as_tensor(feat.read(ids)))
            _sync(dev)
            timings.setdefault(what, {})[
                "card_s" if dev == device else "cpu_s"] = (
                time.perf_counter() - t0)
        if not all(torch.equal(o.cpu(), want) for o in outs):
            raise RuntimeError(f"{what}: rows differ from the table's")
        if (what != "cpu_cached_feature"
                and outs[0].device.type != torch.device(device).type):
            raise RuntimeError(f"{what}: the rows are not on the card")
    outs = [np.zeros(3, np.int64), torch.zeros(3, dtype=torch.int64)]
    gb.all_to_all(outs, [np.arange(3), torch.arange(3, 6)])
    if outs[0].tolist() != [0, 1, 2] or outs[1].tolist() != [3, 4, 5]:
        raise RuntimeError(f"all_to_all at world size 1: {outs}")
    launches = dict(_kernels.launch_counts)
    expect_no_other_launch(launches, {}, "the GraphBolt samplers")
    res = {"timings": timings, "graph_cache_hit_rate": cache.hit_rate,
           "launches": launches, "check": "card equal to CPU, exactly",
           "phase_s": time.perf_counter() - t_phase}
    emit({"phase": "graphbolt_layer_and_fused_csc", **res, **tag})
    return res


def run_graphbolt_device(data, e2e: dict, tag: dict, device="cuda") -> dict:
    """Phase graphbolt_device: the on-device backend through the stages,
    on ``minibatch_data``'s zipf graph: ``ItemSampler`` (512, shuffled) ->
    ``DeviceNeighborSamplerStage([10, 10])`` -> ``DeviceFeatureFetcher``
    -> ``DeviceSAGE`` 100-256-47, Adam at 1e-3, ``GB_DEVICE_STEPS`` steps
    after a warm one through ``gb.DataLoader``; the first batch's picks
    checked (``check_device_picks``), its features the table's rows; the
    losses finite and falling. ``ms_per_step`` beside
    ``sage_minibatch_end_to_end``'s (``e2e``: the same work without the
    stages)."""
    import numpy as np
    import torch

    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch import graphbolt as gb
    from dgl_tpu_torch.models import DeviceSAGE

    t_phase = time.perf_counter()
    g, feats, labels = data
    sampler = gb.DeviceNeighborSamplerStage(
        gb.ItemSampler(gb.ItemSet(np.arange(N_NODES), names="seeds"),
                       MB_BATCH, shuffle=True, seed=0, drop_last=True),
        g, MB_FANOUTS, seed=0, device=device)
    dp = gb.DeviceFeatureFetcher(sampler, {"feat": feats}, device=device)
    model = DeviceSAGE(MB_FEAT, MB_HIDDEN, MB_CLASSES, num_layers=2,
                       generator=torch.Generator().manual_seed(0),
                       device=device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loader = iter(gb.DataLoader(dp))

    def step(mb):
        logits = model(mb.device_mfg, mb.node_features["feat"])
        loss = torch.nn.functional.cross_entropy(
            logits, labels.index_select(0, mb.device_mfg.frontiers[0]))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    first = next(loader)
    masked = check_device_picks(first.device_mfg, sampler.indptr,
                                sampler.indices, MB_FANOUTS)
    if not torch.equal(first.node_features["feat"], feats.index_select(
            0, first.device_mfg.input_nodes())):
        raise RuntimeError("DeviceFeatureFetcher's rows differ")
    losses = [step(first)]
    _sync(device)
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(GB_DEVICE_STEPS):
        losses.append(step(next(loader)))
    _sync(device)
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    expect_no_other_launch(launches, {}, "the GraphBolt device backend")
    losses = [v.item() for v in losses]
    if not (all(map(math.isfinite, losses))
            and np.mean(losses[-5:]) < np.mean(losses[:5])):
        raise RuntimeError(f"GraphBolt device losses: {losses}")
    res = {"pipeline": "ItemSampler(512) -> DeviceNeighborSamplerStage("
                       "[10, 10]) -> DeviceFeatureFetcher -> DeviceSAGE "
                       "100-256-47, Adam 1e-3, through gb.DataLoader",
           "steps": GB_DEVICE_STEPS,
           "ms_per_step": wall / GB_DEVICE_STEPS * 1e3,
           "sage_minibatch_end_to_end_ms_per_step": e2e["ms_per_step"],
           "masked_seeds": masked,
           "frontiers": [int(f.shape[0])
                         for f in first.device_mfg.frontiers],
           "losses": losses, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    emit({"phase": "graphbolt_device", **res, **tag})
    return res


# ---------------------------------------------------------------------------
# the multilevel partitioner: Cluster-GCN and the partition utilities
# ---------------------------------------------------------------------------

# examples/pytorch/cluster_gcn/cluster_gcn.py on ogbn-products: 1,000 parts
# of about 2,449 nodes, 100 parts a batch. On the arxiv zipf graph: 70
# parts (about 2,419 nodes each) and 7 a batch, a tenth of the graph.
CLUSTER_PARTS, CLUSTER_BATCH = 70, 7
CLUSTER_LR, CLUSTER_WD = 1e-3, 5e-4  # the recipe's Adam


def cluster_loss(model, sg, pattern=None):
    """cluster_gcn.py's loss: cross-entropy over the subgraph's training
    nodes, the ReLUs recorded (or following ``pattern``)."""
    import torch.nn.functional as F

    with relu_pattern(pattern) as seen:
        logits = model(sg, sg.ndata["feat"])
        m = sg.ndata["train_mask"]
        loss = F.cross_entropy(logits[m], sg.ndata["label"][m])
    return loss, seen


def cluster_graph(device, seed: int = 47):
    """The arxiv zipf graph with 128-wide features, 40 classes and a 60 %
    training mask, drawn from ``seed``."""
    import numpy as np

    import dgl_tpu_torch as dt

    src, dst = zipf_graph(0)
    n = N_NODES
    g = dt.graph((src, dst), num_nodes=n, device=device)
    rng = np.random.default_rng(seed)
    g.ndata["feat"] = _on(rng.standard_normal((n, IN_FEATS),
                                              dtype=np.float32), device)
    g.ndata["label"] = _on(rng.integers(0, CLASSES, n), device)
    g.ndata["train_mask"] = _on(rng.random(n) < 0.6, device)
    return g


def run_cluster_gcn(tag: dict, device="cuda") -> dict:
    """Phase cluster_gcn: DGL's Cluster-GCN recipe, GraphSAGE 128-256-256-40
    (mean, dropout 0.5) over ``ClusterGCNSampler``'s subgraphs through the
    ``DataLoader`` (``CLUSTER_PARTS`` parts, ``CLUSTER_BATCH`` a batch,
    shuffled), Adam at 1e-3 with weight decay 5e-4, one epoch. The
    assignment against the CPU graph's, the first batch against the CPU's,
    the first step against the CPU at 1e-4; induced subgraphs carry no
    plan, so every kernel count stays 0."""
    import numpy as np
    import torch

    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.dataloading import ClusterGCNSampler, DataLoader
    from dgl_tpu_torch.distributed import (edge_cut,
                                           metis_partition_assignment)
    from dgl_tpu_torch.models import GraphSAGE

    t_phase = time.perf_counter()
    g = cluster_graph(device)
    g_cpu = g.to("cpu")
    setup_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    sampler = ClusterGCNSampler(g, CLUSTER_PARTS)
    partition_s = time.perf_counter() - t0
    parts = np.empty(g.num_nodes(), np.int64)
    for p, ids in enumerate(sampler.part_nodes):
        parts[ids] = p
    t0 = time.perf_counter()
    cpu_parts = metis_partition_assignment(g_cpu, CLUSTER_PARTS)
    cpu_partition_s = time.perf_counter() - t0
    if not np.array_equal(parts, cpu_parts):
        raise RuntimeError("the assignment of the card's graph differs from "
                           "the CPU copy's")
    sizes = np.bincount(parts, minlength=CLUSTER_PARTS)
    cut = edge_cut(g, parts)
    ids = np.arange(CLUSTER_PARTS)
    it, sample_s = first_batches(lambda: sampler, g, g_cpu, ids,
                                 CLUSTER_BATCH, device)

    def make_model(dev):
        return GraphSAGE(IN_FEATS, HIDDEN, CLASSES, num_layers=LAYERS,
                         generator=torch.Generator().manual_seed(0),
                         device=dev)

    model = make_model(device)
    first = next(it)
    check = step_vs_cpu(model, lambda: make_model("cpu"), cluster_loss,
                        first)
    opt = torch.optim.Adam(model.parameters(), lr=CLUSTER_LR,
                           weight_decay=CLUSTER_WD)
    # the main path: the epoch's batches (the first already taken) with the
    # launch counts read around them
    _sync(device)
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    losses, step_s, nodes, edges = [], [], [], []
    t0 = time.perf_counter()
    for sg in itertools.chain([first], it):
        t1 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = cluster_loss(model, sg)[0]
        loss.backward()
        opt.step()
        _sync(device)
        step_s.append(time.perf_counter() - t1)
        losses.append(loss.item())
        nodes.append(sg.num_nodes())
        edges.append(sg.num_edges())
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    expect_no_other_launch(launches, {}, "the Cluster-GCN epoch")
    if len(losses) != -(-CLUSTER_PARTS // CLUSTER_BATCH) or not all(
            map(math.isfinite, losses)):
        raise RuntimeError(f"Cluster-GCN epoch losses: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    # an epoch as a training loop runs it, from a fresh loader whose thread
    # starts with the epoch (the counted one's had batches buffered during
    # the first step's check): ms_per_step
    loader = DataLoader(g, ids, sampler, batch_size=CLUSTER_BATCH,
                        shuffle=True, seed=1, device=device)
    _sync(device)
    t0 = time.perf_counter()
    epoch_edges = 0
    for steps, sg in enumerate(loader, 1):
        opt.zero_grad(set_to_none=True)
        cluster_loss(model, sg)[0].backward()
        opt.step()
        epoch_edges += sg.num_edges()
    _sync(device)
    epoch_s = time.perf_counter() - t0
    prof = profiled_steps(model, opt, cluster_loss, iter(DataLoader(
        g, ids, sampler, batch_size=CLUSTER_BATCH, shuffle=True, seed=2,
        device=device)))
    res = {"nodes": g.num_nodes(), "edges": g.num_edges(),
           "parts": CLUSTER_PARTS, "batch_parts": CLUSTER_BATCH,
           "setup_s": setup_s, "partition_s": partition_s,
           "cpu_partition_s": cpu_partition_s, "edge_cut": cut,
           "edge_cut_share": cut / g.num_edges(),
           "part_nodes_min_max_mean": [int(sizes.min()), int(sizes.max()),
                                       float(sizes.mean())],
           "batch_nodes": nodes, "batch_edges": edges,
           "first_sample_ms": sample_s[0] * 1e3,
           "sample_ms": float(np.mean(sample_s[1:])) * 1e3,
           "step_ms": float(np.mean(step_s)) * 1e3,
           "counted_ms_per_step": wall / len(losses) * 1e3,
           "epoch_s": epoch_s, "ms_per_step": epoch_s / steps * 1e3,
           "edges_per_s": epoch_edges / epoch_s, "losses": losses,
           "launches": launches, "peak_memory_gib": peak,
           "first_step_vs_cpu": check,
           "tolerance": "assignment and first batch exact; first step "
                        "rtol=1e-4, atol=1e-4*max|ref| (the CPU on the card "
                        "pass's ReLU pattern)",
           **{f"profile_{k}": v for k, v in prof.items()},
           "phase_s": time.perf_counter() - t_phase}
    emit({"phase": "cluster_gcn", **res, **tag})
    return res


def partition_files(m, g, what: str, hetero: bool = False):
    """``partition_graph`` (or ``partition_hetero_graph``) of ``g`` into 4
    parts in a fresh directory under ``build/``, read back: the book, the
    assignment and each part on ``g``'s device."""
    import shutil
    import tempfile

    import numpy as np

    base = os.path.join(ROOT, "build")
    os.makedirs(base, exist_ok=True)
    out = tempfile.mkdtemp(prefix=f"partition_{what}_", dir=base)
    try:
        D = m.distributed
        if hetero:
            assign = D.partition_hetero_graph(g, "h", 4, out)
            graphs = [m.data.load_graphs(os.path.join(out, f"part{p}.npz"),
                                         device=g.device)[0][0]
                      for p in range(4)]
            with open(os.path.join(out, "h.json")) as f:
                return assign, graphs, json.load(f)
        mapping = D.partition_graph(g, "g", 4, out, num_hops=1,
                                    return_mapping=True)
        graphs = [D.load_partition(out, p, device=g.device)[0]
                  for p in range(4)]
        book = D.load_partition_book(out)
        return (mapping, graphs, D.load_assignment(out), book.meta,
                book.nid2partid(np.arange(g.num_nodes())))
    finally:
        shutil.rmtree(out, ignore_errors=True)


def run_partition_utilities(tag: dict, device="cuda") -> dict:
    """Phase partition_utilities: the partition files, halo partitions and
    METIS orders on ``rand_graph(2000, 10000)``, and the heterograph
    partitions on the mag recipe at 1/2000 of its counts; each card result
    equal to the CPU's, timed on both."""
    import numpy as np

    import dgl_tpu_torch as dt

    t_phase = time.perf_counter()
    g = dt.rand_graph(SMALL_GRAPH_NODES, SMALL_GRAPH_EDGES, seed=16,
                      device=device)
    g.ndata["x"] = torch_like(np.random.default_rng(17).standard_normal(
        (SMALL_GRAPH_NODES, 8), dtype=np.float32), g)
    mag = mag_graph(div=2000, seed=18)
    hg = dt.heterograph(mag["data"], mag["nodes"], device=device)
    cases = {
        "metis_partition_assignment k=8": lambda m, x:
            m.metis_partition_assignment(x, 8),
        "metis_partition_assignment k=8 balance_edges": lambda m, x:
            m.metis_partition_assignment(x, 8, balance_edges=True),
        "partition_graph + load_partition/assignment/book": lambda m, x:
            partition_files(m, x, "homo"),
        "metis_partition k=4 extra_cached_hops=1 reshuffle": lambda m, x:
            m.metis_partition(x, 4, extra_cached_hops=1, reshuffle=True),
        "reorder_graph metis k=8": lambda m, x: m.reorder_graph(
            x, "metis", permute_config={"k": 8}),
        "metis_perm k=8": lambda m, x: m.metis_perm(x, 8),
    }
    hetero = {
        "hetero_partition_assignment k=4": lambda m, x:
            m.distributed.hetero_partition_assignment(x, 4),
        "partition_hetero_graph + load_graphs": lambda m, x:
            partition_files(m, x, "hetero", hetero=True),
    }
    timings = {}
    timed_pair(cases, g, g.to("cpu"), timings,
               graph=f"rand_graph({SMALL_GRAPH_NODES}, {SMALL_GRAPH_EDGES})")
    timed_pair(hetero, hg, hg.to("cpu"), timings,
               graph="mag_graph(div=2000)")
    emit({"phase": "partition_utilities", "cases": timings,
          "tolerance": "every result exact, card against CPU",
          "phase_s": time.perf_counter() - t_phase, **tag})
    return timings


# ---------------------------------------------------------------------------
# the explainers: GNNExplainer, HeteroGNNExplainer, PGExplainer, SubgraphX
# ---------------------------------------------------------------------------

EXPLAIN_EPOCHS = 100  # GNNExplainer's default
# B1w launches an explain_graph epoch over the weighted GCN: forward,
# EdgeWeightNorm's degree sum and one a layer; backward, one a layer (the
# masked input needs its gradient; the mask's gradient is gathers)
EXPLAIN_EPOCH_LAUNCHES = (LAYERS + 1) + LAYERS
EXPLAIN_NODE_HOPS = 3
EXPLAIN_RGCN_HOPS = 2
PG_EPOCHS = 20  # PGExplainer's default
SMALL_HETERO = {("author", "writes", "paper"): (60, 40, 150),
                ("paper", "cites", "paper"): (40, 40, 120),
                ("paper", "written_by", "author"): (40, 60, 150)}
SMALL_HETERO_HIDDEN = 64


def explain_gcn_fn(model):
    """The weighted GCN of ``weighted_gcn`` (eval mode) as an explainer's
    ``model_fn(graph, feat, eweight)``: ``EdgeWeightNorm("both")`` of the
    edge weights, then the layers with ReLU between them."""
    import torch

    from dgl_tpu_torch.nn import EdgeWeightNorm

    norm = EdgeWeightNorm("both")

    def model_fn(graph, feat, eweight):
        w = norm(graph, eweight)
        h = feat
        for i, conv in enumerate(model.convs):
            h = conv(graph, h, edge_weight=w)
            if i != len(model.convs) - 1:
                h = torch.relu(h)
        return h

    return model_fn


def run_explain_gcn(gp, g, x, tag: dict) -> dict:
    """Phase explain_gcn: GNNExplainer over the weighted GCN 128-256-256-40
    on the arxiv zipf graph plus self-loops. ``explain_graph`` over the
    weighted shell plan (``gp``; B1w launches counted, the first epoch's
    loss and mask gradients against the graph without plans ``g`` at the
    plan bound, 100 epochs timed); ``explain_node`` on the node with the
    most in-edges (``num_hops=3``) of ``g`` against its CPU copy at 1e-4: the subgraph
    carries no plan, and ``g``'s edge frames are the CPU copy's, where
    ``gp``'s hold weights normalised over its plan."""
    import numpy as np
    import torch

    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.nn.explain import GNNExplainer

    t_phase = time.perf_counter()
    dims = (IN_FEATS, HIDDEN, HIDDEN, CLASSES)
    model = weighted_gcn(dims, 0.0, 0).cuda().eval()
    fn = explain_gcn_fn(model)
    ex = GNNExplainer(fn, num_hops=LAYERS, num_epochs=EXPLAIN_EPOCHS)

    # the first epoch on both graphs: the same masks (the seed's), the
    # planned pass's targets, the exact pass on the planned ReLU pattern
    target = ex._target(gp, x)

    def first_epoch(graph, pattern=None):
        masks = ex._init_masks(graph, x)
        for m in masks:
            m.requires_grad_(True)
        with relu_pattern(pattern) as seen:
            loss = ex._loss(masks, graph, x, target)
        loss.backward()
        return {"loss": loss.detach(), "edge_mask_grad": masks[0].grad,
                "feat_mask_grad": masks[1].grad}, seen

    got, seen = first_epoch(gp)
    want, _ = first_epoch(g, seen)
    first = held(got, want, 2e-2, "GNNExplainer's first epoch, plan vs "
                 "exact f32 path")

    # the main path: explain_graph, launches counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    feat_mask, edge_mask = ex.explain_graph(gp, x)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    expected = (LAYERS + 1) + EXPLAIN_EPOCHS * EXPLAIN_EPOCH_LAUNCHES
    expect_no_other_launch(launches, {"shell_prefix_gspmm": expected},
                           "GNNExplainer.explain_graph")
    for name, m in (("feature", feat_mask), ("edge", edge_mask)):
        if not (torch.isfinite(m).all() and m.min() >= 0 and m.max() <= 1):
            raise RuntimeError(f"explain_graph's {name} mask leaves [0, 1]")

    # explain_node on the node with the most in-edges (the side that
    # khop_in_subgraph expands), against the CPU
    _, dst = g._relation().host_edges()
    hub = int(np.argmax(np.bincount(dst, minlength=g.num_nodes())))
    model_cpu = weighted_gcn(dims, 0.0, 0).cpu().eval()
    model_cpu.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    nid, sg, fm, em = GNNExplainer(
        fn, EXPLAIN_NODE_HOPS, num_epochs=EXPLAIN_EPOCHS).explain_node(
        hub, g, x)
    torch.cuda.synchronize()
    node_card_s = time.perf_counter() - t0
    node_launches = dict(_kernels.launch_counts)
    expect_no_other_launch(node_launches, {}, "GNNExplainer.explain_node")
    g_cpu, x_cpu = g.to("cpu"), x.cpu()
    t0 = time.perf_counter()
    nid_c, sg_c, fm_c, em_c = GNNExplainer(
        explain_gcn_fn(model_cpu), EXPLAIN_NODE_HOPS,
        num_epochs=EXPLAIN_EPOCHS).explain_node(hub, g_cpu, x_cpu)
    node_cpu_s = time.perf_counter() - t0
    if nid != nid_c:
        raise RuntimeError(f"explain_node's node id {nid} vs {nid_c}")
    same_graph_on(sg, sg_c, "explain_node's subgraph, card vs CPU")
    node_check = held({"feat_mask": fm, "edge_mask": em},
                      {"feat_mask": fm_c, "edge_mask": em_c}, 1e-4,
                      "explain_node's masks, card vs CPU")
    res = {"model": "EdgeWeightNorm('both') + GraphConv(norm='none') "
                    "128-256-256-40, eval", "epochs": EXPLAIN_EPOCHS,
           "explain_graph_launches": launches,
           "expected_shell_prefix_gspmm": expected,
           "launches_per_epoch": (launches.get("shell_prefix_gspmm", 0)
                                  - (LAYERS + 1)) / EXPLAIN_EPOCHS,
           "explain_graph_s": graph_s,
           "ms_per_epoch": graph_s / EXPLAIN_EPOCHS * 1e3,
           "explain_graph_peak_memory_gib": peak,
           "first_epoch_vs_exact_f32": first,
           "first_epoch_tolerance": "rtol=2e-2, atol=2e-2*max|ref| (the "
                                    "exact pass on the plan's ReLU pattern)",
           "hub": hub, "node_subgraph": [sg.num_nodes(), sg.num_edges()],
           "explain_node_launches": node_launches,
           "explain_node_card_s": node_card_s,
           "explain_node_cpu_s": node_cpu_s,
           "explain_node_vs_cpu": node_check,
           "explain_node_tolerance": "rtol=1e-4, atol=1e-4*max|ref|",
           "phase_s": time.perf_counter() - t_phase}
    emit({"phase": "explain_gcn", **res, **tag})
    return res


def rgcn_explain_fn(model):
    """``hetero_rgcn``'s R-GCN as ``model_fn(graph, feat, eweight)``: each
    relation's edge weights through ``mod_kwargs`` as its GraphConv's
    ``edge_weight``; the paper logits."""
    import torch

    def model_fn(graph, feat, eweight):
        kw = {c[1]: {"edge_weight": eweight[c]}
              for c in graph.canonical_etypes}
        h = {k: torch.relu(v) for k, v in model.layer0(
            graph, feat, mod_kwargs=kw).items()}
        return model.layer1(graph, h, mod_kwargs=kw)["paper"]

    return model_fn


def run_explain_rgcn(g, x, tag: dict) -> dict:
    """Phase explain_rgcn: HeteroGNNExplainer on ``hetero_rgcn``'s R-GCN
    128-64-349 over ogbn-mag's counts, ``explain_node("paper", ...)`` on
    the most cited paper with ``num_hops=2`` (100 epochs), against the
    same explainer on the graph's CPU copy at 1e-4."""
    import numpy as np
    import torch

    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.nn.explain import HeteroGNNExplainer

    t_phase = time.perf_counter()
    dims = (MAG_FEAT, MAG_HIDDEN, MAG_CLASSES)
    model = hetero_rgcn(g.etypes, dims, 0).cuda().eval()
    _, cited = g._relations[("paper", "cites", "paper")].host_edges()
    paper = int(np.argmax(np.bincount(cited, minlength=g.num_nodes(
        "paper"))))
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    nid, sg, fm, em = HeteroGNNExplainer(
        rgcn_explain_fn(model), EXPLAIN_RGCN_HOPS,
        num_epochs=EXPLAIN_EPOCHS).explain_node("paper", paper, g, x)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    expect_no_other_launch(launches, {}, "HeteroGNNExplainer.explain_node")
    model_cpu = hetero_rgcn(g.etypes, dims, 0).cpu().eval()
    model_cpu.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    g_cpu = g.to("cpu")
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nid_c, sg_c, fm_c, em_c = HeteroGNNExplainer(
        rgcn_explain_fn(model_cpu), EXPLAIN_RGCN_HOPS,
        num_epochs=EXPLAIN_EPOCHS).explain_node(
        "paper", paper, g_cpu, {k: v.cpu() for k, v in x.items()})
    cpu_s = time.perf_counter() - t0
    if nid != nid_c:
        raise RuntimeError(f"explain_node's node id {nid} vs {nid_c}")
    same_graph_on(sg, sg_c, "the R-GCN explainer's subgraph, card vs CPU")
    if set(fm) != set(fm_c) or set(em) != set(em_c):
        raise RuntimeError("the R-GCN explainer's mask types differ")
    got = {f"feat_mask {k}": v for k, v in fm.items()}
    want = {f"feat_mask {k}": v for k, v in fm_c.items()}
    for k, v in em.items():
        if v.numel():
            got[f"edge_mask {k[1]}"], want[f"edge_mask {k[1]}"] = v, em_c[k]
    for name, m in got.items():
        if not (torch.isfinite(m).all() and m.min() >= 0 and m.max() <= 1):
            raise RuntimeError(f"the R-GCN explainer's {name} leaves [0, 1]")
    check = held(got, want, 1e-4, "the R-GCN explainer, card vs CPU")
    res = {"model": "HeteroGraphConv(GraphConv) R-GCN 128-64-349, eval",
           "paper": paper, "epochs": EXPLAIN_EPOCHS,
           "subgraph_nodes": dict(sg._num_src_nodes),
           "subgraph_edges": {c[1]: sg.num_edges(c)
                              for c in sg.canonical_etypes},
           "launches": launches, "card_s": card_s, "cpu_s": cpu_s,
           "cpu_copy_s": copy_s, "vs_cpu": check,
           "tolerance": "rtol=1e-4, atol=1e-4*max|ref|",
           "phase_s": time.perf_counter() - t_phase}
    emit({"phase": "explain_rgcn", **res, **tag})
    return res


def gin_explain_model(device, seed: int = 0):
    """``gin_model``'s GIN (five GINConv sum layers, 300-300 MLPs,
    ``mean_nodes``) with a two-logit head, passing edge weights to every
    layer: ``forward(g, h, eweight=None)`` returns the (graphs, 2) logits
    and the last layer's node embeddings. Weights drawn after
    ``torch.manual_seed(seed)``."""
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch.nn import GINConv

    class GIN(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.convs = torch.nn.ModuleList(
                GINConv(torch.nn.Sequential(
                    torch.nn.Linear(GIN_DIM, GIN_DIM), torch.nn.ReLU(),
                    torch.nn.Linear(GIN_DIM, GIN_DIM)), "sum", device=device)
                for _ in range(GIN_LAYERS))
            self.out = torch.nn.Linear(GIN_DIM, 2)

        def forward(self, g, h, eweight=None):
            for i, conv in enumerate(self.convs):
                h = conv(g, h, edge_weight=eweight)
                if i != len(self.convs) - 1:
                    h = torch.relu(h)
            with g.local_scope():
                g.ndata["h"] = h
                return self.out(dt.mean_nodes(g, "h")), h

    torch.manual_seed(seed)
    return GIN().to(device).eval()


def small_hetero_model(device, seed: int = 0):
    """``hetero_rgcn``'s two HeteroGraphConv layers over ``SMALL_HETERO``'s
    relations, 16 -> 64 -> 2, as the hetero explainers' models: the
    paper logits' mean as (1, 2), and for PGExplainer the hidden layer."""
    etypes = [c[1] for c in SMALL_HETERO]
    return hetero_rgcn(etypes, (16, SMALL_HETERO_HIDDEN, 2),
                       seed).to(device).eval()


def small_hetero_fns(model):
    import torch

    def pg_fn(graph, feat, eweight):
        kw = {c[1]: {"edge_weight": eweight[c]}
              for c in graph.canonical_etypes}
        h = {k: torch.relu(v) for k, v in model.layer0(
            graph, feat, mod_kwargs=kw).items()}
        out = model.layer1(graph, h, mod_kwargs=kw)["paper"]
        return out.mean(0, keepdim=True), h

    def sx_fn(graph, feat):
        return model(graph, feat).mean(0, keepdim=True)

    return pg_fn, sx_fn


def small_hetero(device, seed: int = 19):
    import numpy as np

    import dgl_tpu_torch as dt

    rng = np.random.default_rng(seed)
    data = {c: (rng.integers(0, ns, e), rng.integers(0, nd, e))
            for c, (ns, nd, e) in SMALL_HETERO.items()}
    nodes = {"author": 60, "paper": 40}
    hg = dt.heterograph(data, nodes, device=device)
    feat = {nt: _on(rng.standard_normal((n, 16), dtype=np.float32), device)
            for nt, n in nodes.items()}
    return hg, feat


def run_explain_gin(tag: dict, device="cuda") -> dict:
    """Phase explain_gin: PGExplainer (20 epochs, then ``explain_graph``)
    over OGB's molhiv GIN with a two-logit head on a batch of 32 random
    molhiv-sized graphs, and SubgraphX (its defaults) on one of them; the
    heterogeneous explainers on a small random heterograph. Each against
    the same explainer on the CPU: PGExplainer's loss, MLP, probabilities
    and masks at 1e-4 (the noise is the seed's on both), SubgraphX's nodes
    exactly and its score at 1e-4."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.nn.explain import (HeteroPGExplainer,
                                          HeteroSubgraphX, PGExplainer,
                                          SubgraphX)

    t_phase = time.perf_counter()
    bg = dt.batch(molhiv_graphs(GIN_BATCH, 0, device))
    x = _on(np.random.default_rng(20).standard_normal(
        (bg.num_nodes(), GIN_DIM), dtype=np.float32), device)
    model = gin_explain_model(device)
    model_cpu = gin_explain_model("cpu")
    model_cpu.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    bg_cpu, x_cpu = bg.to("cpu"), x.cpu()
    timings, checks = {}, {}

    def both(name, run):
        """``run(model, graph, feat)`` on the card and on the CPU, timed,
        launches counted on the card (none: no plan)."""
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = run(model, bg, x)
        _sync(device)
        card_s = time.perf_counter() - t0
        expect_no_other_launch(dict(_kernels.launch_counts), {}, name)
        t0 = time.perf_counter()
        want = run(model_cpu, bg_cpu, x_cpu)
        timings[name] = {"card_s": card_s,
                         "cpu_s": time.perf_counter() - t0}
        return got, want

    def pg(m, graph, feat):
        ex = PGExplainer(lambda g, h, w: m(g, h, w), GIN_DIM,
                         epochs=PG_EPOCHS)
        loss = ex.train_step(graph, feat)
        probs, mask = ex.explain_graph(graph, feat)
        return {"loss": torch.tensor(loss), "probs": probs, "mask": mask,
                **{f"mlp {k}": v for k, v in ex.net.state_dict().items()}}

    got, want = both("PGExplainer train_step + explain_graph", pg)
    checks["PGExplainer"] = held(got, want, 1e-4, "PGExplainer, card vs CPU")
    mask = got["mask"]
    if not (mask.min() >= 0 and mask.max() <= 1):
        raise RuntimeError("PGExplainer's mask leaves [0, 1]")
    g1 = dt.unbatch(bg)[0]
    n1 = g1.num_nodes()

    def sx(m, graph, feat):
        one = g1 if graph is bg else g1.to("cpu")
        nodes, score = SubgraphX(lambda g, h: m(g, h)[0]).explain_graph(
            one, feat[:n1])
        return nodes, score

    (nodes, score), (nodes_c, score_c) = both("SubgraphX explain_graph", sx)
    if not np.array_equal(nodes, nodes_c):
        raise RuntimeError(f"SubgraphX's nodes {nodes} vs {nodes_c}")
    checks["SubgraphX"] = held({"score": torch.tensor(score)},
                               {"score": torch.tensor(score_c)}, 1e-4,
                               "SubgraphX's score, card vs CPU")

    # the heterogeneous explainers on a small heterograph
    hg, feat = small_hetero(device)
    hg_cpu = hg.to("cpu")
    feat_cpu = {k: v.cpu() for k, v in feat.items()}
    hm = small_hetero_model(device)
    hm_cpu = small_hetero_model("cpu")
    hm_cpu.load_state_dict({k: v.cpu() for k, v in hm.state_dict().items()})
    out = {}
    for where, m, graph, f in (("card", hm, hg, feat),
                               ("cpu", hm_cpu, hg_cpu, feat_cpu)):
        pg_fn, sx_fn = small_hetero_fns(m)
        t0 = time.perf_counter()
        ex = HeteroPGExplainer(pg_fn, SMALL_HETERO_HIDDEN, epochs=PG_EPOCHS)
        loss = ex.train_step(graph, f)
        probs, masks = ex.explain_graph(graph, f)
        res, hscore = HeteroSubgraphX(sx_fn).explain_graph(graph, f)
        _sync(device)
        out[where] = ({"loss": torch.tensor(loss), "probs": probs,
                       **{f"mask {c[1]}": v for c, v in masks.items()}},
                      res, hscore, time.perf_counter() - t0)
    checks["HeteroPGExplainer"] = held(out["card"][0], out["cpu"][0], 1e-4,
                                       "HeteroPGExplainer, card vs CPU")
    hres, hres_c = out["card"][1], out["cpu"][1]
    if set(hres) != set(hres_c) or any(
            not np.array_equal(hres[k], hres_c[k]) for k in hres):
        raise RuntimeError(f"HeteroSubgraphX's nodes {hres} vs {hres_c}")
    checks["HeteroSubgraphX"] = held(
        {"score": torch.tensor(out["card"][2])},
        {"score": torch.tensor(out["cpu"][2])}, 1e-4,
        "HeteroSubgraphX's score, card vs CPU")
    timings["hetero explainers"] = {"card_s": out["card"][3],
                                    "cpu_s": out["cpu"][3]}
    res = {"model": "GIN 5 x 300 (sum), mean_nodes, 2 logits, eval",
           "graphs": GIN_BATCH, "batch_nodes": bg.num_nodes(),
           "pg_epochs": PG_EPOCHS, "pg_loss": float(got["loss"]),
           "subgraphx_graph_nodes": n1, "subgraphx_nodes": nodes.tolist(),
           "subgraphx_score": score,
           "hetero_subgraphx_nodes": {k: v.tolist()
                                      for k, v in hres.items()},
           "timings": timings, "vs_cpu": checks,
           "tolerance": "rtol=1e-4, atol=1e-4*max|ref|; node sets exact",
           "phase_s": time.perf_counter() - t_phase}
    emit({"phase": "explain_gin", **res, **tag})
    return res


# ---------------------------------------------------------------------------
# the dataset zoo: the repo's recipes from their datasets
# ---------------------------------------------------------------------------

DATA_EPOCHS = 200  # examples/gcn_cora.py and gat_citeseer.py
DATA_GAT_BITMAP_EPOCHS = 30  # examples/fullgraph_gat_bitmap.py
DATA_REDDIT_STEPS = 30  # examples/reddit_fullgraph_gcn.py
DATA_OGB_STEPS = 120  # tests/test_real_train.py
DATA_GIN_EPOCHS = 10
DATA_GB_BATCH, DATA_GB_FANOUTS, DATA_GB_EPOCHS = 64, [10, 10], 20
DATA_TIMED = 10  # time_ms iterations (plus 2 warm-up calls)
# the reference's calibrated landing of each citation GCN
# (dgl_tpu/data/citation.py:38-50, benchmarks/calibrate_bow.py's recipe)
CITATION_LANDING = {"cora": 0.817, "citeseer": 0.693, "pubmed": 0.809}
# the floors the reference's own tests set (tests/test_end_to_end.py)
CORA_GCN_FLOOR, CORA_GAT_FLOOR = 0.6, 0.5


def same_dataset_on(a, b, what: str) -> None:
    """Two datasets (any devices) with equal items and equal public data
    attributes."""
    if len(a) != len(b):
        raise RuntimeError(f"{what}: {len(a)} vs {len(b)} items")
    for i in range(len(b)):
        same_result(a[i], b[i], f"{what}[{i}]")
    for k, v in vars(b).items():
        if not k.startswith("_") and k != "meta":
            same_result(getattr(a, k), v, f"{what}.{k}")


def write_csv_dataset(d: str, seed: int = 8) -> None:
    """A ``CSVDataset`` directory: 2,000 nodes in a shuffled order with a
    label, a 16-wide vector and a score, 20,000 weighted edges."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, e = 2000, 20000
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "nodes.csv"), "w") as f:
        f.write("node_id,label,feat,score\n")
        for i in rng.permutation(n):
            vec = ",".join(f"{v:.5f}" for v in rng.random(16))
            f.write(f'{i},{i % 5},"{vec}",{rng.random():.6f}\n')
    with open(os.path.join(d, "edges.csv"), "w") as f:
        f.write("src_id,dst_id,weight\n")
        for a, b in rng.integers(0, n, (e, 2)):
            f.write(f"{a},{b},{rng.random():.6f}\n")
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({"dataset_name": "csv_chip", "node_data": [
            {"file_name": "nodes.csv", "ntype": "_N"}], "edge_data": [
            {"file_name": "edges.csv", "etype": ["_N", "_E", "_N"]}]}, f)


def zoo_cases(zoo: dict, csv_dir: str) -> dict:
    """name -> fn(device): the phase's datasets, each in ``zoo[device]``,
    a fresh directory a device."""
    import dgl_tpu_torch.data as D

    def cora(dev):
        return D.CoraGraphDataset(raw_dir=zoo[dev], device=dev)

    return {
        "CoraGraphDataset": cora,
        "CiteseerGraphDataset": lambda dev: D.CiteseerGraphDataset(
            raw_dir=zoo[dev], device=dev),
        "PubmedGraphDataset": lambda dev: D.PubmedGraphDataset(
            raw_dir=zoo[dev], device=dev),
        "RedditDataset": lambda dev: D.RedditDataset(raw_dir=zoo[dev],
                                                     device=dev),
        "SyntheticDataset": lambda dev: D.SyntheticDataset(device=dev),
        "SyntheticHeteroDataset": lambda dev: D.SyntheticHeteroDataset(
            device=dev),
        "KnowledgeGraphDataset": lambda dev: D.KnowledgeGraphDataset(
            raw_dir=zoo[dev], device=dev),
        "MiniGCDataset": lambda dev: D.MiniGCDataset(320, 10, 20, seed=0,
                                                     device=dev),
        "KarateClubDataset": lambda dev: D.KarateClubDataset(device=dev),
        "BAShapeDataset": lambda dev: D.BAShapeDataset(device=dev),
        "MinesweeperDataset": lambda dev: D.MinesweeperDataset(
            raw_dir=zoo[dev], device=dev),
        "CSVDataset": lambda dev: D.CSVDataset(csv_dir, device=dev),
        "AsNodePredDataset(Cora)": lambda dev: D.AsNodePredDataset(
            cora(dev), split_ratio=(0.6, 0.2, 0.2)),
        "AsLinkPredDataset(Cora)": lambda dev: D.AsLinkPredDataset(
            cora(dev), seed=0),
    }


CACHED = ("CoraGraphDataset", "CiteseerGraphDataset", "PubmedGraphDataset")


def run_data_zoo(zoo: dict, tag: dict) -> dict:
    """Phase data_zoo: each dataset built on the card and on the CPU,
    timed and held exactly equal; the citation sets built once more from
    the cache the first build wrote, equal to the first. Returns the card
    and CPU datasets by name."""
    import torch

    csv_dir = os.path.join(zoo["cuda"], "csv")
    write_csv_dataset(csv_dir)
    built, timings = {}, {}
    for name, make in zoo_cases(zoo, csv_dir).items():
        t0 = time.perf_counter()
        card = make("cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = make("cpu")
        cpu_s = time.perf_counter() - t0
        first = card[0][0] if isinstance(card[0], tuple) else card[0]
        if first.device.type != "cuda":
            raise RuntimeError(f"{name} was built on {first.device}")
        same_dataset_on(card, cpu, f"{name}, card vs CPU")
        row = {"build_s": build_s, "cpu_build_s": cpu_s, "items": len(card)}
        if name in CACHED:
            t0 = time.perf_counter()
            again = make("cuda")
            torch.cuda.synchronize()
            row["cache_load_s"] = time.perf_counter() - t0
            same_dataset_on(again, card, f"{name} from its cache")
            g = card[0]
            row.update(nodes=g.num_nodes(), edges=g.num_edges(),
                       feat=int(g.ndata["feat"].shape[1]))
        built[name] = (card, cpu)
        timings[name] = row
    emit({"phase": "data_zoo", "datasets": timings,
          "check": "card dataset equal to the CPU's (graphs, frames, "
                   "splits, attributes, dtypes); the citation sets' cache "
                   "read back equal", **tag})
    return built


def graph_loss(model, batch, pattern=None):
    """A full-graph recipe's masked loss over ``(graph, x, y, mask)``, the
    ReLUs recorded (or following ``pattern``)."""
    graph, x, y, mask = batch
    with relu_pattern(pattern) as seen:
        loss = masked_loss(model(graph, x), y, mask)
    return loss, seen


def accuracy_floor(logits, y, test, floor: float, what: str) -> dict:
    """Test accuracy; fails below twice the test set's majority share or
    below ``floor``."""
    import torch

    yt = y[test]
    acc = (logits[test].argmax(-1) == yt).float().mean().item()
    majority = (torch.bincount(yt).max().item() / yt.numel())
    need = max(2 * majority, floor)
    if not acc >= need:
        raise RuntimeError(f"{what}: test accuracy {acc} below {need} "
                           f"(majority share {majority})")
    return {"test_accuracy": acc, "majority_share": majority,
            "floor": need}


def train_epochs(model, opt, graph, x, y, mask, epochs: int) -> list:
    """``epochs`` steps; the losses, which must be finite and fall."""
    import torch

    losses = torch.stack([train_step(model, opt, graph, x, y, mask)
                          for _ in range(epochs)]).tolist()
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise RuntimeError(f"training losses {losses[:3]} ... "
                           f"{losses[-3:]}")
    return losses


def counted_forward(model, graph, x, allowed: dict, what: str) -> dict:
    """One inference forward with the counts set to 0 just before and read
    just after; fails unless ``allowed`` launched as given, and nothing
    else."""
    import torch

    from dgl_tpu_torch import _kernels

    model.eval()
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        model(graph, x)
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    expect_no_other_launch(launches, allowed, what)
    model.train()
    return launches


def recipe_run(model, make_cpu, gp, gp_cpu, frames, frames_cpu, opt,
               epochs, tol, fwd_expect, step_expect, floor, what) -> dict:
    """A full-graph recipe: the counted forward, the first step against
    the CPU (the CPU pass on the card pass's ReLU pattern, at rtol =
    ``tol``, atol = ``tol`` * max|ref|), the counted step, ``forward_ms`` and ``step_ms`` (their steps
    counted among ``epochs``), the remaining epochs, the test accuracy."""
    import torch

    x, y, train, test = frames
    mask = train.float()
    xc, yc, trc, _ = frames_cpu
    fwd = counted_forward(model, gp, x, fwd_expect, f"{what}'s forward")
    vs_cpu = step_vs_cpu(model, make_cpu, graph_loss, (gp, x, y, mask), tol,
                         (gp_cpu, xc, yc, trc.float()))
    loss, step, peak, step_s = counted_step(model, opt, gp, x, y, mask,
                                            step_expect, what)
    expect_no_other_launch(step, step_expect, f"{what}'s step")
    step_ms = time_ms(lambda: train_step(model, opt, gp, x, y, mask),
                      DATA_TIMED)
    losses = [loss.item()] + train_epochs(model, opt, gp, x, y, mask,
                                          epochs - 3 - DATA_TIMED)
    model.eval()
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(gp, x), DATA_TIMED)
        logits = model(gp, x)
    model.train()
    return {"forward_launches": fwd, "step_launches": step,
            "first_step_vs_cpu": vs_cpu,
            "first_step_tolerance": f"rtol={tol:g}, atol={tol:g}*max|ref|",
            "forward_ms": fwd_ms,
            "step_ms": step_ms, "peak_memory_gib": peak,
            "first_step_s": step_s, "epochs": epochs,
            "losses": {"first": losses[0], "last": losses[-1]},
            **accuracy_floor(logits, y, test, floor, what)}


def node_frames(g):
    return tuple(g.ndata[k] for k in ("feat", "label", "train_mask",
                                      "test_mask"))


def plan_kernel(rel) -> tuple:
    """The g-SpMM route ``copy_u`` + sum takes on a relation: the bitmap
    (B2) before the hub plan (B1 on its cold shells)."""
    if rel.bitmap_plan is not None:
        return "bitmap", "bitmap_spmm"
    if rel.hub_plan is not None:
        return "hub", "shell_prefix_sum"
    return "none", None


def run_data_citation_gcn(built: dict, tag: dict) -> dict:
    """Phase data_citation_gcn: ``examples/gcn_cora.py``'s recipe on Cora,
    Citeseer and Pubmed."""
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch.models import GCN

    out = {}
    for name in CACHED:
        card, cpu = built[name]
        short = name[:-len("GraphDataset")].lower()
        t0 = time.perf_counter()
        g = dt.add_self_loop(dt.remove_self_loop(card[0]))
        gp = g.with_spmm_plans(weighted=True)
        torch.cuda.synchronize()
        plans_s = time.perf_counter() - t0
        g_cpu = dt.add_self_loop(dt.remove_self_loop(cpu[0]))
        same_graph_on(g, g_cpu, f"{short}: the recipe's graph")
        gp_cpu = g_cpu.with_spmm_plans(weighted=True)
        rel = gp._relation()
        plan, kernel = plan_kernel(rel)
        if plan_kernel(gp_cpu._relation())[0] != plan:
            raise RuntimeError(f"{short}: the CPU took another plan")
        fwd = {kernel: 2} if kernel else {}
        step = {kernel: 4} if kernel else {}
        feat = g.ndata["feat"]

        def make(dev, n_in=feat.shape[1], c=card.num_classes):
            return GCN(n_in, 16, c, generator=torch.Generator().manual_seed(
                0), device=dev)

        model = make("cuda")
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        res = recipe_run(model, lambda: make("cpu"), gp, gp_cpu,
                         node_frames(g), node_frames(g_cpu), opt,
                         DATA_EPOCHS, 2e-2, fwd, step,
                         CORA_GCN_FLOOR if short == "cora" else 0.0,
                         f"GCN on {short}")
        density = rel.num_edges / (rel.num_src * rel.num_dst)
        out[short] = {"plan": plan, "kernel": kernel, "density": density,
                      "nodes": g.num_nodes(), "edges": rel.num_edges,
                      "plans_s": plans_s,
                      "calibrated_landing": CITATION_LANDING[short], **res}
        emit({"phase": "data_citation_gcn", "dataset": short,
              "model": f"GCN {feat.shape[1]}-16-{card.num_classes}, "
                       "dropout 0.5, Adam 1e-2, add_self_loop("
                       "remove_self_loop(g)).with_spmm_plans(weighted=True)",
              **out[short], **tag})
        del model, opt, gp, gp_cpu
    return out


def bitmap_gat_model(in_feats, classes, device, heads=8, hidden=8):
    """``examples/fullgraph_gat_bitmap.py``'s GAT: GATConv in -> 8 x 8
    heads, ELU, GATConv -> classes (1 head), weights from seed 0."""
    import torch

    from dgl_tpu_torch.nn import GATConv

    class BitmapGAT(torch.nn.Module):
        def __init__(self):
            super().__init__()
            gen = torch.Generator().manual_seed(0)
            self.conv0 = GATConv(in_feats, hidden, heads,
                                 allow_zero_in_degree=True, generator=gen,
                                 device=device)
            self.conv1 = GATConv(heads * hidden, classes, 1,
                                 allow_zero_in_degree=True, generator=gen,
                                 device=device)

        def forward(self, g, x):
            h = self.conv0(g, x)
            h = torch.nn.functional.elu(h.reshape(h.shape[0], -1))
            h = self.conv1(g, h)
            return h.reshape(h.shape[0], -1)

    return BitmapGAT()


def run_data_gat(built: dict, tag: dict) -> dict:
    """Phase data_gat: ``examples/fullgraph_gat_bitmap.py`` on Cora with
    the bitmap plan forced (B3, B4, B5), and ``examples/gat_citeseer.py``
    (the dense route)."""
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch.models import GAT

    out = {}
    card, cpu = built["CoraGraphDataset"]
    t0 = time.perf_counter()
    g = dt.add_self_loop(dt.remove_self_loop(dt.to_simple(card[0])))
    # the example attaches with_spmm_plans(bitmap=True); at Cora's 7.3M
    # cells the dense mask attaches too and GATConv takes it first, so the
    # bitmap route is forced by leaving the dense mask out
    as_written = g.with_spmm_plans(bitmap=True)._relation().dense_adj
    gp = g.with_spmm_plans(bitmap=True, dense_attn=False)
    torch.cuda.synchronize()
    plans_s = time.perf_counter() - t0
    g_cpu = dt.add_self_loop(dt.remove_self_loop(dt.to_simple(cpu[0])))
    same_graph_on(g, g_cpu, "the bitmap GAT recipe's graph")
    gp_cpu = g_cpu.with_spmm_plans(bitmap=True, dense_attn=False)
    if gp._relation().bitmap_plan is None:
        raise RuntimeError("Cora's graph lacks its bitmap plan")
    feat = g.ndata["feat"]
    model = bitmap_gat_model(feat.shape[1], card.num_classes, "cuda")
    opt = torch.optim.AdamW(model.parameters(), lr=5e-3, weight_decay=5e-4)
    b3 = {"bitmap_gat_fwd": 2}
    res = recipe_run(
        model, lambda: bitmap_gat_model(feat.shape[1], card.num_classes,
                                        "cpu"),
        gp, gp_cpu, node_frames(g), node_frames(g_cpu), opt,
        DATA_GAT_BITMAP_EPOCHS, 2e-2, b3,
        {**b3, "bitmap_gat_bwd_dst": 2, "bitmap_gat_bwd_src": 2},
        CORA_GAT_FLOOR, "the bitmap GAT on Cora")
    out["bitmap_cora"] = {"route": "bitmap", "plans_s": plans_s,
                          "route_as_written": "dense" if as_written
                          is not None else "bitmap", **res}
    emit({"phase": "data_gat", "recipe": "examples/fullgraph_gat_bitmap.py "
          "on Cora: GATConv 1433-8x8, ELU, GATConv 64-7, AdamW 5e-3 (weight "
          "decay 5e-4), with_spmm_plans(bitmap=True, dense_attn=False)",
          **out["bitmap_cora"], **tag})
    del model, opt, gp, gp_cpu

    card, cpu = built["CiteseerGraphDataset"]
    g = dt.add_self_loop(dt.remove_self_loop(card[0]))
    gp = g.with_spmm_plans(weighted=True)
    g_cpu = dt.add_self_loop(dt.remove_self_loop(cpu[0]))
    gp_cpu = g_cpu.with_spmm_plans(weighted=True)
    rel = gp._relation()
    route = ("dense" if rel.dense_adj is not None else "bitmap"
             if rel.bitmap_plan is not None else "fused"
             if rel.shell_plan is not None else "per-edge")
    if route != "dense":
        raise RuntimeError(f"Citeseer's GAT took the {route} route")
    feat = g.ndata["feat"]

    def make(dev):
        return GAT(feat.shape[1], 8, card.num_classes, heads=8,
                   generator=torch.Generator().manual_seed(0), device=dev)

    model = make("cuda")
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    res = recipe_run(model, lambda: make("cpu"), gp, gp_cpu, node_frames(g),
                     node_frames(g_cpu), opt, DATA_EPOCHS, 2e-2, {}, {},
                     0.0, "GAT on Citeseer")
    out["citeseer"] = {"route": route, "cells": rel.num_src * rel.num_dst,
                       **res}
    emit({"phase": "data_gat", "recipe": "examples/gat_citeseer.py: GAT "
          f"{feat.shape[1]}-8x8-{card.num_classes}, dropouts 0.6, Adam 5e-3,"
          " with_spmm_plans(weighted=True)", **out["citeseer"], **tag})
    return out


def run_data_reddit_gcn(built: dict, tag: dict) -> dict:
    """Phase data_reddit_gcn: ``examples/reddit_fullgraph_gcn.py`` on
    ``RedditDataset()`` (B2 2 a forward, 4 a step)."""
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch.models import GCN

    card, cpu = built["RedditDataset"]
    t0 = time.perf_counter()
    g = dt.add_self_loop(dt.remove_self_loop(dt.to_simple(card[0])))
    kw = dict(num_hubs=256, bitmap=True, bitmap_max_bytes=8 << 30)
    gp = g.with_spmm_plans(**kw)
    torch.cuda.synchronize()
    plans_s = time.perf_counter() - t0
    g_cpu = dt.add_self_loop(dt.remove_self_loop(dt.to_simple(cpu[0])))
    same_graph_on(g, g_cpu, "the Reddit recipe's graph")
    gp_cpu = g_cpu.with_spmm_plans(**kw)
    if gp._relation().bitmap_plan is None:
        raise RuntimeError("the Reddit recipe's graph lacks its bitmap")
    feat = g.ndata["feat"]

    def make(dev):
        # the example's GraphConv 602-16 (ReLU) -> GraphConv 16-41
        return GCN(feat.shape[1], GCN_HIDDEN, card.num_classes, dropout=0.0,
                   generator=torch.Generator().manual_seed(0), device=dev)

    model = make("cuda")
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    res = recipe_run(model, lambda: make("cpu"), gp, gp_cpu, node_frames(g),
                     node_frames(g_cpu), opt, DATA_REDDIT_STEPS, 2e-2,
                     {"bitmap_spmm": 2}, {"bitmap_spmm": 4}, 0.0,
                     "GCN on RedditDataset()")
    rel = gp._relation()
    out = {"nodes": g.num_nodes(), "edges": rel.num_edges,
           "plans_s": plans_s, **res}
    emit({"phase": "data_reddit_gcn", "recipe": "examples/reddit_fullgraph_"
          "gcn.py: to_simple, self-loops, with_spmm_plans(num_hubs=256, "
          "bitmap=True, bitmap_max_bytes=8 << 30), GraphConv 602-16-41, "
          "Adam 1e-2", **out, **tag})
    return out


def run_data_ogb_fixture_gcn(tag: dict) -> dict:
    """Phase data_ogb_fixture_gcn: the OGB-layout fixture of the checkout
    read by ``from_ogb`` on the card, ``tests/test_real_train.py``'s GCN
    (no plan: no kernel), its floors."""
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch.data import from_ogb
    from dgl_tpu_torch.models import GCN

    root = os.path.join(ROOT, "tests", "fixtures", "ogb")
    t0 = time.perf_counter()
    g = dt.add_self_loop(dt.remove_self_loop(
        from_ogb("ogbn-arxiv_mid", root=root)))
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    g_cpu = dt.add_self_loop(dt.remove_self_loop(
        from_ogb("ogbn-arxiv_mid", root=root, device="cpu")))
    same_graph_on(g, g_cpu, "the OGB fixture's graph")
    feat, y = g.ndata["feat"], g.ndata["label"]
    classes = int(y.max().item()) + 1

    def make(dev):
        return GCN(feat.shape[1], 32, classes, dropout=0.0,
                   generator=torch.Generator().manual_seed(0), device=dev)

    model = make("cuda")
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    res = recipe_run(model, lambda: make("cpu"), g, g_cpu, node_frames(g),
                     node_frames(g_cpu), opt, DATA_OGB_STEPS, 1e-4, {}, {},
                     0.6, "GCN on the OGB fixture")
    if not res["losses"]["last"] < 1.0:
        raise RuntimeError(f"OGB fixture GCN final loss "
                           f"{res['losses']['last']}")
    out = {"nodes": g.num_nodes(), "edges": g.num_edges(), "read_s": read_s,
           **res}
    emit({"phase": "data_ogb_fixture_gcn", "recipe": "tests/test_real_train."
          f"py: GCN {feat.shape[1]}-32-{classes}, no dropout, Adam 1e-2, "
          f"{DATA_OGB_STEPS} steps; floors accuracy >= 0.6, loss < 1.0",
          **out, **tag})
    return out


def gin_batch_loss(model, batch, pattern=None):
    """The GIN recipe's loss over a padded batch: cross-entropy of the real
    graphs' logits, in-degree features."""
    bg, y, gmask = batch
    x = bg.in_degrees().float()[:, None]
    with relu_pattern(pattern) as seen:
        loss = masked_loss(model(bg, x), y, gmask.float())
    return loss, seen


def run_data_minigc_gin(built: dict, tag: dict) -> dict:
    """Phase data_minigc_gin: ``examples/gin_graph_classification.py``."""
    import numpy as np
    import torch

    import dgl_tpu_torch.data as D
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.dataloading import GraphDataLoader
    from dgl_tpu_torch.models import GIN

    train_ds, train_cpu = built["MiniGCDataset"]
    test_ds = D.MiniGCDataset(80, 10, 20, seed=1)
    loader = GraphDataLoader(train_ds, batch_size=32, shuffle=True, seed=0)
    first = next(iter(loader))
    first_cpu = next(iter(GraphDataLoader(train_cpu, batch_size=32,
                                          shuffle=True, seed=0,
                                          device="cpu")))
    same_result(first, first_cpu, "the first MiniGC batch, card vs CPU")

    def make(dev):
        return GIN(1, 32, 8, num_layers=3, dropout=0.0,
                   generator=torch.Generator().manual_seed(0), device=dev)

    model = make("cuda")
    check = step_vs_cpu(model, lambda: make("cpu"), gin_batch_loss, first,
                        batch_cpu=first_cpu)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)

    def step(batch):
        opt.zero_grad(set_to_none=True)
        loss = gin_batch_loss(model, batch)[0]
        loss.backward()
        opt.step()
        return loss.detach()

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    losses = [step(first)]
    torch.cuda.synchronize()
    step_launches = dict(_kernels.launch_counts)
    expect_no_other_launch(step_launches, {}, "the GIN step")
    t0 = time.perf_counter()
    steps = 0
    for _ in range(DATA_GIN_EPOCHS):
        for batch in loader:
            losses.append(step(batch))
            steps += 1
    torch.cuda.synchronize()
    epoch_s = (time.perf_counter() - t0) / DATA_GIN_EPOCHS
    losses = torch.stack(losses).tolist()
    if not (all(map(math.isfinite, losses))
            and np.mean(losses[-10:]) < np.mean(losses[:10])):
        raise RuntimeError(f"GIN losses {losses}")
    model.eval()
    correct = total = 0
    with torch.inference_mode():
        for bg, y, gmask in GraphDataLoader(test_ds, batch_size=32):
            pred = model(bg, bg.in_degrees().float()[:, None]).argmax(-1)
            correct += int(((pred == y) & gmask).sum())
            total += int(gmask.sum())
    acc = correct / total
    majority = 10 / 80  # MiniGC's classes are equal: 80 // 8 a class
    if not acc >= 2 * majority:
        raise RuntimeError(f"GIN test accuracy {acc}")
    out = {"train_graphs": len(train_ds), "test_graphs": len(test_ds),
           "first_step_vs_cpu": check, "step_launches": step_launches,
           "steps": steps, "epoch_s": epoch_s,
           "ms_per_step": epoch_s * DATA_GIN_EPOCHS / steps * 1e3,
           "losses": {"first": losses[0], "last": losses[-1]},
           "test_accuracy": acc, "majority_share": majority,
           "floor": 2 * majority}
    emit({"phase": "data_minigc_gin", "recipe": "examples/gin_graph_"
          "classification.py: MiniGC 320 (seed 0) / 80 (seed 1), 10-20 "
          "nodes, GraphDataLoader 32, GIN 1-32-8 x 3 layers, Adam 1e-2",
          **out, **tag})
    return out


def run_data_builtin_graphbolt(built: dict, zoo: dict, tag: dict) -> dict:
    """Phase data_builtin_graphbolt: ``gb.BuiltinDataset("cora")`` from the
    zoo, held against ``CoraGraphDataset``, then GraphBolt's
    node-classification pipeline on it."""
    import numpy as np
    import torch

    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch import graphbolt as gb
    from dgl_tpu_torch.models import GraphSAGE

    card, cpu = built["CoraGraphDataset"]
    g = card[0]
    root = os.path.join(zoo["cuda"], "graphbolt")
    t0 = time.perf_counter()
    ds = gb.BuiltinDataset("cora", root=root)
    graph = ds.graph
    torch.cuda.synchronize()
    write_load_s = time.perf_counter() - t0
    rel, want = graph._relation(), g._relation()
    for f in want.ARRAY_FIELDS:
        same_result(getattr(rel, f), getattr(want, f), f"CSC {f}")
    ids = np.arange(g.num_nodes())
    same_result(torch.as_tensor(ds.feature.read("node", "_N", "feat", ids)),
                g.ndata["feat"].cpu(), "features")
    for split, mask in ((ds.train_set, "train_mask"),
                        (ds.validation_set, "val_mask"),
                        (ds.test_set, "test_mask")):
        got_ids, got_labels = (torch.as_tensor(np.asarray(a))
                               for a in split[np.arange(len(split))])
        sel = torch.nonzero(g.ndata[mask]).squeeze(1).cpu()
        same_result(got_ids, sel, f"{mask} ids")
        same_result(got_labels, g.ndata["label"].cpu()[sel],
                    f"{mask} labels")
    if ds.meta["num_classes"] != card.num_classes:
        raise RuntimeError("metadata.json's num_classes")
    ds_cpu = gb.OnDiskDataset(os.path.join(root, "cora"), "cpu")

    def pipe(d, dev):
        return gb_pipeline(d.train_set, d.graph, d.feature, dev,
                           DATA_GB_BATCH, DATA_GB_FANOUTS)

    first = next(iter(pipe(ds, "cuda")))
    first_cpu = next(iter(pipe(ds_cpu, "cpu")))
    same_gb_batch(first, first_cpu, "the first Cora batch, card vs CPU")

    def make(dev):
        return GraphSAGE(g.ndata["feat"].shape[1], 256, card.num_classes,
                         num_layers=2, dropout=0.5,
                         generator=torch.Generator().manual_seed(0),
                         device=dev)

    model = make("cuda")
    check = step_vs_cpu(model, lambda: make("cpu"), gb_loss, first,
                        batch_cpu=first_cpu)
    # Adam at 1e-2 (the JAX package's scripts; 1e-3 barely moves Cora's
    # sparse features in 60 steps)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    dp = pipe(ds, "cuda")
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [gb_step(model, opt, mb, "cuda")
              for _ in range(DATA_GB_EPOCHS) for mb in gb.DataLoader(dp)]
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    expect_no_other_launch(launches, {}, "GraphBolt on Cora")
    if not (all(map(math.isfinite, losses))
            and np.mean(losses[-5:]) < np.mean(losses[:5])):
        raise RuntimeError(f"GraphBolt Cora losses {losses}")
    # the test nodes' logits over sampled blocks, the same stages in order
    test = gb.CopyTo(gb.FeatureFetcher(gb.NeighborSamplerStage(
        gb.ItemSampler(ds.test_set, DATA_GB_BATCH), graph, DATA_GB_FANOUTS,
        batch_size=DATA_GB_BATCH, seed=0, device="cuda"), ds.feature,
        ["feat"]), "cuda")
    model.eval()
    logits, labels = [], []
    with torch.inference_mode():
        for mb in test:
            n = mb.labels.shape[0]
            logits.append(model(mb.blocks, mb.node_features["feat"])[:n])
            labels.append(mb.labels)
    y = torch.cat(labels)
    acc = accuracy_floor(torch.cat(logits), y,
                         torch.ones_like(y, dtype=torch.bool), 0.0,
                         "GraphSAGE on BuiltinDataset('cora')")
    out = {"write_and_load_s": write_load_s, **acc,
           "batches_per_epoch": len(losses) // DATA_GB_EPOCHS,
           "steps": len(losses), "ms_per_step": wall / len(losses) * 1e3,
           "first_step_vs_cpu": check, "launches": launches,
           "losses": {"first": losses[0], "last": losses[-1]}}
    emit({"phase": "data_builtin_graphbolt", "pipeline": "BuiltinDataset("
          "'cora') -> ItemSampler(64) -> NeighborSamplerStage([10, 10]) -> "
          "FeatureFetcher -> CopyTo -> DataLoader, GraphSAGE 1433-256-7, "
          "Adam 1e-2", **out, **tag})
    return out


def run_data(tag: dict) -> dict:
    """The dataset-zoo group: phases 37-43 in fresh temporary directories
    (the download directory too), removed at the end; returns each
    kernel's launches a forward and a step by recipe."""
    import shutil
    import tempfile

    zoo = {"cuda": tempfile.mkdtemp(prefix="zoo_card_"),
           "cpu": tempfile.mkdtemp(prefix="zoo_cpu_")}
    saved = os.environ.get("DGL_TPU_DOWNLOAD_DIR")
    os.environ["DGL_TPU_DOWNLOAD_DIR"] = zoo["cuda"]
    try:
        built = run_data_zoo(zoo, tag)
        citation = run_data_citation_gcn(built, tag)
        gat = run_data_gat(built, tag)
        reddit = run_data_reddit_gcn(built, tag)
        run_data_ogb_fixture_gcn(tag)
        run_data_minigc_gin(built, tag)
        run_data_builtin_graphbolt(built, zoo, tag)
    finally:
        if saved is None:
            os.environ.pop("DGL_TPU_DOWNLOAD_DIR", None)
        else:
            os.environ["DGL_TPU_DOWNLOAD_DIR"] = saved
        for d in zoo.values():
            shutil.rmtree(d, ignore_errors=True)
    recipes = {f"gcn {k}": v for k, v in citation.items()}
    recipes.update({"gat_bitmap cora": gat["bitmap_cora"],
                    "gcn reddit": reddit})
    launches = {}
    for recipe, r in recipes.items():
        for name in set(r["forward_launches"]) | set(r["step_launches"]):
            f, s = r["forward_launches"][name], r["step_launches"][name]
            if f or s:
                launches.setdefault(name, {})[recipe] = {"forward": f,
                                                         "train_step": s}
    return launches


# ---------------------------------------------------------------------------
# the distributed layer: the repo's distributed recipes over four parts held
# by one process on the card (a one-process mesh; no hand kernel)
# ---------------------------------------------------------------------------

DIST_PARTS = 4
# __graft_entry__.py:200-204: dryrun phase 2's full-graph configuration
DIST_FULL_N, DIST_FULL_E, DIST_FULL_F, DIST_FULL_C = (1_250_000, 10_000_000,
                                                      16, 4)
DIST_STEPS = 5
DIST_HETERO_DIV, DIST_HETERO_F = 8, 64
# docs/papers100m_flagship.md section 3: papers100M's widths, fanouts and
# batch; the graph is the products one (see run_dist_flagship)
FLAGSHIP_FEAT, FLAGSHIP_HIDDEN, FLAGSHIP_CLASSES = 128, 256, 172
FLAGSHIP_FANOUTS, FLAGSHIP_BATCH, FLAGSHIP_LR = [15, 10, 5], 1024, 1e-3
DIST_MB_STEPS = 3
# examples/distributed_link_prediction.py and distributed_rgcn_minibatch.py
DIST_LP = dict(num_nodes=2048, num_edges=20_000, num_classes=4, feat_dim=32)
DIST_LP_FANOUTS, DIST_LP_BATCH, DIST_LP_NEG, DIST_LP_HIDDEN = [5], 16, 2, 32
DIST_RGCN_FANOUT, DIST_RGCN_BATCH, DIST_RGCN_HIDDEN = 4, 16, 32
DIST_EXAMPLE_LR = 1e-2
DIST_COOP_BATCH, DIST_COOP_FANOUTS = 64, [10, 10]


def dist_mesh(device="cuda"):
    from dgl_tpu_torch.parallel import create_mesh

    return create_mesh((DIST_PARTS,), ("gp",), device=device)


def _peak_gib(device) -> float:
    import torch

    if torch.device(device).type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated() / 2**30


def _reset_peak(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _gen(seed: int, device):
    import torch

    return torch.Generator(device=device).manual_seed(seed)


def _no_kernel(what: str) -> None:
    from dgl_tpu_torch import _kernels

    expect_no_other_launch(dict(_kernels.launch_counts), {}, what)


def run_dist_fullgraph(tag: dict, device="cuda") -> dict:
    """Phase dist_fullgraph: dryrun phase 2 (``__graft_entry__.py:179-226``)
    over 4 shards of a 1.25M-node, 10M-edge uniform graph: shards built on
    the card and on the CPU (equal), one ``dist_copy_u_sum(mean=True)``
    layer, a linear, cross-entropy over every padded row, SGD 0.1, 5 steps.
    The first step's loss and gradient, the aggregation, ``dist_spmm``
    (sum, mean, max, min with edge values) and the delayed form are held
    against the single-device ``copy_u_mean``/``gspmm`` of the same graph
    at rtol 1e-5, atol 1e-5 * max|ref|."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels, ops
    from dgl_tpu_torch import distributed as td

    _kernels.reset_launch_counts()
    _reset_peak(device)
    rng = np.random.default_rng(61)
    n, e, f, c = DIST_FULL_N, DIST_FULL_E, DIST_FULL_F, DIST_FULL_C
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    g = dt.graph((src, dst), num_nodes=n, device=device)
    g_cpu = dt.graph((src, dst), num_nodes=n, device="cpu")
    parts = td.random_partition_assignment(g, DIST_PARTS, seed=0)
    _sync(device)
    t0 = time.perf_counter()
    shards = td.build_shards(g, parts, DIST_PARTS)
    _sync(device)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shards_cpu = td.build_shards(g_cpu, parts, DIST_PARTS)
    cpu_build_s = time.perf_counter() - t0
    for k in ("src_ext", "dst_local", "edge_mask", "send_idx", "send_mask",
              "in_deg", "order", "new_of_old", "ranges", "n_owned",
              "eids_tbl"):
        same_result(getattr(shards, k), getattr(shards_cpu, k),
                    f"build_shards {k}, card vs CPU")
    mesh = dist_mesh(device)
    tables = td.shard_arrays(mesh, shards)
    gen = _gen(62, device)
    x_old = torch.randn(n, f, generator=gen, device=device)
    x = shards.shard_features(x_old)
    y = torch.randint(0, c, (DIST_PARTS, shards.n_max), generator=gen,
                      device=device)
    w0 = torch.randn(f, c, generator=gen, device=device) * 0.1

    def loss_of(h, w):
        return F.cross_entropy((h @ w).reshape(-1, c), y.reshape(-1))

    # the first step, distributed and on one device
    w = w0.clone().requires_grad_(True)
    h = td.dist_copy_u_sum(mesh, shards, x, tables=tables, mean=True)
    loss = loss_of(h, w)
    loss.backward()
    w_ref = w0.clone().requires_grad_(True)
    h_ref = shards.shard_features(ops.copy_u_mean(g, x_old))
    ref = loss_of(h_ref, w_ref)
    ref.backward()
    checks = {"first_step": held({"loss": loss.detach(), "grad": w.grad,
                                  "h": h.detach()},
                                 {"loss": ref.detach(), "grad": w_ref.grad,
                                  "h": h_ref}, 1e-5,
                                 "dist_copy_u_sum step vs copy_u_mean")}
    w_e = torch.rand(e, generator=gen, device=device) + 0.5
    ev = shards.shard_edge_data(w_e)
    for op in ("sum", "mean", "max", "min"):
        got = td.dist_spmm(mesh, shards, x, ev, tables=tables, reduce_op=op)
        want = shards.shard_features(ops.gspmm(g, "mul", op, x_old,
                                               w_e[:, None]))
        checks[f"dist_spmm_{op}"] = held_against(got, want, 1e-5,
                                                 f"dist_spmm {op}")
    # the delayed form on zero state: the local-only sum, and the fresh
    # halo as the new state
    local_w = torch.from_numpy((parts[src] == parts[dst]).astype(
        np.float32)).to(device)[:, None]
    state = td.init_halo_state(mesh, shards, f)
    out1, state = td.dist_copy_u_sum_delayed(mesh, shards, x, state,
                                             tables=tables)
    checks["delayed_first"] = held_against(
        out1, shards.shard_features(ops.gspmm(g, "mul", "sum", x_old,
                                              local_w)), 1e-5,
        "the delayed sum on zero state vs the local-only sum")
    same_result(state, td.halo_exchange(mesh, x, tables["send_idx"],
                                        tables["send_mask"]),
                "the delayed form's new state vs the fresh halo")
    mesh.reset_comm_bytes()
    td.dist_copy_u_sum(mesh, shards, x, tables=tables)
    halo_bytes = dict(mesh.comm_bytes)

    losses = []

    def step():
        nonlocal w
        w = w.detach().requires_grad_(True)
        lo = loss_of(td.dist_copy_u_sum(mesh, shards, x, tables=tables,
                                        mean=True), w)
        lo.backward()
        w = w.detach() - 0.1 * w.grad
        losses.append(lo.detach())

    w = w0.clone()
    if device == "cuda":
        step_ms = time_ms(step, DIST_STEPS - 1, warmup=1)
    else:
        for _ in range(DIST_STEPS):
            step()
        step_ms = 0.0
    losses = [float(v) for v in losses]
    if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        raise RuntimeError(f"dist_fullgraph losses {losses}")
    _no_kernel("dist_fullgraph")
    out = {"build_shards_s": build_s, "cpu_build_shards_s": cpu_build_s,
           "n_max": shards.n_max, "e_max": shards.e_max,
           "h_max": shards.h_max, "halo_bytes_per_exchange_per_part":
           halo_bytes, "step_ms": step_ms, "losses": losses,
           "peak_gib": _peak_gib(device), "checks": checks}
    emit({"phase": "dist_fullgraph", "config": "dryrun phase 2: 1,250,000 "
          "nodes, 10,000,000 uniform edges, F = 16, C = 4, 4 random parts, "
          "dist_copy_u_sum(mean) -> linear -> cross-entropy, SGD 0.1",
          **out, **tag})
    return out


def run_dist_hetero(tag: dict, device="cuda") -> dict:
    """Phase dist_hetero: ogbn-mag / 8 (``mag_graph``) partitioned into 4 by
    ``hetero_partition_assignment`` (the multilevel partitioner over the
    homogeneous graph), ``build_hetero_shards``, and the per-etype halo
    aggregation at F = 64, plain and edge-weighted, against the
    single-device ``multi_update_all`` (copy_u / u_mul_e, sum; cross sum),
    and the delayed form's second call against the fresh one, at rtol
    1e-5, atol 1e-5 * max|ref|."""
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch import distributed as td
    from dgl_tpu_torch import function as fn

    _kernels.reset_launch_counts()
    _reset_peak(device)
    mag = mag_graph(div=DIST_HETERO_DIV)
    hg = dt.heterograph(mag["data"], mag["nodes"], device=device)
    t0 = time.perf_counter()
    assign = td.hetero_partition_assignment(hg, DIST_PARTS)
    partition_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hs = td.build_hetero_shards(hg, assign, DIST_PARTS)
    _sync(device)
    build_s = time.perf_counter() - t0
    mesh = dist_mesh(device)
    gen = _gen(64, device)
    feats = {nt: torch.randn(hg.num_nodes(nt), DIST_HETERO_F, generator=gen,
                             device=device) for nt in hg.ntypes}
    ew = {cet: torch.rand(hg.num_edges(cet), generator=gen, device=device)
          for cet in hg.canonical_etypes}
    x = hs.shard_features(feats)
    checks = {}
    for name, msg, kw in (
            ("plain", fn.copy_u("h", "m"), {}),
            ("weighted", fn.u_mul_e("h", "w", "m"),
             {"eweights": {c: hs.shard_edge_data(c, ew[c]) for c in ew}})):
        got = hs.unshard(td.dist_hetero_copy_u_sum(mesh, hs, x, **kw))
        gl = hg.local_var()
        for nt in hg.ntypes:
            gl._node_frames.setdefault(nt, {})["h"] = feats[nt]
        for cet in hg.canonical_etypes:
            gl._edge_frames.setdefault(cet, {})["w"] = ew[cet][:, None]
        gl.multi_update_all({cet: (msg, fn.sum("m", "agg"))
                             for cet in hg.canonical_etypes}, "sum")
        for nt in hg.ntypes:
            want = gl._node_frames[nt].get("agg")
            if want is not None:
                checks[f"{name}_{nt}"] = held_against(
                    got[nt], want, 1e-5, f"dist_hetero {name} {nt}")
    state = td.init_hetero_halo_state(mesh, hs, {nt: DIST_HETERO_F
                                                 for nt in hg.ntypes})
    first, state = td.dist_hetero_copy_u_sum_delayed(mesh, hs, x, state)
    second, _ = td.dist_hetero_copy_u_sum_delayed(mesh, hs, x, state)
    fresh = td.dist_hetero_copy_u_sum(mesh, hs, x)
    for nt in hg.ntypes:
        checks[f"delayed_{nt}"] = held_against(second[nt], fresh[nt], 1e-5,
                                               f"dist_hetero delayed {nt}")
    if not any(bool((first[nt] != fresh[nt]).any()) for nt in hg.ntypes):
        raise RuntimeError("the delayed first call read the fresh halo")
    ms = time_ms(lambda: td.dist_hetero_copy_u_sum(mesh, hs, x), 5) \
        if device == "cuda" else 0.0
    _no_kernel("dist_hetero")
    out = {"partition_s": partition_s, "build_shards_s": build_s,
           "n_max": hs.n_max, "h_max": hs.h_max,
           "e_max": {"/".join(k): v for k, v in hs.e_max.items()},
           "aggregate_ms": ms, "peak_gib": _peak_gib(device),
           "checks": checks}
    emit({"phase": "dist_hetero", "config": "ogbn-mag / 8 (mag_graph), 4 "
          "parts, F = 64", **out, **tag})
    return out


def _part_mfg(mfg, p):
    """Part ``p``'s MFG of a mesh's (parts, ...) MFG."""
    from dgl_tpu_torch.sampling.device_sampler import DeviceMFG

    return DeviceMFG([f[p] for f in mfg.frontiers], [n[p] for n in mfg.nbrs],
                     [m[p] for m in mfg.masks], mfg.seed_mask[p])


def _mfg_to(mfg, device):
    from dgl_tpu_torch.sampling.device_sampler import DeviceMFG

    return DeviceMFG(*[[t.to(device) for t in ts] for ts in mfg[:3]],
                     mfg.seed_mask.to(device))


def _global_csc(pgc, device):
    """The parts' CSCs end to end: the whole graph's CSC over the new
    ids (int64 on ``device``)."""
    import numpy as np
    import torch

    offs = np.concatenate([[0], np.cumsum([ix.shape[0]
                                           for ix in pgc.indices])])
    indptr = np.concatenate([pgc.indptr[p][:-1] + offs[p]
                             for p in range(pgc.num_parts)] + [[offs[-1]]])
    return (torch.from_numpy(indptr).to(device),
            torch.from_numpy(np.concatenate(pgc.indices)).to(device))


def _flagship_loss(model, mfg, x, y):
    """The mean cross-entropy of every part's seeds, averaged over the
    parts (the gradient the mesh's mean gives the reference)."""
    import torch
    import torch.nn.functional as F

    return torch.stack([F.cross_entropy(model(_part_mfg(mfg, p),
                                              x[p].float()), y[p])
                        for p in range(x.shape[0])]).mean()


def run_dist_flagship(pgd: dict, tag: dict, device="cuda") -> dict:
    """Phase dist_flagship: the repo's papers100M configuration
    (``docs/papers100m_flagship.md`` section 3) through dryrun phase 7's
    path (``__graft_entry__.py:503-590``) over 4 parts of the
    ogbn-products-count graph (``products_graph``; papers100M's 111M nodes
    and 1.6B edges cut to it, METIS to ``random_partition_assignment``):
    ``PartitionedGraphCSC`` and ``shard_csc_arrays``, ``DeviceDistSampler``
    [15, 10, 5] with 1,024 of its own seeds a part, 128-wide bf16 features
    and 172 classes drawn from a seed, pulled by ``pull_rows_in_shard_map``,
    ``DeviceSAGE`` 128-256-172 (3 layers), the parts' mean loss, Adam 1e-3,
    5 steps. Checks: every MFG's picks, the pulled rows against the table,
    the first step against the CPU (rtol 1e-4), the counted integer bytes
    against the analytic count (5 %). Returns the partitioned graph."""
    import numpy as np
    import torch

    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch import distributed as td
    from dgl_tpu_torch.models import DeviceSAGE

    _kernels.reset_launch_counts()
    _reset_peak(device)
    g = pgd["g"]
    P, B = DIST_PARTS, FLAGSHIP_BATCH
    parts = td.random_partition_assignment(g, P, seed=0)
    t0 = time.perf_counter()
    pgc = td.PartitionedGraphCSC.build(g, parts, P)
    ip, ix = td.shard_csc_arrays(pgc, device=device)
    _sync(device)
    build_s = time.perf_counter() - t0
    n = pgc.num_nodes
    gen = _gen(65, device)
    ftable = pgc.shard_rows(torch.randn(n, FLAGSHIP_FEAT, generator=gen,
                                        device=device).to(torch.bfloat16))
    ltable = pgc.shard_rows(torch.randint(
        0, FLAGSHIP_CLASSES, (n,), generator=gen, device=device).float()[
            :, None])
    mesh = dist_mesh(device)
    sampler = td.DeviceDistSampler(FLAGSHIP_FANOUTS, pgc.ranges)
    gens = [_gen(70 + p, device) for p in range(P)]
    counts = torch.from_numpy(np.diff(pgc.ranges)).to(device)
    lo = torch.from_numpy(pgc.ranges[:-1]).to(device)
    seeds = lo[:, None, None] + (torch.rand(
        (P, DIST_STEPS + 2, B), generator=gen, device=device)
        * counts[:, None, None]).long()
    model = DeviceSAGE(FLAGSHIP_FEAT, FLAGSHIP_HIDDEN, FLAGSHIP_CLASSES,
                       num_layers=3, generator=torch.Generator().manual_seed(
                           0), device=device)
    opt = torch.optim.Adam(model.parameters(), lr=FLAGSHIP_LR)

    def sample(s):
        return sampler.sample_shard(mesh, gens, ip, ix, seeds[:, s])

    def pull(mfg, s):
        x = td.pull_rows_in_shard_map(mesh, pgc.ranges, ftable,
                                      mfg.input_nodes())
        y = td.pull_rows_in_shard_map(mesh, pgc.ranges, ltable,
                                      seeds[:, s])[..., 0].long()
        return x, y

    # the first step, checked
    mesh.reset_comm_bytes()
    mfg = sample(0)
    x, y = pull(mfg, 0)
    int_bytes = mesh.comm_bytes["int"]
    m_in = B
    for f in FLAGSHIP_FANOUTS:
        m_in *= f + 1
    analytic = sampler.comm_bytes_per_sample(B, P) + P * (m_in + B) * 4
    gap = abs(int_bytes - analytic) / analytic
    if gap > 0.05:
        raise RuntimeError(f"exchanged integer bytes {int_bytes} vs the "
                           f"analytic {analytic}")
    indptr, indices = _global_csc(pgc, device)
    masked = sum(check_device_picks(_part_mfg(mfg, p), indptr, indices,
                                    FLAGSHIP_FANOUTS) for p in range(P))
    del indptr, indices
    ids = mfg.input_nodes().long()
    part = torch.clamp(torch.searchsorted(torch.from_numpy(pgc.ranges).to(
        device), ids, right=True) - 1, 0, P - 1)
    slot = part * pgc.n_max + ids - torch.from_numpy(pgc.ranges).to(
        device)[part]
    real = ids >= 0  # a masked pick's id is -1: its row comes back 0
    if not (torch.equal(x[real], ftable.reshape(-1, FLAGSHIP_FEAT)[
            slot[real]]) and not x[~real].any()):
        raise RuntimeError("the pulled rows differ from the table's")
    model_cpu = DeviceSAGE(FLAGSHIP_FEAT, FLAGSHIP_HIDDEN, FLAGSHIP_CLASSES,
                           num_layers=3, device="cpu")
    model_cpu.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    loss = _flagship_loss(model, mfg, x, y)
    loss.backward()
    ref = _flagship_loss(model_cpu, _mfg_to(mfg, "cpu"), x.cpu(), y.cpu())
    ref.backward()
    got, want = {"loss": loss.detach()}, {"loss": ref.detach()}
    for (k, p), q in zip(model.named_parameters(), model_cpu.parameters()):
        got[k], want[k] = p.grad, q.grad
    first = held(got, want, 1e-4, "the flagship's first step vs the CPU")
    opt.step()
    opt.zero_grad(set_to_none=True)
    del mfg, x, y, model_cpu

    s = 1
    times = {"sample_ms": [], "pull_ms": [], "step_ms": []}

    def timed(fn_, key):
        if device != "cuda":
            return fn_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        a.record()
        r = fn_()
        b.record()
        torch.cuda.synchronize()
        times[key].append(a.elapsed_time(b))
        return r

    def train_step():
        nonlocal s
        mesh.reset_comm_bytes()
        mfg_ = timed(lambda: sample(s), "sample_ms")
        x_, y_ = timed(lambda: pull(mfg_, s), "pull_ms")

        def fb():
            lo_ = _flagship_loss(model, mfg_, x_, y_)
            lo_.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
            return lo_.detach()

        s = s % (DIST_STEPS + 1) + 1
        return timed(fb, "step_ms")

    _sync(device)
    t0 = time.perf_counter()
    losses = [float(train_step()) for _ in range(DIST_STEPS - 1)]
    _sync(device)
    wall = (time.perf_counter() - t0) / (DIST_STEPS - 1) * 1e3
    step_bytes = dict(mesh.comm_bytes)
    profile = device_profile(train_step, 2) if device == "cuda" else {}
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"flagship losses {losses}")
    _no_kernel("dist_flagship")
    out = {"partition_build_s": build_s, "n_max": pgc.n_max,
           "input_rows_per_part": m_in, "masked_seeds": masked,
           "sample_ms": float(np.mean(times["sample_ms"] or [0])),
           "pull_ms": float(np.mean(times["pull_ms"] or [0])),
           "step_ms": float(np.mean(times["step_ms"] or [0])),
           "ms_per_step": wall, "int_bytes_per_step_per_part":
           step_bytes["int"], "float_bytes_per_step_per_part":
           step_bytes["float"], "analytic_int_bytes": analytic,
           "int_bytes_rel_gap": gap,
           "device_idle_share": profile.get("device_idle_share"),
           "device_busy_ms_per_step": profile.get("device_busy_ms_per_call"),
           "peak_gib": _peak_gib(device), "first_step_vs_cpu": first,
           "losses": [loss.item()] + losses}
    emit({"phase": "dist_flagship", "config": "papers100M flagship widths "
          "(128-256-172, DeviceSAGE 3 layers, [15, 10, 5], 1,024 seeds a "
          "part, bf16 features, Adam 1e-3) over 4 parts of the "
          "ogbn-products-count graph", **out, **tag})
    return pgc


def _same_blocks(a, b, what):
    for layer, (la, lb) in enumerate(zip(a, b)):
        for p, (x, y) in enumerate(zip(la, lb)):
            same_graph_on(x, y, f"{what}: block {layer} part {p}")


def _sage_parts_loss(model, blocks, x, y, m, total):
    """Masked cross-entropy of every part's seeds over their blocks,
    summed over the parts and divided by the seed count (the reference's
    ``(ls * m).sum() / m.sum()``)."""
    import torch
    import torch.nn.functional as F

    loss = 0.0
    for p in range(x.shape[0]):
        blks = [layer[p] for layer in blocks]
        h = x[p] * blks[0].srcdata["_mask"][:, None].to(x.dtype)
        logits = model(blks, h)[: y.shape[1]]
        loss = loss + (F.cross_entropy(logits, y[p], reduction="none")
                       * m[p]).sum()
    return loss / max(total, 1)


def _first_step(model, make_cpu, loss_fn, args, args_cpu, what):
    """The first step's loss and gradients on the card against the CPU's
    (eval mode; the CPU pass on the card pass's ReLU pattern) at rtol
    1e-4, atol 1e-4 * max|ref|."""
    model_cpu = make_cpu()
    model_cpu.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    model.eval()
    model_cpu.eval()
    with relu_pattern() as seen:
        loss = loss_fn(model, *args)
    loss.backward()
    with relu_pattern([m.cpu() for m in seen]):
        ref = loss_fn(model_cpu, *args_cpu)
    ref.backward()
    got, want = {"loss": loss.detach()}, {"loss": ref.detach()}
    for (k, p), q in zip(model.named_parameters(), model_cpu.parameters()):
        if q.grad is not None:
            got[k], want[k] = p.grad, q.grad
    model.zero_grad(set_to_none=True)
    model.train()
    return held(got, want, 1e-4, what)


def _dist_batch(loader, mesh, pgc, ftable, ltable):
    """The next loader batch with its pulled features, labels, mask and
    seed count."""
    from dgl_tpu_torch import distributed as td

    in_ids, out_ids, blocks = next(loader)
    x = td.sparse_all_to_all_pull(mesh, pgc.ranges, ftable, in_ids)
    y = td.sparse_all_to_all_pull(mesh, pgc.ranges, ltable, out_ids.clamp(
        min=0))[..., 0].long()
    m = (out_ids >= 0).to(x.dtype)
    return in_ids, out_ids, blocks, x, y, m, int(m.sum())


def run_dist_host_minibatch(pgd: dict, pgc, tag: dict,
                            device="cuda") -> dict:
    """Phase dist_host_minibatch: dryrun phase 4's DistDGL workflow on the
    flagship's partitioned products graph: ``DistNeighborSampler``
    [10, 10, 10] with 1,024 seeds a part through ``DistNodeDataLoader``,
    ``sparse_all_to_all_pull`` of the 100-wide features and labels,
    GraphSAGE 100-256-47, Adam 1e-3, 3 steps; the blocks and pulled
    features equal the CPU's, the first step within 1e-4 of the CPU's.
    Then ``DistEdgeDataLoader`` link prediction and
    ``DistEtypeNeighborSampler``'s R-GCN at their examples' sizes."""
    import numpy as np
    import torch

    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch import distributed as td
    from dgl_tpu_torch.models import GraphSAGE

    _kernels.reset_launch_counts()
    _reset_peak(device)
    P = DIST_PARTS
    train = pgc.new_of_old[pgd["train"]]
    mesh, mesh_cpu = dist_mesh(device), dist_mesh("cpu")
    tabs = {}
    for dev, gr in ((device, pgd["g"]), ("cpu", pgd["g_cpu"])):
        tabs[dev] = (pgc.shard_rows(gr.ndata["feat"]),
                     pgc.shard_rows(gr.ndata["label"].float()[:, None]))

    def loader(dev):
        sampler = td.DistNeighborSampler(pgc, PRODUCTS_FANOUTS,
                                         PRODUCTS_BATCH, seed=0, device=dev)
        return iter(td.DistNodeDataLoader(pgc, train, sampler,
                                          PRODUCTS_BATCH, seed=0))

    it, it_cpu = loader(device), loader("cpu")
    t0 = time.perf_counter()
    batch = _dist_batch(it, mesh, pgc, *tabs[device])
    _sync(device)
    first_sample_s = time.perf_counter() - t0
    cpu = _dist_batch(it_cpu, mesh_cpu, pgc, *tabs["cpu"])
    for i, what in ((0, "input ids"), (1, "output ids"), (3, "features"),
                    (4, "labels")):
        same_result(batch[i], cpu[i], f"dist_host_minibatch {what}")
    _same_blocks(batch[2], cpu[2], "dist_host_minibatch")

    def make(dev):
        return GraphSAGE(PRODUCTS_FEAT, PRODUCTS_HIDDEN, PRODUCTS_CLASSES,
                         num_layers=3, dropout=0.5,
                         generator=torch.Generator().manual_seed(0),
                         device=dev)

    model = make(device)
    check = _first_step(model, lambda: make("cpu"), _sage_parts_loss,
                        (batch[2],) + batch[3:], (cpu[2],) + cpu[3:],
                        "dist_host_minibatch's first step vs the CPU")
    opt = torch.optim.Adam(model.parameters(), lr=PRODUCTS_LR)
    losses, sample_s = [], []
    _sync(device)
    t0 = time.perf_counter()
    for step in range(DIST_MB_STEPS):
        if step:
            ts = time.perf_counter()
            batch = _dist_batch(it, mesh, pgc, *tabs[device])
            sample_s.append(time.perf_counter() - ts)
        loss = _sage_parts_loss(model, batch[2], *batch[3:])
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss))
    _sync(device)
    wall = (time.perf_counter() - t0) / DIST_MB_STEPS * 1e3
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"dist_host_minibatch losses {losses}")
    out = {"first_sample_s": first_sample_s,
           "sample_ms": float(np.mean(sample_s)) * 1e3,
           "ms_per_step": wall, "edges_per_block_layer": [
               int(sum(int(b.edata["_mask"].sum()) for b in layer))
               for layer in batch[2]],
           "first_step_vs_cpu": check, "losses": losses,
           "link_prediction": run_dist_link_prediction(device),
           "rgcn": run_dist_rgcn(device), "peak_gib": _peak_gib(device)}
    _no_kernel("dist_host_minibatch")
    emit({"phase": "dist_host_minibatch", "config": "DistNeighborSampler "
          "[10, 10, 10], 1,024 seeds a part, GraphSAGE 100-256-47, Adam "
          "1e-3, 4 parts of the products graph; link prediction and R-GCN "
          "at examples/distributed_*'s sizes", **out, **tag})
    return out


def _lp_loss(model, blocks, x, pos, pidx, nidx, total):
    """``examples/distributed_link_prediction.py``'s loss over every part:
    dot-product scores of the positive and negative pairs."""
    import torch
    import torch.nn.functional as F

    loss = 0.0
    for p in range(x.shape[0]):
        blks = [layer[p] for layer in blocks]
        h = model(blks, x[p] * blks[0].srcdata["_mask"][:, None].to(x.dtype))
        a = h[pidx[p, :, 0]]
        pos_s = (a * h[pidx[p, :, 1]]).sum(-1)
        neg_s = (a[:, None, :] * h[nidx[p]]).sum(-1)
        per = (F.binary_cross_entropy_with_logits(
            pos_s, torch.ones_like(pos_s), reduction="none")
            + F.binary_cross_entropy_with_logits(
                neg_s, torch.zeros_like(neg_s), reduction="none").mean(-1))
        loss = loss + (per * (pos[p, :, 0] >= 0).to(per.dtype)).sum()
    return loss / max(total, 1)


def run_dist_link_prediction(device="cuda") -> dict:
    """``examples/distributed_link_prediction.py``: SyntheticDataset (2,048
    nodes, 20,000 edges, 32 features), the multilevel partition into 4,
    ``DistEdgeDataLoader`` ([5], 16 pairs a part, 2 negatives), GraphSAGE
    32-32-16, Adam 1e-2, 3 steps; the first batch and step against the
    CPU."""
    import numpy as np
    import torch

    from dgl_tpu_torch import distributed as td
    from dgl_tpu_torch.data import SyntheticDataset
    from dgl_tpu_torch.models import GraphSAGE

    P = DIST_PARTS
    runs = []
    for dev in (device, "cpu"):
        g = SyntheticDataset(**DIST_LP, device=dev)[0]
        parts = td.metis_partition_assignment(g, P)
        pgc = td.PartitionedGraphCSC.build(g, parts, P)
        src, dst = (t.cpu().numpy() for t in g.edges())
        train = np.arange(0, g.num_edges(), 4)
        edges = np.stack([pgc.new_of_old[src[train]],
                          pgc.new_of_old[dst[train]]], 1)
        loader = iter(td.DistEdgeDataLoader(
            pgc, edges, DIST_LP_FANOUTS, DIST_LP_BATCH,
            num_negatives=DIST_LP_NEG, seed=0, device=dev))
        runs.append((pgc, pgc.shard_rows(g.ndata["feat"]), loader,
                     dist_mesh(dev)))

    def batch(run):
        pgc, ftable, loader, mesh = run
        pos, neg, seeds, pidx, nidx, in_ids, blocks = next(loader)
        x = td.sparse_all_to_all_pull(mesh, pgc.ranges, ftable, in_ids)
        return (blocks, x, pos, pidx, nidx, int((pos[..., 0] >= 0).sum()))

    b, b_cpu = batch(runs[0]), batch(runs[1])
    _same_blocks(b[0], b_cpu[0], "dist link prediction")
    for i in range(1, 5):
        same_result(b[i], b_cpu[i], f"dist link prediction input {i}")

    def make(dev):
        return GraphSAGE(DIST_LP["feat_dim"], DIST_LP_HIDDEN, 16,
                         num_layers=len(DIST_LP_FANOUTS),
                         generator=torch.Generator().manual_seed(0),
                         device=dev)

    model = make(device)
    check = _first_step(model, lambda: make("cpu"), _lp_loss, b, b_cpu,
                        "dist link prediction's first step vs the CPU")
    opt = torch.optim.Adam(model.parameters(), lr=DIST_EXAMPLE_LR)
    losses = []
    for step in range(DIST_MB_STEPS):
        if step:
            b = batch(runs[0])
        loss = _lp_loss(model, *b)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss))
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"dist link prediction losses {losses}")
    return {"first_step_vs_cpu": check, "losses": losses}


class _DistRGCN:
    """``examples/distributed_rgcn_minibatch.py``'s two ``RelGraphConv``
    layers over etype-sampled blocks (static slot etypes)."""

    def __init__(self, in_feats, num_classes, num_rels, slot_et, device):
        import torch

        from dgl_tpu_torch.nn import RelGraphConv

        gen = torch.Generator().manual_seed(0)
        self.mod = torch.nn.ModuleDict({
            "l1": RelGraphConv(in_feats, DIST_RGCN_HIDDEN, num_rels,
                               self_loop=False, generator=gen,
                               device=device),
            "l2": RelGraphConv(DIST_RGCN_HIDDEN, num_classes, num_rels,
                               self_loop=False, generator=gen,
                               device=device)})
        self.slot_et = [t.to(device) for t in slot_et]

    def __call__(self, blocks, x):
        import torch

        h = torch.relu(self.mod["l1"](blocks[0], x, self.slot_et[0]))
        h = h * blocks[1].srcdata["_mask"][:, None].to(h.dtype)
        return self.mod["l2"](blocks[1], h, self.slot_et[1])


def run_dist_rgcn(device="cuda") -> dict:
    """``examples/distributed_rgcn_minibatch.py``: SyntheticHeteroDataset
    through ``to_homogeneous``, the multilevel partition into 4,
    ``DistEtypeNeighborSampler`` (4 a relation, 2 layers, 16 seeds a
    part), two ``RelGraphConv``s, Adam 1e-2, 3 steps; the first batch and
    step against the CPU."""
    import numpy as np
    import torch

    from dgl_tpu_torch import distributed as td
    from dgl_tpu_torch.base import ETYPE, NTYPE
    from dgl_tpu_torch.convert import to_homogeneous
    from dgl_tpu_torch.data import SyntheticHeteroDataset

    P = DIST_PARTS
    runs = []
    for dev in (device, "cpu"):
        ds = SyntheticHeteroDataset(device=dev)
        hg = ds[0]
        homo = to_homogeneous(hg, ndata=["feat"])
        etypes = homo.edata[ETYPE].cpu().numpy()
        num_rels = len(hg.canonical_etypes)
        parts = td.metis_partition_assignment(homo, P)
        pgc = td.PartitionedGraphCSC.build(homo, parts, P)
        cat = np.nonzero(homo.ndata[NTYPE].cpu().numpy() == hg.ntypes.index(
            ds.predict_ntype))[0]
        labels = torch.zeros(homo.num_nodes(), device=dev)
        labels[torch.from_numpy(cat).to(dev)] = hg._node_frames[
            ds.predict_ntype]["label"].float()
        fanouts = [[DIST_RGCN_FANOUT] * num_rels] * 2
        sampler = td.DistEtypeNeighborSampler(pgc, etypes, fanouts,
                                              DIST_RGCN_BATCH, seed=0,
                                              device=dev)
        loader = iter(td.DistNodeDataLoader(
            pgc, np.sort(pgc.new_of_old[cat]), sampler, DIST_RGCN_BATCH,
            seed=0))
        slot_et = [torch.from_numpy(sampler.slot_etypes(i)) for i in range(2)]
        runs.append((pgc, pgc.shard_rows(homo.ndata["feat"]),
                     pgc.shard_rows(labels[:, None]), loader, dist_mesh(dev),
                     slot_et, num_rels, ds.num_classes,
                     homo.ndata["feat"].shape[1]))

    def batch(run):
        pgc, ftable, ltable, loader, mesh = run[:5]
        return _dist_batch(loader, mesh, pgc, ftable, ltable)[2:]

    b, b_cpu = batch(runs[0]), batch(runs[1])
    _same_blocks(b[0], b_cpu[0], "dist R-GCN")
    same_result(b[1], b_cpu[1], "dist R-GCN features")
    slot_et, num_rels, classes, feats = runs[0][5:]

    class Model(torch.nn.Module):
        def __init__(self, dev):
            super().__init__()
            self.net = _DistRGCN(feats, classes, num_rels, slot_et, dev)
            self.mod = self.net.mod

        def forward(self, blocks, x):
            return self.net(blocks, x)

    model = Model(device)
    check = _first_step(model, lambda: Model("cpu"), _sage_parts_loss, b,
                        b_cpu, "dist R-GCN's first step vs the CPU")
    opt = torch.optim.Adam(model.parameters(), lr=DIST_EXAMPLE_LR)
    losses = []
    for step in range(DIST_MB_STEPS):
        if step:
            b = batch(runs[0])
        loss = _sage_parts_loss(model, *b)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss))
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"dist R-GCN losses {losses}")
    return {"first_step_vs_cpu": check, "losses": losses}


def _pg_worker(rank, world, port, out_path):
    """One process of the two-process gloo run on the card (started by
    ``run_dist_process_group``): the pull with its backward and
    ``dist_copy_u_sum`` over a 2-part process-group mesh, saved for the
    parent."""
    import numpy as np

    from dgl_tpu_torch import distributed as td
    from dgl_tpu_torch.parallel import create_mesh

    td.initialize(coordinator_address=f"127.0.0.1:{port}",
                  num_processes=world, process_id=rank, device="cuda",
                  backend="gloo")
    try:
        mesh = create_mesh((world,), ("gp",), group=True, device="cuda")
        out = {k: v.detach().cpu().numpy()
               for k, v in _pg_case(mesh, "cuda").items()}
        np.savez(f"{out_path}.rank{rank}.npz", **out)
    finally:
        td.exit_client()


def _pg_case(mesh, device) -> dict:
    """The process-group phase's case on ``mesh``: ``sparse_all_to_all_pull``
    (rows and the table's gradient) and ``dist_copy_u_sum`` over a small
    graph, each for the parts held here."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import distributed as td

    P = mesh.shape["gp"]
    rng = np.random.default_rng(66)
    n, rows_max, B, F = 4_000, -(-4_000 // P), 512, 32
    ranges = np.minimum(np.arange(P + 1) * rows_max, n)
    table = torch.from_numpy(rng.normal(size=(P, rows_max, F)).astype(
        np.float32)).to(device)
    ids = torch.from_numpy(rng.integers(0, n, (P, B))).to(device)
    cot = torch.from_numpy(rng.normal(size=(P, B, F)).astype(
        np.float32)).to(device)
    t = mesh.local(table).clone().requires_grad_(True)
    rows = td.sparse_all_to_all_pull(mesh, ranges, t, ids)
    (rows * mesh.local(cot)).sum().backward()
    g = dt.graph((rng.integers(0, n, 40_000), rng.integers(0, n, 40_000)),
                 num_nodes=n, device=device)
    shards = td.build_shards(g, rng.integers(0, P, n), P)
    x = shards.shard_features(torch.from_numpy(rng.normal(
        size=(n, F)).astype(np.float32)).to(device))
    return {"rows": rows, "table_grad": t.grad,
            "agg": td.dist_copy_u_sum(mesh, shards, x, mean=True)}


def _pg_held(got, want, what) -> dict:
    """The pulled rows exactly (gathers); the table's gradient and the
    aggregation (sums whose order the card's atomics choose) at rtol 1e-5,
    atol 1e-5 * max|ref|."""
    same_result(got["rows"].cpu(), want["rows"].cpu(), f"{what}: rows")
    return {k: held_against(got[k].cpu(), want[k].cpu(), 1e-5,
                            f"{what}: {k}")["max_rel_err"]
            for k in ("table_grad", "agg")}


def _gloo_refuses_cuda(port):
    """The error with which gloo refuses a CUDA tensor in
    ``all_to_all_single``, probed once in a world-size-1 group in this
    process; None when it takes it."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        x = torch.arange(8, dtype=torch.float32, device="cuda")
        y = torch.empty_like(x)
        try:
            dist.all_to_all_single(y, x)
        except RuntimeError as e:
            return str(e).strip().splitlines()[0]
        same_result(y.cpu(), x.cpu(), "gloo's all_to_all_single on the card")
        return None
    finally:
        dist.destroy_process_group()


def _pg_two_gloo_processes(port) -> dict:
    """Two processes on the card over gloo at P = 2 (``_pg_worker``), each
    rank held against the one-process mesh. A worker that fails or runs
    past 180 s fails the phase with its errors."""
    import tempfile

    import numpy as np
    import torch

    from dgl_tpu_torch.parallel import create_mesh

    out_path = os.path.join(tempfile.mkdtemp(prefix="dist_pg_"), "out")
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, %r); "
         "import chip_smoke as cs; cs._pg_worker(%d, 2, %d, %r)"
         % (ROOT, rank, port, out_path)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    deadline = time.monotonic() + 180
    errs, late = [], False
    try:
        for p in procs:
            try:
                errs.append(p.communicate(timeout=max(
                    deadline - time.monotonic(), 1.0))[1])
            except subprocess.TimeoutExpired:
                late = True
                p.kill()
                errs.append(p.communicate()[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if late or any(p.returncode for p in procs):
        raise RuntimeError(
            "the gloo workers " + ("ran past 180 s" if late else "failed")
            + "".join(f"\n[rank {r}, rc {p.returncode}] {e[-2000:]}"
                      for r, (p, e) in enumerate(zip(procs, errs))))
    want = _pg_case(create_mesh((2,), ("gp",), device="cuda"), "cuda")
    out = {"ran": True}
    for rank in range(2):
        part = dict(np.load(f"{out_path}.rank{rank}.npz"))
        out[f"rank{rank}"] = _pg_held(
            {k: torch.from_numpy(v) for k, v in part.items()},
            {k: v[rank:rank + 1].detach().cpu() for k, v in want.items()},
            f"gloo on the card, rank {rank} vs the one-process mesh")
    return out


def run_dist_process_group(tag: dict) -> dict:
    """Phase dist_process_group: the process-group backend on the card. A
    world-size-1 NCCL group joined by ``initialize`` (coordinator on
    127.0.0.1): the pull with its backward and ``dist_copy_u_sum`` over it
    against the one-process mesh at P = 1 (exact); then two processes on
    the card over gloo at P = 2 against the one-process mesh, when a
    world-size-1 gloo group takes CUDA tensors in ``all_to_all_single``;
    ``exit_client`` last."""
    import socket

    import torch.distributed as dist

    from dgl_tpu_torch import distributed as td
    from dgl_tpu_torch.parallel import create_mesh

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    t0 = time.perf_counter()
    td.initialize(coordinator_address=f"127.0.0.1:{free_port()}",
                  num_processes=1, process_id=0, device="cuda")
    try:
        backend = dist.get_backend()
        got = _pg_case(create_mesh((1,), ("gp",), group=True,
                                   device="cuda"), "cuda")
        want = _pg_case(create_mesh((1,), ("gp",), device="cuda"), "cuda")
        nccl = _pg_held(got, want, "the NCCL group at P = 1 vs the "
                        "one-process mesh")
    finally:
        td.exit_client()
    if td.get_world_size() != 1 or dist.is_initialized():
        raise RuntimeError("exit_client left the process group")
    nccl_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    refused = _gloo_refuses_cuda(free_port())
    gloo = {"ran": False, "reason": refused} if refused else \
        _pg_two_gloo_processes(free_port())
    out = {"nccl_backend": backend, "nccl_world_size_1": nccl,
           "nccl_world_size_1_s": nccl_s,
           "gloo_two_processes": gloo,
           "gloo_s": time.perf_counter() - t0}
    emit({"phase": "dist_process_group", **out, **tag})
    return out


def run_dist_cooperative(tag: dict, device="cuda") -> dict:
    """Phase dist_cooperative: GraphBolt's pipeline over
    ``BuiltinDataset("cora")`` with ``CooperativeFeatureFetcher`` on a
    4-part mesh (``shard_feature_table``) in place of ``FeatureFetcher``:
    the first batch's features equal ``FeatureFetcher``'s."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from dgl_tpu_torch import graphbolt as gb

    root = tempfile.mkdtemp(prefix="dist_coop_")
    saved = os.environ.get("DGL_TPU_DOWNLOAD_DIR")
    os.environ["DGL_TPU_DOWNLOAD_DIR"] = root
    try:
        ds = gb.BuiltinDataset("cora", root=root, device=device)
        mesh = dist_mesh(device)
        feat = torch.as_tensor(ds.feature.read(
            "node", "_N", "feat", np.arange(ds.graph.num_nodes())))
        tables = {"feat": gb.shard_feature_table(mesh, feat.to(device))}

        def stages():
            return gb.NeighborSamplerStage(
                gb.ItemSampler(ds.train_set, DIST_COOP_BATCH, shuffle=True,
                               seed=0), ds.graph, DIST_COOP_FANOUTS,
                batch_size=DIST_COOP_BATCH, seed=0, device=device)

        coop = next(iter(gb.CooperativeFeatureFetcher(stages(), mesh,
                                                      tables)))
        plain = next(iter(gb.FeatureFetcher(stages(), ds.feature, ["feat"])))
        same_result(coop.node_features["feat"].cpu(),
                    torch.as_tensor(plain.node_features["feat"]).cpu(),
                    "CooperativeFeatureFetcher vs FeatureFetcher")
        mesh.reset_comm_bytes()
        next(iter(gb.CooperativeFeatureFetcher(stages(), mesh, tables)))
        out = {"input_rows": int(len(coop.input_nodes)),
               "bytes_per_part": dict(mesh.comm_bytes)}
    finally:
        if saved is None:
            os.environ.pop("DGL_TPU_DOWNLOAD_DIR", None)
        else:
            os.environ["DGL_TPU_DOWNLOAD_DIR"] = saved
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "dist_cooperative", **out, **tag})
    return out


def run_dist_host_surfaces(tag: dict, device="cuda") -> dict:
    """Phase dist_host_surfaces: ``DistGraph`` over ``partition_graph``'s
    files (its picks, ``node_split``, ``edge_split``), ``DistTensor`` and
    ``DistEmbedding`` with ``SparseAdam`` and ``SparseAdagrad``, and
    ``KVServer``/``KVClient`` push and pull: card against CPU exactly; the
    optimisers against the non-distributed sparse optimisers at 1e-5."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import distributed as td
    from dgl_tpu_torch.base import EID
    from dgl_tpu_torch.nn import sparse_emb

    rng = np.random.default_rng(67)
    n, e = 50_000, 400_000
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    feat = rng.normal(size=(n, 16)).astype(np.float32)
    parts = rng.integers(0, DIST_PARTS, n)
    d = tempfile.mkdtemp(prefix="dist_graph_")
    res = {}
    try:
        g = dt.graph((src, dst), num_nodes=n, device="cpu")
        g.ndata["feat"] = torch.from_numpy(feat)
        td.partition_graph(g, "g", DIST_PARTS, d, parts=parts)
        for dev in (device, "cpu"):
            out = []
            for rank in range(DIST_PARTS):
                dg = td.DistGraph(d, part_id=rank, device=dev)
                book = dg.get_partition_book()
                lo, hi = int(book._ranges[rank]), int(book._ranges[rank + 1])
                sg = dg.sample_neighbors(np.arange(lo, hi)[::97], 5, seed=3)
                out += [*sg.edges(), sg.edata[EID], dg.ndata["feat"][:100],
                        td.node_split(np.arange(n) % 3 == 0, book, rank=rank),
                        td.edge_split(np.arange(e), book, rank=rank)]
            res[dev] = out
        same_result([torch.as_tensor(a).cpu() for a in res[device]],
                    [torch.as_tensor(a) for a in res["cpu"]],
                    "DistGraph card vs CPU")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    checks = {}
    ids = [rng.integers(0, 10_000, 2_048) for _ in range(3)]
    grads = [rng.normal(size=(2_048, 64)).astype(np.float32)
             for _ in range(3)]
    for name, kw in (("SparseAdam", {"lr": 1e-2}),
                     ("SparseAdagrad", {"lr": 5e-2})):
        tabs = {}
        for dev in (device, "cpu"):
            emb = td.DistEmbedding(10_000, 64, mesh=dist_mesh(dev), seed=5)
            opt = getattr(td.optim, name)([emb], **kw)
            for i, gr in zip(ids, grads):
                opt.step([(_on(i, dev), _on(gr, dev))])
            tabs[dev] = emb.data
        plain = td.DistEmbedding(10_000, 64, seed=5, device=device).data
        init, update = ((sparse_emb.sparse_adam_init,
                         sparse_emb.sparse_adam_update) if name == "SparseAdam"
                        else (sparse_emb.sparse_adagrad_init,
                              sparse_emb.sparse_adagrad_update))
        state = init(plain)
        for i, gr in zip(ids, grads):
            plain, state = update(plain, state, _on(i, device),
                                  _on(gr, device), **kw)
        checks[name] = held_against(tabs[device][:10_000], plain, 1e-5,
                                    f"{name} vs the plain sparse update")
        checks[f"{name}_vs_cpu"] = held_against(tabs[device], tabs["cpu"],
                                                1e-5, f"{name} card vs CPU")
    t = {dev: td.DistTensor((1_000, 8), mesh=dist_mesh(dev)) for dev in
         (device, "cpu")}
    for dev in t:
        t[dev][_on(np.arange(0, 1_000, 7), dev)] = _on(
            np.ones((143, 8), np.float32), dev)
    same_result(t[device].data.cpu(), t["cpu"].data, "DistTensor writes")
    kv = {}
    for dev in (device, "cpu"):
        c = td.KVClient(td.KVServer(0))
        c.init_data("feat", (n, 16), np.float32)
        c.push("feat", _on(np.arange(0, n, 3), dev), _on(feat[::3], dev))
        kv[dev] = c.pull("feat", _on(np.arange(0, n, 5), dev))
    same_result(kv[device], kv["cpu"], "KVClient push/pull card vs CPU")
    out = {"checks": checks}
    emit({"phase": "dist_host_surfaces", **out, **tag})
    return out


def run_dist(tag: dict) -> dict:
    """The distributed group's phases that need no products graph."""
    t0 = time.perf_counter()
    out = {"fullgraph": run_dist_fullgraph(tag),
           "hetero": run_dist_hetero(tag),
           "process_group": run_dist_process_group(tag),
           "cooperative": run_dist_cooperative(tag),
           "host_surfaces": run_dist_host_surfaces(tag)}
    out["seconds"] = time.perf_counter() - t0
    return out


def run() -> dict:
    import torch

    from dgl_tpu_torch import _kernels

    card = card_info()
    rate = hbm_rate(torch.cuda.get_device_name(0))
    tag = {"card": card}

    # 1. build the kernels from the checkout's sources (one nvcc each,
    # started together), and B1 (with its weighted caller), B3, B4 and B5
    # once more for ptxas's report
    t0 = time.perf_counter()
    procs = ptxas_start(list(PREV_MS) + ["shell_prefix_sum"])
    _kernels.library()
    ptxas = {name: ptxas_report(p) for name, p in procs.items()}
    emit({"phase": "build", "kernels": sorted(_kernels.launch_counts),
          "seconds": time.perf_counter() - t0, "ptxas": ptxas, **tag})

    run_fwd_edge_cases(tag)
    run_bwd_edge_cases(tag)
    run_gspmm_edge_cases(tag)
    kernels = [run_sage(rate, tag)]
    kernels += run_reddit(rate, ptxas, tag)
    kernels.append(run_hub_cache(rate, tag))
    edge = run_gat_edge(tag)
    weighted = run_weighted(rate, edge["train_step_ms"], ptxas, tag)
    # B1 and B1w under the zoo's callers, launches a forward
    zoo = weighted.pop("conv_zoo")
    explain = weighted.pop("explain_gcn")
    weighted["explain_gcn_launches"] = {
        "explain_graph": explain["explain_graph_launches"][
            "shell_prefix_gspmm"],
        "per_epoch": explain["launches_per_epoch"],
        "epochs": explain["epochs"]}
    for entry, name in ((kernels[0], "shell_prefix_sum"),
                        (weighted, "shell_prefix_gspmm")):
        entry["conv_zoo_launches_per_forward"] = {
            conv: n[name] for conv, n in zoo.items() if n[name]}
    kernels.append(weighted)
    run_dense_cora(tag)
    run_dense_convs(tag)
    run_gt(tag)
    run_link_sparse(tag)
    t0 = time.perf_counter()
    data = minibatch_data("cuda")
    emit({"phase": "minibatch_data", "setup_s": time.perf_counter() - t0,
          **tag})
    run_sage_minibatch(data, tag)
    e2e = run_sage_end_to_end(data, tag)
    t_gb = time.perf_counter()
    run_graphbolt_device(data, e2e, tag)
    gb_s = time.perf_counter() - t_gb
    del data
    t0 = time.perf_counter()
    pg = products_graph()
    emit({"phase": "products_graph", "nodes": PRODUCTS_N,
          "edges": pg["g"].num_edges(),
          **{k: pg[k] for k in ("data_s", "graph_s", "cpu_copy_s",
                                "setup_s")}, **tag})
    run_products_sage(pg, tag)
    run_products_link(pg, tag)
    run_host_samplers(pg, tag)
    t_gb = time.perf_counter()
    run_graphbolt_products(pg, tag)
    run_graphbolt_layer_and_fused_csc(pg, tag)
    emit({"phase": "graphbolt_total",
          "seconds": gb_s + time.perf_counter() - t_gb, **tag})
    t_dist = time.perf_counter()
    pgc = run_dist_flagship(pg, tag)
    run_dist_host_minibatch(pg, pgc, tag)
    del pgc
    dist_s = time.perf_counter() - t_dist
    del pg
    torch.cuda.empty_cache()
    emit({"phase": "samplers_total", "seconds": time.perf_counter() - t0,
          **tag})
    kernels.append(run_mag(rate, tag))
    run_rgcn_homogeneous(tag)
    run_hgt(tag)
    t0 = time.perf_counter()
    run_sparse_gcn(tag)
    recipe = run_gcn_recipe(tag)
    run_batched_readout(tag)
    emit({"phase": "graph_utilities_total",
          "seconds": time.perf_counter() - t0, **tag})
    kernels[0]["gcn_recipe_launches"] = {
        "forward": recipe["forward_launches"],
        "train_step": recipe["step_launches"]}
    t0 = time.perf_counter()
    sign = run_sign_diffusion(tag)
    gdc = run_gdc_gcn(rate, tag)
    run_graphormer(tag)
    run_gin_glob(tag)
    run_point_cloud(tag)
    run_graph_utils(tag)
    emit({"phase": "graph_utilities_rest_total",
          "seconds": time.perf_counter() - t0, **tag})
    kernels[0]["sign_diffusion_launches_per_call"] = sign["launches"]
    weighted["gdc_gcn_launches"] = {
        d: {"forward": r["forward_launches"]["shell_prefix_gspmm"],
            "train_step": r["step_launches"]["shell_prefix_gspmm"]}
        for d, r in gdc.items()}
    t0 = time.perf_counter()
    run_cluster_gcn(tag)
    run_partition_utilities(tag)
    run_explain_gin(tag)
    emit({"phase": "partitioner_and_explainers_total",
          "seconds": time.perf_counter() - t0, **tag})
    t0 = time.perf_counter()
    data = run_data(tag)
    emit({"phase": "data_total", "seconds": time.perf_counter() - t0,
          **tag})
    for name, by_recipe in data.items():
        entry = next(k for k in kernels if k["name"] == name)
        entry["data_recipe_launches"] = by_recipe
    dist = run_dist(tag)
    emit({"phase": "dist_total", "seconds": dist_s + dist["seconds"],
          **tag})
    return {"kernels": kernels, "card": card}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "dgl_tpu_torch")):
        _fail("dgl_tpu_torch/ is not beside chip_smoke.py: run it from the "
              "root of a checkout")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this script needs a "
              "CUDA card")
    t0 = time.perf_counter()
    try:
        result = run()
    except Exception as exc:  # any failed phase fails the run
        import traceback

        traceback.print_exc()
        _fail(f"{type(exc).__name__}: {exc}")
    emit({"phase": "total", "seconds": time.perf_counter() - t0})
    emit({"kernels": result["kernels"]})
    print(f"card: {result['card']}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
