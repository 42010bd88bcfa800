#!/usr/bin/env python3
"""Smoke run of gisnav_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # build + kernel checks only, no timing
    python3 chip_smoke.py --kernels  # build + kernel checks and times, no path
    python3 chip_smoke.py --seed-spread   # cached-mode fix over RANSAC seeds
    python3 chip_smoke.py --digest   # sha256 of kernel outputs, seeded inputs
    python3 chip_smoke.py --graph    # build + path 8 (the node graph) only
    python3 chip_smoke.py --train    # build + gradients + path 9 (training)
    python3 chip_smoke.py --deploy   # build + paths 10 and 11 only
    python3 chip_smoke.py --multistream   # build + path 12 only
    python3 chip_smoke.py --mesh     # build + paths 12 and 13 (the mesh)
    python3 chip_smoke.py --jpeg     # build + the image codecs phase only
    python3 chip_smoke.py --api      # build + path 14 (the library API) only
    python3 chip_smoke.py --demo     # build + path 15 (the demo maps) only
    python3 chip_smoke.py --webp     # build + path 16 (WebP) only
    python3 chip_smoke.py --jp2      # build + path 17 (JPEG 2000) only
    python3 chip_smoke.py --jpegx    # build + path 18 (lossless and
                                     # arithmetic-coded JPEG) only
    python3 chip_smoke.py --tiffx    # build + path 19 (TIFF variants: CCITT,
                                     # 10-14 bits, a ZSTD DEM) only
    python3 chip_smoke.py --bench    # build + path 20 (python -m
                                     # gisnav_tpu_torch bench) only
    python3 chip_smoke.py --damaged  # build + path 21 (damaged images:
                                     # fixtures, a damaging WMS) only
    python3 chip_smoke.py --envelope # build + path 22 (the JAX repo's
                                     # accuracy battery) only

Phases, each of which fails the run (non-zero exit, no result line):

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds every kernel from the sources in this checkout;
3. kernels: each hand-written kernel against its plain PyTorch version on the
   same inputs at the paths' shapes, with the tolerance stated below, plus
   CUDA-event times of the kernel, the plain version and the closest library
   call, the kernel's device time (``device_ms``, torch.profiler), the
   whole 3-shear rotation, and the kernel's bound on an H100;
4. path 1: the bucketed warp runner with the bundled learned_lg9 weights
   (SuperPoint + LightGlue-9) at 1088x1920 and 2048 keypoints over a seeded
   rendered scene: 8 frames over 3 rotation buckets, during which its four
   kernels must launch, then a timing window of 14 bucket-refresh frames and
   64 cached frames, each the replay of the runner's captured frame graph;
   then the same 64 frames through ``build_frame_to_geopose_warpcached``
   eagerly (same bucket features, RANSAC noise from the same seeds):
   matches and inliers identical and the fix within 1 mm, and a tapped
   copy of the program (LightGlue's ``matches0`` and RANSAC's sample
   indices as outputs) graphed against eager on 16 of them, both
   identical; the graphed and eager p50 / p90, each side's device busy
   time (torch.profiler over 10 frames) and idle share, the capture's time
   and the graph pool's memory;
5. path 2: the cached-reference runner on a 2048x2048 map with 4096
   reference keypoints over the 8x8 tile grid: one map extraction, then 16
   frames at 2048 query keypoints (fused LightGlue, one stream at a time),
   3 more with a position prior and 4 through a derotating runner, and 4
   frames at 1792 (the module route, whose attention is the masked
   attention kernel, 36 calls of 2 launches a frame);
6. path 3: the exact-warp runner for 4 frames (pair SuperPoint, gather warp
   with zoom), then the zoom-less exact-warp frame program on a 2048x2048
   map at the query's ground sample distance for 4 frames (the 3-shear
   rotation, 3 shear launches a frame: two along the last axis, one along
   the first);
7. path 4: the default bundle, harris_lg5 (Harris detector + LightGlue-5)
   at its own width, 480x640 and 512 keypoints, on the sizing of the JAX
   package's 8-yaw cached sweep (an 800x800 map at 3x the footprint): the
   cached runner on 8 yaws (query pooled to 240x320, LightGlue one stream
   at a time at 512 x 1024), the bucketed and the exact-warp runners on 4
   (dual LightGlue at 512 / 512), exact launch counts a frame; then, printed
   and not gated, the cached runner on bench.py's 2048-px map at 3x;
8. path 5: the semi-dense runner (bundled LoFTR, 480x640, 1024 matches) on
   4 frames of path 4's scene, during which no kernel of the port launches;
9. path 6: the classical backend, ``classical_frame_to_geopose`` (the
   port's SIFT on the query and the crop, 1024 keypoints, MNN matching,
   RANSAC-PnP) on 8 yaws, none a right angle, over path 4's bench map
   (2048 px at 3x, about the 480x640 query's ground sample distance, DEM
   from the same render): the zoom-less rotation of a square map is the
   3-shear, so K6 launches 2 + 1 times a frame and nothing else does; SIFT's
   and the tail's device time, and ``cv2`` must not have been imported;
10. path 7: visual odometry, the port's ``TwistNode`` on a ``LocalBus``
   over 16 frames of a straight, level rendered flight (20 m steps at 300 m,
   the yaw drifting 4 deg), seeded with the first camera's true pose: 15
   poses, the last within 10 m of the truth, no kernel launch;
11. path 8: the node graph from camera frame to mock GPS (bbox, GIS, pose,
   twist, fusion and uORB nodes) over a seeded world that a loopback stub
   WMS serves through the port's ``WMSClient`` at the GIS node's default
   format, the JAX node's ``image/jpeg`` (every GetMap reply must be
   JPEG, decoded by the port's codec): (a) ``GisNavApp``
   on a synchronous bus with the production pose backend (learned_lg9,
   bucketed warp, 480x640 / 512 keypoints) over 24 steps of 30 m at 500 m
   AGL across a bucket edge, the map refreshed below 0.92 overlap: at
   least 3 maps, at least 12 ``SensorGps`` fixes each within 10 m of the
   truth horizontally and vertically, one after the last map refresh,
   ``satellites_used`` 255, exact K1-K4 counts on every frame; then,
   printed and not gated, the JAX package's own track (60 m steps, the
   reference's 0.85 overlap); (b) the graph ``python -m gisnav_tpu_torch
   run`` builds from its defaults (the threaded bus), hovering until 8
   fixes, the median of the last 5 within 10 m; the handlers' p50 / p90,
   the frame-to-fix latency, one UKF ``submit`` and ``state_at``, and
   ``cv2`` and ``requests`` must not have been imported;
12. path 9: training on the card. The kernel phase first holds the
   gradient of every kernel the JAX package differentiates against
   autograd of its plain version (K5's Function at the training shapes,
   8 pairs at 256/512 both ways, its pair axis bit-equal to single calls;
   K1, K2, K4 at one path-4 shape each) and times K5's forward + backward
   against SDPA's. Then (a) ``train`` at the CLI defaults from random init,
   100 steps in chunks of 10, every chunk's loss finite, exactly 24 K5
   launches a step and no other kernel; one step on the card against the
   CPU's from the same params and batch; 8 steps on one fixed batch lower
   its loss; a checkpoint round trip bit-equal; steps/s, step p50 / p90,
   the step's phases and idle share; (b) ``python -m gisnav_tpu_torch
   train --init-weights harris_lg5 --regime cached --out``: 20
   cached-regime steps at lr 5e-5, the written bundle loaded back as
   ``run --weights`` loads it and flown on path 4's scene and 8 yaws,
   every fix within 10 m, 40 K5 launches a step; (c) ``python -m
   gisnav_tpu_torch train --model loftr``, 20 steps, loss finite, no
   kernel launch;
13. path 10: the deployed constellation, each ``python -m
   gisnav_tpu_torch`` process with a deadline, over path 8's world written
   as GeoTIFFs and served by ``gis-serve``, which answers the GIS node's
   default GetMap, ``image/jpeg``, with JPEG (checked first): (a) the
   compose service's
   ``run --shm --wfst --protocol uorb`` (learned_lg9, warp-bucketed,
   480x640 / 512 keypoints), fed over the ShmBus from this process with
   path 8's gated track at a step of 30 m a second after a lead-in of 20
   steps on the same line (the graph loads, fetches its first map and its
   filters converge; printed, not gated): every ``SensorGps`` fix stamped
   within the 24 gated steps within 10 m, ``health`` 0 while the graph
   runs and 1 after it stopped, one WFS-T feature a fix (``GetFeature``),
   each within 10 m of its fix; (b) the vehicle topology, ``run --shm
   --protocol nmea`` with a ``serial --tcp`` process, hovering until 8 GGA
   sentences reach this process's TCP listener, the median of the last 5
   within 10 m; the frame-to-fix p50 / p90 over the ShmBus (the 24 gated
   steps) beside path 8's,
   ``/dev/shm``'s size, and ``nvidia-smi``'s compute processes; the graph
   must hold the card and no other process started here may (each
   process's open ``/dev/nvidia*`` files decide);
14. path 11: ``replay`` (the CLI, in this process so that the kernel counts
   see it) on a dataset of ``tools/make_replay_dataset.py``'s defaults
   (12 frames of 640x480 at 500 m, yaw 25, a square map at 3x the
   footprint) over path 8's world, written once as PNG and once as JPEG
   (``cv2.imencode``'s bytes at 95, under the same names): harris_lg5 with
   ``--fused`` on each, exit code 0 (every frame within 10 m), every fused
   frame within 10 m, exactly a harris_lg5 cached frame's K1-K4 launches a
   frame plus one map extraction, each frame's fix moved between the two
   datasets printed, and the frame p50 of each; then the same on a third
   dataset, the same 12 frames stored as a camera stores them (each
   frame's pixels turned 90 degrees, the port's baseline JPEG, an Exif
   APP1 with Orientation 6 spliced in) under a map written here as a
   256-entry grey palette PNG (``zlib`` and ``struct``): the same gates and
   launches, each fix's move against the upright JPEG dataset's printed;
   then a fourth, the same flight as a GIS exports it
   (``write_replay_dataset(image_format="tiff")``: the map a tiled
   deflate GeoTIFF with predictor 2, the DEM a float32 GeoTIFF, the frames
   TIFF and PGM), whose map, DEM and frames must decode to the PNG
   dataset's arrays bit for bit: the same gates and launches, each fix
   within 1 mm of the PNG dataset's, the frame p50 of each printed;
   the classical backend on 3 frames of the
   same flight over an 896-px map, a side the shear kernel serves (valid,
   within 10 m, K6 2 + 1 a frame); learned_lg9, printed only (cached mode
   at 3x gives no valid fix in either package);
15. path 12: multistream, 8 camera feeds of learned_lg9 in cached mode
   (1088x1920, 2048 keypoints, each over a map of its own like path 2's,
   2048 px at 1.3x) at 8 points of a 150 m ring of one world, 115 m apart,
   each with its own yaw, the camera 50 m off its map's centre (so a fix
   read through another stream's map lands 30-38 m off): one captured
   graph a tick, the 8 frame programs on 8 forked streams. Every stream
   within 10 m of its own truth and a one-stream scramble over 10 m off;
   stream i identical to the single-stream graphed frame on the same input
   and seed (``matches0``, matches and inliers; the fix within 1 mm), the
   sequential capture identical to the forked one; 32 ticks back to back
   between CUDA events for the forked capture, the sequential capture and
   8 single-frame replays: stream-frames/s, tick p50 / p90, exactly 8 path-2
   frames' K1-K4 launches a tick; the forked tick's device busy time (the
   union of its kernels' intervals, torch.profiler over 4 ticks);
16. path 13: the (data, model) mesh, laid over every card there is cycled
   to 8 slots (one card: every slot ``cuda:0``; the layout is printed):
   (a) path 12's 8 feeds, draws and seeds over a (4 x 1) and a (4 x 2)
   mesh, each data row its 2 streams on its first device with its own tree
   of the weights (``shard_params_tp``: at model 2 every Dense product
   LightGlue forms outside its kernel split over the row's two slots), a
   row on one card replaying one graph, a row across cards eager (the mode
   of each row printed): every stream within 10 m of its own truth, model
   1 identical to path 12's tick stream by stream (matches and inliers;
   the fix within 1 mm), model 2 within the JAX test's bound of model 1
   (lon/lat 2e-5 deg, ``valid`` equal), exactly 8 path-2 frames' K1-K4
   launches a tick, and 32 ticks of each: stream-frames/s and tick p50 /
   p90 beside path 12's forked tick; (b) path 9 (a)'s step (128x160, 256
   keypoints, LightGlue-3, batch 8) on the (4 x 2) mesh, one graph a step
   where the mesh is one card, against the replicated step from the same
   state and batch: loss within 1e-2 relative, every parameter within 5
   lr, the replicas equal and their Dense leaves still sharded, and the
   gradient the update read (Adam's first step moves a parameter by about
   lr whatever its gradient) within ``MESH_GRAD_RTOL`` of the replicated
   step's on its worst leaf (relative norm), where the gradient of row 0's
   block alone lies beyond it; then 10
   mesh steps (every loss finite, 24 K5 launches a row a step) and 10
   replicated ones, steps/s beside path 9 (a)'s;
17. path 14: the library API, the JAX package's functional entry points
   on path 1's scene and learned_lg9 weights: ``load_pretrained`` carried
   to the card by ``params_from_jax``; on frames 0 and 5 (two buckets) a
   bucketed runner of path 1's configuration run with its graphs eager
   (SuperPoint and LightGlue tapped), then ``extract_features`` with the
   runner's SuperPoint settings on the frame and on the bucket's reference
   crop (K1 1, K2 8, K3 1 launches each; the runner's keypoints, scores,
   descriptors and mask bit for bit), ``match_features`` of the two (the
   fused route: K4 36 launches, no K5; the runner's ``matches0`` exactly)
   and of the query against the crop's first 1792 keypoints (the module
   route: K5 72 launches, no K4; ``matches0`` agree on at least 99 % with
   the same call through K5's plain version), each match through
   ``keypoints_to_3d``,
   ``ransac_pnp`` and ``project_points``: every fix valid and within 10 m,
   the fused one within 1 mm of the runner's on the same RANSAC draw, every
   inlier reprojected within the RANSAC threshold; the eager p50 ms of
   each call beside the runner's graphed frame and path 1's, with the
   card's name and power limit;
18. path 15: the demo world. (a) ``tools/make_demo_geotiff_torch.py`` at
   its defaults (4096-px imagery, a 1024-px DEM of 12 m relief) as a
   process, its host seconds, and both GeoTIFFs read back: each array's
   sha256 must equal the JAX tool's (``DEMO_DIGESTS``, held on the CPU by
   ``tests/test_torch_demo_world.py``; this machine has no OpenCV); (b)
   ``gis-serve --maps`` on them as a process, and the GIS node's GetMap of
   the first step's map (2208 px, the default format: JPEG) timed, p50 /
   p90; (c) the graph ``run`` builds from its defaults (deep, learned_lg9,
   warp-bucketed, uorb, the threaded bus) with a ``--params`` file that
   points the GIS node at ``gis-serve`` and sets the main path's 1088x1920
   frames and 2048 keypoints, flown 24 steps of 30 m at 500 m above the
   DEM through the extent's centre (path 8's heading across a bucket
   edge), a frame every 0.5 s, rendered over the DEM's relief with the
   east and north metres of a demo pixel each (``utils/world_wms.py``
   ``GeoWorld``):
   at least 12 ``SensorGps`` fixes, every one within 10 m of its step's
   truth horizontally and vertically, at least 2 maps, every step's K1-K4
   launches a frame's or a bucket refresh's; printed: frame-to-fix p50 /
   p90, the bucket refreshes, the largest and median fix error, and what
   the relief alone does to a PnP fix at that altitude (exact
   correspondences, with and without the heights);
19. path 16: WebP, read as cv2 5.0 reads it (``gis/webp.py`` over
   ``native/webp.cpp``, built here with g++; this machine has no OpenCV
   and no libwebp): (a) every committed WebP fixture
   (``tests/data/torch_webp``: VP8L, VP8 at qualities 1-100, ALPH raw and
   compressed, a palette image, EXIF in VP8X, animations) decoded under
   both flags and every file of its flight under the grey flag, each pixel
   digest equal to cv2's; (b) ``replay`` (the CLI, in this process) with
   learned_lg9 at 2048 keypoints (the cached runner at 1088x1920) over the
   committed flight (``write_replay_dataset(hw=(1088, 1920), frames=8,
   coverage=1.3)`` over path 8's world, the map and frames written as
   WebP by cv2 at quality 90) and over the same flight written here as PNG
   (its JSON and CSV files equal to the WebP flight's, each array within
   ``WEBP_TWIN_MEAN_ABS`` grey levels of the WebP file's decode): exit
   code 0 and every frame valid on each, K1-K4 launched, each WebP fix
   within ``WEBP_MOVE_M`` of the PNG one's, the frame p50 of each; (c) the
   GIS node asking for ``image/webp`` from a loopback stub that answers
   with the flight's WebP map: its raster equal to cv2's grey read of those
   bytes, the fetch timed; (d) the host ms of ``decode_image`` on the
   2208-px WebP map and a 1088x1920 WebP frame beside PNG and JPEG of the
   same pixels, with the card's name and power limit;
20. path 17: JPEG 2000, read as cv2 5.0 reads it (``gis/jpeg2000.py`` over
   ``native/jpeg2000.cpp``, built here with g++; this machine has no
   OpenCV and no OpenJPEG): (a) every committed fixture
   (``tests/data/torch_jp2``: Pillow's, cv2's and OpenJPEG's encoder's
   files, JP2 palettes and channel definitions, 12- and 15-bit
   codestreams, refused and cut files) decoded under both flags, every
   file of its flight under the grey flag and its DEM unchanged, each
   pixel digest equal to cv2's; (b) ``replay`` with learned_lg9 at 2048
   keypoints (the cached runner at 1088x1920) over the committed flight
   (path 16's world and poses, the map and 8 frames irreversible JPEG 2000
   at 30:1 and 25:1, a reversible 16-bit DEM in decimetres that
   ``map.json`` names with ``dem_scale``) and over its PNG twin written
   here (the DEM decoded here and written as a 16-bit TIFF): exit code 0,
   every frame valid, K1-K4 launched, every JPEG 2000 fix within
   ``JP2_FIX_M`` of the truth and ``JP2_MOVE_M`` of the PNG one's, the DEM
   reaching the runner as cv2's uint16 times ``dem_scale``; (c) the GIS
   node asking for ``image/jp2`` from a loopback stub that answers with
   the flight's map: its raster equal to cv2's grey read; (d) the host ms
   of ``decode_image`` on the 2208-px map, a 1088x1920 frame and a
   4096x4096 irreversible RGB image (the fixture tile repeated 8 x 8)
   beside PNG and JPEG of the same pixels, the 4096-px decode's peak
   resident memory, with the card's name and power limit. HTJ2K (JPEG
   2000 Part 15) joins each part: (a) the ``tests/data/torch_htj2k``
   fixtures and the HT flight's files and DEM; (b') the same replay over
   the HT flight (the JPEG 2000 flight's pixels re-coded as HT, its DEM
   bit-equal), each fix within ``JP2_FIX_M`` of the truth and
   ``JP2_MOVE_M`` of the PNG twin's, the DEM's sha256 cv2's; (c') the GIS
   node's ``image/jp2`` raster of the HT map equal to cv2's; (d) the HT
   map and frame timed beside the JPEG 2000 ones, every decode split into
   tier 1 (MQ or HT), the inverse wavelet and the rest by the native
   decoder's timer;
21. path 18: lossless and arithmetic-coded JPEG, read as cv2 5.0 reads
   them (``native/jpeg.cpp``; this machine has no OpenCV and no libjpeg):
   (a) every committed fixture (``tests/data/torch_jpegx``:
   libjpeg-turbo's lossless files at every predictor, a point transform,
   restarts, grey, RGB and CMYK, 2- to 7-bit, subsampled RGB with a scan
   a component, arithmetic-coded transcodes with restarts, DAC
   conditioning and CMYK) decoded under both flags, every file of its
   flight under the grey flag, and a 1088x1920 grey lossless frame
   written here from the first frame's pixels (its bytes the fixture
   tool's) under both flags, each pixel digest equal to cv2's; (b)
   ``replay`` with learned_lg9 at 2048 keypoints over the committed flight
   (path 16's world and poses; cv2's quality-90 files of the map and 8
   frames transcoded to arithmetic coding, the map progressive): exit code
   0, 8 of 8 frames valid and within ``JPEGX_FIX_M`` of the truth, K1-K4
   launched ``JPEGX_LAUNCHES`` times; (c) the GIS node asking for
   ``image/jpeg`` from a loopback stub that answers with the
   arithmetic-coded map: its raster equal to cv2's grey read; (d) host ms
   p50 / p90 of ``decode_image`` on the 2208-px map as arithmetic
   sequential and progressive, on a 1088x1920 frame as arithmetic
   sequential, each beside the baseline Huffman file of the same pixels
   from the port's encoder, and on the lossless frame beside a PNG of it,
   with the card's name and power limit;
22. path 19: TIFF as cv2 5.0's libtiff reads it (``gis/tiff.py``; CCITT
   through ``native/fax3.cpp``, built here with g++; this machine has no
   OpenCV and no libtiff): (a) every committed fixture
   (``tests/data/torch_tiffx``: CCITT RLE, RLEW, Group 3 1-D / 2-D and
   Group 4 from Pillow's libtiff and ``ccitt_1d``, damaged and cut
   strips, 10- to 14-bit samples, the codecs cv2's libtiff lacks or
   refuses (None) or has none for (zero samples), a predictor on
   uncompressed strips, 4x4 YCbCr strips, JPEG-in-TIFF with separate
   planes, BMP bitfields, ZSTD DEMs) decoded under both flags, each pixel
   digest equal to cv2's, None included; (b) the graph ``run`` builds
   (path 15's: learned_lg9, bucketed warp, 1088x1920, 2048 keypoints, the
   threaded bus) flown ``TIFFX_STEPS`` steps over path 16's flat world
   behind a loopback stub WMS that answers the imagery layer as a tiled
   deflate GeoTIFF with predictor 2 and the DEM layer with the committed
   2208-px uint16 ZSTD GeoTIFF (GDAL's COG default, which cv2 reads as
   None): every map published with a zero DEM (as the JAX node makes it)
   and its image equal to the world's crop, at least ``TIFFX_MIN_FIXES``
   uORB fixes, each within 10 m of the truth, every step's K1-K4 launches
   a frame's or a bucket refresh's, the counts printed;
   (c) host ms p50 / p90 of ``decode_image`` on the 2208-px map as
   bilevel Group 4 and Group 3 2-D beside PNG of the same pixels, with the
   card's name and power limit;
23. path 20: ``python -m gisnav_tpu_torch bench`` (``cli.main``, in this
   process so that the counts see it), the JAX package's headline rows at
   its card sizes: the bucketed warp, the exact warp and the cached
   reference with learned_lg9 at 1088x1920 / 2048 keypoints and harris_lg5
   cached at 480x640, each mode's 32 frames one CUDA graph replayed 5
   times over the seeded ring of 4 frames (``bench._render_fixture``, the
   JAX fixture without OpenCV). Its JSON line is printed; every mode's
   ``fps`` must be finite and positive, the bucketed and exact-warp rows
   ``valid_fraction`` 1.0, ``small_config`` without ``error``, the
   bucketed replays exactly 1 / 8 / 1 / 36 K1-K4 launches a frame, and the
   bucketed ``p50_latency_ms`` at most ``BENCH_OVER_PATH1`` x path 1's
   graphed frame p50 of the same run (the same program without a frame's
   upload and host read). Printed for each program: the host ms and the
   CUDA-event ms of each replay, the capture's seconds and the graph
   pool's MiB;
24. path 21: damaged images read as cv2 5.0 reads them. (a) Every seeded
   damage (``tests/torch_image_writers.py`` ``damage_ops``: cuts, byte
   flips, zeroed runs) of every committed fixture under 200 KB, remade
   here from the fixtures and the seed, decoded under both flags: each
   outcome equal to cv2's digest in ``tests/data/torch_damaged/
   digests.json`` (an array, None, or cv2's raise on its size limits, the
   port's ``ValueError``). (b) path 19's graph flown ``DAMAGED_STEPS``
   steps of ``DAMAGED_STEP_M`` east over path 8's world behind a WMS
   that serves PNG imagery (every 4th reply with an IDAT byte flipped:
   the GIS node keeps its map) and an LZW GeoTIFF DEM (every 3rd reply cut
   in half: a zero DEM; the 2nd with a corrupt strip: cv2's partial DEM):
   every uORB fix within 10 m, a map published on every GIS tick after the
   first, the kept maps and published DEMs the schedule's, K1-K4 a frame's
   or a refresh's each step;
25. path 22: the JAX repository's accuracy battery, on the port's worlds
   (``utils/envelope.py``, no cv2; ``cv2`` must stay unimported). (a)
   ``tools/sweep_headline_torch.py`` in this process, bucketed warp at
   the 8 bucket-edge yaws ``7.5 + 45 k``, 500 m, over the 0.417 m/px
   world (6816 px, rendered once on the host and shared with (b)),
   learned_lg9 at 1088x1920 / 2048 keypoints / LightGlue-9: 8 of 8 valid
   and within 10 m horizontally and vertically, each frame K1-K4 a
   bucketed frame's plus its bucket refresh (8 yaws 45 degrees apart are
   8 buckets, every one new to the 4-entry LRU); (b) exact warp at yaws
   0-315 on the same world: 8 of 8, a pair frame's launches each; (c)
   cached with a 30 m prior on the 1.36 m/px shape world: printed only;
   (d) the appearance battery: learned_lg9 exact warp at 480x640 over the
   shape world's 800-px map, 5 query transforms x yaws 30 and 135 (each
   transform's generator ``default_rng(42)``): every fix valid and within
   10 m; harris_lg5 cached under sun shadows printed only; (e) the
   fractal world at harris_lg5's defaults (``make_deep_runner()``), yaws
   15 and 135 on the 1024-px map, and (f) the field-boundary world,
   learned_lg9 exact warp, yaws 15 and 135: every fix valid and within
   10 m. Each section's host seconds (world renders included) and each
   sweep's mean and max beside the JAX repository's records;
26. the NMS cell-max stage on a frame-sized and a map-sized heatmap (the JAX
   package runs that kernel from its stage bench alone);
27. jpeg: the port's JPEG codec (``native/jpeg.cpp``, host C++, built here
   with g++) on seeded world crops, 800x800 grey (the map of ``run``'s
   480x640 camera) and 2208x2208 grey and BGR 4:2:0 (the map of a
   1088x1920 camera): host encode and decode ms p50 beside ``gis/png.py``'s
   on the same rasters, the GIS node's 800-px map fetch (imagery and DEM
   over the stub WMS) p50 as PNG, JPEG and GeoTIFF (the PNG and TIFF
   maps equal to the served raster), the round trip's max and mean
   error at quality 95,
   and the sha256 of the encoder's bytes and of the decoder's pixels on
   one seeded image, each of which must equal OpenCV's (pinned on the CPU
   by ``tests/test_torch_jpeg.py``); then every committed image fixture
   (``tests/data/torch_images``: progressive, cut-short and CMYK/YCCK JPEG,
   EXIF orientations, palette, low-depth, grey + alpha, tRNS, Adam7,
   gamma and eXIf PNG; TIFF, GIF, BMP, Netpbm, PFM, Sun raster and
   Radiance HDR) decoded by ``decode_image`` under both flags, each pixel
   digest equal to the one cv2 gave in ``digests.json`` (None where cv2
   gave None), the host ms of a progressive 800-px grey decode beside the
   baseline file of the same pixels (which must decode to the same
   array), and the host ms of ``decode_image`` at 800 and 2208 px as TIFF
   (uncompressed, LZW and deflate with predictor 2, tiled deflate) and
   GIF beside PNG (each equal to its raster), with the card's name and
   power limit.

``--digest`` instead prints the sha256 of the stem's, the NMS kernels' and
the shear's outputs on seeded inputs (run a copy of this script placed
beside another source's package to hold the two bit for bit).

Every program the JAX package compiles with ``jax.jit`` runs here as a
CUDA graph replay (``pipeline/graph.py``), and each is also run eagerly in
the same run on the same inputs (``GraphSide``; the package itself never
falls back): path 1's bucket refresh (features, DEM crop and crop matrix
identical; the card's matrix within 1 f32 ulp of the host-built one and
the fix through either within 1 mm), path 2's map extraction (identical)
and derotated frames, paths 3 (with zoom and the zoom-less 3-shear,
a graph a quadrant), 4 (exact warp) and 5 (LoFTR), whose replays must
give identical matches (LightGlue's ``matches0`` or LoFTR's mask) and
RANSAC indices and fixes within 1 mm of the eager run's, path 6's rotate +
crop and tail (fixes within 1 mm), path 8's filter steps (UKF and EKF,
``x`` and ``P`` within 1e-6 relative over the 50-call stream) and path 9's
device chunks, (a) and (c): three chunks from one state and generator
seed give the same losses as eager ones (1e-5 relative), each replay draws
the eager chunk's pairs and successive replays draw different ones. Each
pair prints its p50 / p90 (or steps/s), device busy ms and idle share.

Every fix of every path must be valid and within 10 m of the truth (path
5: where the JAX program, run on the CPU on the same frames, localizes;
elsewhere invalid as it is), and a path whose launch counts differ from
the ones it is meant to make (path 1: that never launched one of its
kernels) fails the run. The last line is ``{"ok": true, "device":
{...}}``; the line before it the per-kernel JSON. The port's JAX
counterpart is never imported.
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import hashlib
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over HBM bandwidth and its operations over the
# peak of their type
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

H, W = 1088, 1920
MAX_KP = 2048
PATH1_KERNELS = ("stem_stage", "conv_stage", "nms_select", "fused_block")
CACHED_YAWS = [0.0, 5.0, -10.0, 15.0, 30.0, 45.0, 90.0, 180.0, -45.0, 135.0,
               -90.0, 60.0, -150.0, 20.0, -30.0, 75.0]
# the cached mode matches without a warp, so its map is requested at about
# the query's ground sample distance: 1.3x the footprint over MAP px
CACHED_COVERAGE = 1.3
# of CACHED_YAWS, the frames whose fix moved least over 12 RANSAC seeds
# (``--seed-spread``): derotating the 1088x1920 frame inside itself loses
# its corners, so beyond ~45 deg under 80 matches are left and single seeds
# put the fix 8-12 m off
PRIOR_FRAMES = (1, 4, 8)  # 5, 30 and -45 deg
DEROTATE_FRAMES = (2, 4, 7, 13)  # -10, 30, 180 and 20 deg
SHEAR_YAWS = [20.0, -33.0, 61.5, 117.0]  # none a right angle
MODULE_KP = 1792  # a budget outside the fused predicate: the module route
MAIN_YAWS = [0.0, 3.0, 6.0, 16.0, 20.0, 31.0, 35.0, 2.0]  # path 1: 3 buckets
MAIN_CYCLE_YAWS = [45.0, 60.0, 75.0, 90.0]  # with 0, 16, 31: 7 buckets
API_FRAMES = (0, 5)  # path 14: path 1's frames at yaw 0 and 31 (2 buckets)
API_REPS = 10  # eager library calls timed for each p50
# path 14's module route with K5 against the same call with K5's plain
# version: the share of equal matches0, the LightGlue tests' depth-9 gate
API_MODULE_AGREE = 0.99
API_DEVICE = "cuda"  # path 14's device; a CPU rehearsal sets "cpu"
MAP = 2048  # side of the cached mode's map
# path 15: the demo maps of tools/make_demo_geotiff_torch.py at its
# defaults (4096-px imagery and a 1024-px DEM of 12 m relief over 0.04 deg
# near KSQL), each array's sha256 that of the JAX tool's (uint8, and
# little-endian float32; tests/test_torch_demo_world.py holds them), served
# by gis-serve; run's graph at the main path's width flies 24 steps of 30 m
# at 500 m above the DEM through the extent's centre
DEMO_DIGESTS = {  # layer: (file, dtype, sha256 of the array)
    "imagery": ("demo_imagery.tif", np.uint8,
                "9a7ae3220c76114ef7d25305b6bd7dcf"
                "d1c82bf410d260a6350c775fd2fa94e9"),
    "dem": ("demo_dem.tif", np.float32,
            "d94a8c2ca38e97e33b22ac82e0b25c5a"
            "122811b8dab88d00dc7ab629f2ece71c")}
DEMO_H, DEMO_W, DEMO_KP = H, W, MAX_KP
DEMO_K = np.array([[1200.0, 0.0, 960.0], [0.0, 1200.0, 544.0],
                   [0.0, 0.0, 1.0]])  # f = 400 px at 640 px, as run's camera
DEMO_STEPS, DEMO_STEP_M, DEMO_AGL_M = 24, 30.0, 500.0
# wall time from a frame to the next (its stamp is a second later; the graph
# runs no timer): room for the twist node's SIFT and the fusion behind it,
# so no frame queues behind the next one's work on the device lock
DEMO_PERIOD_S = 0.5
DEMO_MIN_FIXES = 12  # of 24 steps: the mock GPS warms up on 10 odometries
DEMO_GETMAPS = 10
DEMO_TOOL_DEADLINE_S = 120.0
DEMO_FRAME_DEADLINE_S = (120.0, 30.0)  # the first step (captures), others
DEMO_DEVICE = "cuda"  # path 15's device; a CPU rehearsal sets "cpu"
STEM_RAGGED = (100, 132)  # even, no multiple of the kernel's 8x16 tile
CACHED_FRAMES = 64  # timing window of frames that hit the bucket cache
# path 12: camera feeds a tick, each with its own yaw, and the ticks timed
STREAMS = 8
STREAM_YAWS = [10.0, 55.0, 100.0, 145.0, 190.0, 235.0, 280.0, 325.0]
MULTISTREAM_TICKS = 32
CONV_SHAPES = [  # (name, h, w, cin, cmid, cout or None, pool) per image
    ("stage2", 544, 960, 64, 64, 64, True),
    ("stage3", 272, 480, 64, 128, 128, True),
    ("stage4", 136, 240, 128, 128, 128, False),
    ("convPa", 136, 240, 128, 256, None, False),
    ("convDa", 136, 240, 128, 256, None, False),
]
# the harris_lg5 conv stages (path 4): the 480x640 frame's, the
# cached mode's 240x320 pooled query's and the 800 map's, each checked
# against the plain version (not timed)
HARRIS_CONV_SHAPES = [
    (f"{tag} {name}", h // d, w // d, cin, cmid, cout, pool)
    for tag, h, w in (("frame", 480, 640), ("pooled", 240, 320),
                      ("map", 800, 800))
    for name, d, cin, cmid, cout, pool in (
        ("stage2", 2, 64, 64, 64, True), ("stage3", 4, 64, 128, 128, True),
        ("stage4", 8, 128, 128, 128, False),
        ("convDa", 8, 128, 256, None, False))]
# path 4's scene: the JAX package's 8-yaw cached sweep sizing
# (tests/test_cached_rotation.py: 480x640 at f = 400 px, 500 m AGL, an 800
# px map at 3x the footprint, the camera ~22 m off the centre along its yaw)
HARRIS_YAWS = [0.0, 45.0, 90.0, 135.0, 180.0, 225.0, 270.0, 315.0]
HARRIS_SCENE = dict(seed=6, h=480, w=640, yaws=HARRIS_YAWS, map_side=800,
                    coverage=3.0, offset_m=22.2)
BENCH_MAP = 2048  # bench.py's cached-mode map side, at 3x the footprint
# path 5: the frames of path 4's scene that the JAX semi-dense runner
# localizes on the CPU (tests/test_torch_loftr.py); on frame 0 it finds 12
# matches, under min_matches, and returns an invalid fix
SEMIDENSE_FRAMES = (0, 1, 2, 3)
SEMIDENSE_VALID = (1, 2, 3)
# path 6: the PoseNode's classical defaults (480x640, 1024 keypoints) on
# path 4's bench map; a yaw that is a multiple of 90 deg takes the exact
# rot90 route and K6 would not launch
CLASSICAL_YAWS = [10.0, 37.0, 65.0, 100.0, 143.0, 200.0, 250.0, 320.0]
CLASSICAL_SCENE = {**HARRIS_SCENE, "map_side": BENCH_MAP,
                   "yaws": CLASSICAL_YAWS}
# path 7: the flight the twist node integrates
VO_FLIGHT = dict(seed=8, h=480, w=640, steps=16, step_m=20.0, alt_m=300.0,
                 yaw_drift_deg=4.0)
# path 8: the node graph over a seeded world served by the loopback stub
# WMS: the camera of the JAX package's envelope tests (480x640, f = 400 px,
# 500 m AGL), the world large enough that the padded map of every step of
# a 24-step, 60 m-step track eastward stays inside it
GRAPH_WORLD = dict(seed=7, size_px=3072, gsd_m=1.36)
GRAPH_START_PX = (990.0, 1536.0)
GRAPH_STEPS, GRAPH_ALT_M = 24, 500.0
# the gated flight's step and refresh threshold. The map side is 3 camera
# footprints, so below 0.92 overlap the camera has moved at most a quarter
# footprint from the map's centre, where the bucketed crop lies (the
# reference's 0.85 lets it move 45 %); 30 m steps (60 m/s) still cross 3
# maps in 24 steps. ``graph_refresh_edge`` flies the JAX package's own
# track, 60 m steps at 0.85, and prints what it gives
GRAPH_STEP_M, GRAPH_OVERLAP = 30.0, 0.92
EDGE_STEP_M, EDGE_OVERLAP = 60.0, 0.85
GRAPH_K = np.array([[400.0, 0.0, 320.0], [0.0, 400.0, 240.0],
                    [0.0, 0.0, 1.0]])
# a learned_lg9 frame at 480x640 / 512 keypoints: the query's SuperPoint
# (stem, 8 stages, select) and LightGlue-9's 18 dual block calls; a frame
# that refreshes its rotation bucket extracts the warped crop as well
GRAPH_FRAME = {"stem_stage": 1, "conv_stage": 8, "nms_select": 1,
               "fused_block": 36}
GRAPH_REFRESH = {"stem_stage": 2, "conv_stage": 16, "nms_select": 2,
                 "fused_block": 36}
GRAPH_CLI_FIXES, GRAPH_CLI_DEADLINE_S = 8, 60.0
# path 9: ``train`` at its CLI defaults (TrainConfig: 128x160, 256
# keypoints, LightGlue-3, batch 8) from random init, in chunks of 10 steps;
# the bundle fine-tune (harris_lg5, cached regime, lr 5e-5); LoFTR training
TRAIN_STEPS, TRAIN_BATCH, TRAIN_DEPTH = 100, 8, 3
FINETUNE_STEPS, LOFTR_STEPS = 20, 20
LOFTR_PAIRS = 2  # the LoFTR chunk's graphed-vs-eager comparison
TRACED_STEPS = 2  # eager train steps traced for device busy time
# K5 a step: self and cross attention both ways, 4 calls a layer, 2 launches
# a call, all pairs in one call
TRAIN_K5_STEP = 4 * TRAIN_DEPTH * 2
FINETUNE_K5_STEP = 4 * 5 * 2  # LightGlue-5, 256 query / 512 map keypoints
K5_TRAIN_SHAPES = [(256, 256), (256, 512), (512, 256), (512, 512)]
TRAIN_DEVICE = "cuda"  # path 9's device; a CPU rehearsal sets "cpu"
# path 13 (b): the mesh step's gradient against the replicated step's, the
# worst leaf's relative norm (read 0.0051 on an H100 at 700 W; the gradient
# of row 0's block alone reads 0.38)
MESH_GRAD_RTOL = 0.02
# the jpeg phase: world crops at the map side of run's 480x640 camera and
# of a 1088x1920 one (gis/wms.py orthoimage_size_for_camera), timing reps
JPEG_SIDES, JPEG_REPS = (800, 2208), (20, 5)
FORMAT_REPS = (10, 3)  # decodes timed at each side of JPEG_SIDES
# the GIS node's map fetch timed in the jpeg phase: path 8's 800-px map of
# 3 footprints (2,400 m at 500 m AGL) over the stub WMS, each format
JPEG_FETCHES, JPEG_FETCH_SIDE_M = 10, 2400.0
JPEG_DIGEST_SEED = 12
# the image fixtures (tools/make_torch_image_fixtures.py) and cv2's digests
IMAGE_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "data", "torch_images")
# a progressive 800-px grey decode timed beside the baseline file of the
# same pixels (cv2.imencode at quality 60 with and without progression)
JPEG_PROGRESSIVE_PAIR = ("prog_grey_800.jpg", "base_grey_800.jpg")
JPEG_PROGRESSIVE_REPS = 20
# sha256 of cv2.imencode(".jpg", jpeg_digest_image()) and of cv2.imdecode
# of those bytes (IMREAD_UNCHANGED, then IMREAD_GRAYSCALE), OpenCV 5.0.0
# over libjpeg-turbo 3.1.2 (tests/test_torch_jpeg.py holds the codec to
# them)
JPEG_DIGEST = (
    "317e509b300e7adb3b50401855ca9839c9dfc0c4f324fbf718b0b5b1c01c8283")
JPEG_DECODE_DIGEST = (
    "0e3295777c6cc005dbf039a1044460630685dc8a9e5e9124eb60cfd25fb72535")
# measured beside the contract's keys: device time (``device_ms``), the
# wrapper's host time (``host_ms``), K4's two launches apart, the library's
# device time, the whole 3-shear rotation, and K1-K4's launches on paths 4,
# 8 and 11 (K6's on paths 6 and 11)
EXTRA_KEYS = ("device_ms", "host_ms", "attention_ms", "epilogue_ms",
              "library_device_ms", "rotation_ms", "rotation_device_ms",
              "path4_launches", "path6_launches", "path8_launches",
              "path9_launches", "path11_launches", "path13_launches",
              "path14_launches", "path15_launches", "path16_launches",
              "path17_launches", "path18_launches", "path19_launches",
              "path20_launches", "path21_launches", "path22_launches",
              "backward_ms",
              "library_backward_ms",
              "step_backward_device_ms", "grad_max_rel_err",
              "grad_cpu_rel_err", "fwd_bwd_device_ms",
              "library_fwd_bwd_device_ms")


def log(msg: str) -> None:
    print(msg, flush=True)


def jpeg_digest_image() -> np.ndarray:
    """A seeded (217, 301, 3) BGR world crop, each channel its own tone
    curve (odd sides: every partial-MCU and upsampling edge path)."""
    from gisnav_tpu_torch.utils.world_wms import World

    grey = World.make(seed=JPEG_DIGEST_SEED, size_px=512,
                      gsd_m=1.36).raster[:217, :301].astype(np.int32)
    return _tinted(grey)


def _tinted(grey: np.ndarray) -> np.ndarray:
    """Grey -> BGR with a tone curve a channel (colour at every edge)."""
    grey = grey.astype(np.int32)
    return np.stack([grey, grey * 3 // 4 + 40, 255 - grey], -1).astype(
        np.uint8)


def jpeg_decode_digest(data: bytes) -> str:
    """sha256 over the colour and the grey decode of JPEG bytes."""
    from gisnav_tpu_torch.gis.jpeg import decode_jpeg

    return hashlib.sha256(decode_jpeg(data).tobytes() + decode_jpeg(
        data, grayscale=True).tobytes()).hexdigest()


def _on_device(e) -> bool:
    """A profiler row of device work (a kernel, a copy): the device span of
    a ``record_function`` range (the optimizer's step, a label) is no
    work, and it would count its kernels twice."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation)


def _kernel_us(e) -> float:
    """Device time (us) of the kernels that a CPU-side profiler event and
    the operations under it launched, its own range's device span left
    out."""
    return (sum(k.duration for k in e.kernels if k.name != e.name)
            + sum(_kernel_us(c) for c in e.cpu_children))


def time_ms(fn, reps: int = 10, warmup: int = 2, batch: int = 1) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds. With ``batch`` >
    1 the events enclose that many calls issued back to back and the time is
    per call: once the queue runs ahead of the card, that is the device's
    time, without the host's cost of issuing one call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return float(np.median(times))


def device_ms(fn, calls: int = 20) -> float:
    """Device time of one ``fn()`` in milliseconds: the durations of the
    kernels and copies it runs (torch.profiler) over ``calls`` calls back to
    back, per call. Unlike events around a batch of calls, this leaves out
    the host's cost of issuing each call, which for a kernel of a few
    microseconds is the larger part: 20 calls of the K6 wrapper between two
    events take the same 0.0325 ms a call whichever kernel they run. Every
    ``fn`` launches a kernel, so a trace that caught none is a fault of the
    meter: it is taken again (one trace of K6 in one run of PR 9 caught
    nothing), and three empty traces raise."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages()
                       if _on_device(e))
        if total_us > 0:
            return total_us / calls / 1e3
        log(f"[time] torch.profiler caught no kernel (trace {attempt + 1})")
    raise RuntimeError("torch.profiler caught no kernel of a call that "
                       "launches one, three times")


def host_ms(fn, calls: int = 100, reps: int = 5) -> float:
    """Host time of one ``fn()`` in milliseconds: the median over ``reps``
    of ``calls`` calls issued back to back from an idle card, per call. For
    a kernel shorter than the wrapper's host cost the queue never fills, so
    this is what a call costs the host (checks, allocation, ctypes,
    launch)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t) * 1e3 / calls)
    torch.cuda.synchronize()
    return float(np.median(times))


def bound_ms(nbytes: float, bf16_ops: float = 0.0,
             f32_ops: float = 0.0) -> tuple:
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = (bf16_ops / BF16_FLOPS + f32_ops / F32_FLOPS) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def card_label() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi unavailable"


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py needs one GPU")
    card = card_label()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from gisnav_tpu_torch.kernels.build import build_all

    t0 = time.time()
    paths = build_all(verbose=True)
    log(f"[build] {len(paths)} libraries in {time.time() - t0:.1f} s")


def _rand(gen, shape, scale=1.0, dtype=torch.float32):
    t = torch.randn(shape, generator=gen, device="cuda") * scale
    return t.to(dtype).contiguous()


def _conv_weights(gen, cin, cout):
    w = _rand(gen, (9, cin, cout), (2.0 / (9 * cin)) ** 0.5, torch.bfloat16)
    return w, _rand(gen, (cout,), 0.05)


def _library_conv(x_nchw, w9):
    import torch.nn.functional as F

    cin, cout = w9.shape[1], w9.shape[2]
    wt = w9.reshape(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return lambda: F.conv2d(x_nchw, wt, padding=1)


def check_conv(gen, quick, results):
    from gisnav_tpu_torch.features.conv import (
        conv_stage,
        conv_stage_plain,
        stem_stage,
        stem_stage_plain,
    )

    # tolerance: bf16 outputs; the kernel and the plain version sum in
    # different orders, so a value can round to a neighbouring bf16 and the
    # difference passes through the next conv: 2 bf16 ulp relative + 0.05
    def err(a, b):
        a, b = a.float(), b.float()
        d = (a - b).abs()
        bad = d > 0.05 + 2.0 ** -7 * b.abs()
        return float(d.max()), int(bad.sum())

    img = torch.rand((H, W), generator=gen, device="cuda")
    w1a, b1a = _conv_weights(gen, 1, 64)
    w1b, b1b = _conv_weights(gen, 64, 64)
    entry = {"name": "stem_stage", "route": "cuda",
             "source": "gisnav_tpu_torch/kernels/conv.cu",
             "replaces": "gisnav_tpu/features/pallas_conv.py:515",
             "max_abs_err": 0.0}
    # the frame, a ragged even size whose edge tiles are partly outside
    # the image (conv1a's image padding and conv1b's patch padding differ),
    # and path 4's frame, pooled query and map
    small = torch.rand(STEM_RAGGED, generator=gen, device="cuda")
    harris = [torch.rand(hw, generator=gen, device="cuda")
              for hw in ((480, 640), (240, 320), (800, 800))]
    for im in (img, small, *harris):
        k_out = stem_stage(im, w1a, b1a, w1b, b1b, pool=True)
        p_out = stem_stage_plain(im, w1a, b1a, w1b, b1b, pool=True)
        e, nbad = err(k_out, p_out)
        log(f"[kernel] stem_stage {im.shape[0]}x{im.shape[1]}: "
            f"max_abs_err={e:.3g} out_of_tol={nbad}")
        if nbad or not torch.isfinite(k_out.float()).all():
            raise RuntimeError("stem_stage disagrees with its plain version")
        entry["max_abs_err"] = max(entry["max_abs_err"], e)
    # conv1a (1->64) and conv1b (64->64) both take bf16 operands, so both
    # count at the bf16 rate, whatever units the kernel runs conv1a on
    nbytes = H * W * 4 + (H // 2) * (W // 2) * 64 * 2 + 9 * 65 * 64 * 2
    entry["bound_ms"], entry["bound_by"] = bound_ms(
        nbytes, bf16_ops=2 * H * W * 9 * 64 * (1 + 64))
    if not quick:
        entry["ms"] = time_ms(lambda: stem_stage(img, w1a, b1a, w1b, b1b))
        b2b = time_ms(lambda: stem_stage(img, w1a, b1a, w1b, b1b), reps=5,
                      batch=20)
        entry["device_ms"] = device_ms(
            lambda: stem_stage(img, w1a, b1a, w1b, b1b))
        log(f"[time] stem_stage: 20 back to back, per call {b2b:.4f} ms; "
            f"device {entry['device_ms']:.4f} ms")
        entry["plain_ms"] = time_ms(
            lambda: stem_stage_plain(img, w1a, b1a, w1b, b1b), reps=3)
        x1 = img.to(torch.bfloat16)[None, None].contiguous(
            memory_format=torch.channels_last)
        x2 = k_out.new_empty((1, 64, H, W)).contiguous(
            memory_format=torch.channels_last)
        c1, c2 = _library_conv(x1, w1a), _library_conv(x2, w1b)
        entry["library_ms"] = time_ms(lambda: (c1(), c2()))
        entry["library_device_ms"] = device_ms(lambda: (c1(), c2()))
        log(f"[time] stem_stage: kernel {entry['ms']:.4f} ms, plain "
            f"{entry['plain_ms']:.4f} ms, cuDNN conv2d "
            f"{entry['library_ms']:.4f} ms (device "
            f"{entry['library_device_ms']:.4f})")
    results.append(entry)

    total = {"name": "conv_stage", "route": "cuda",
             "source": "gisnav_tpu_torch/kernels/conv.cu",
             "replaces": "gisnav_tpu/features/pallas_conv.py:240",
             "max_abs_err": 0.0, "bound_ms": 0.0, "ms": 0.0, "plain_ms": 0.0,
             "library_ms": 0.0, "device_ms": 0.0, "library_device_ms": 0.0}
    t_bytes = t_ops = 0.0
    calls, lib_calls = [], []
    for name, h, w, cin, cmid, cout, pool in CONV_SHAPES + HARRIS_CONV_SHAPES:
        timed = (name, h, w, cin, cmid, cout, pool) in CONV_SHAPES
        x = torch.rand((h, w, cin), generator=gen, device="cuda").to(
            torch.bfloat16)
        w1, b1 = _conv_weights(gen, cin, cmid)
        w2, b2 = _conv_weights(gen, cmid, cout) if cout else (None, None)
        k_out = conv_stage(x, w1, b1, w2, b2, pool=pool)
        p_out = conv_stage_plain(x, w1, b1, w2, b2, pool=pool)
        e, nbad = err(k_out, p_out)
        log(f"[kernel] conv_stage {name} {h}x{w} {cin}->{cmid}"
            f"{'->' + str(cout) if cout else ''}{' pool' if pool else ''}: "
            f"max_abs_err={e:.3g} out_of_tol={nbad}")
        if nbad or not torch.isfinite(k_out.float()).all():
            raise RuntimeError(f"conv_stage {name} disagrees")
        total["max_abs_err"] = max(total["max_abs_err"], e)
        if not timed:
            continue
        c_last = cout or cmid
        ops = 2 * h * w * 9 * cin * cmid + (2 * h * w * 9 * cmid * cout
                                            if cout else 0)
        ho, wo = (h // 2, w // 2) if pool else (h, w)
        nbytes = (h * w * cin * 2 + ho * wo * c_last * 2
                  + 9 * (cin * cmid + cmid * (cout or 0)) * 2)
        t_bytes += nbytes / HBM_BPS
        t_ops += ops / BF16_FLOPS
        total["bound_ms"] += bound_ms(nbytes, bf16_ops=ops)[0]
        if not quick:
            ms = time_ms(lambda: conv_stage(x, w1, b1, w2, b2, pool=pool))
            pms = time_ms(lambda: conv_stage_plain(x, w1, b1, w2, b2,
                                                   pool=pool), reps=3)
            xl = x.permute(2, 0, 1)[None].contiguous(
                memory_format=torch.channels_last)
            lib1 = _library_conv(xl, w1)
            if w2 is not None:
                xm = x.new_empty((1, cmid, h, w)).contiguous(
                    memory_format=torch.channels_last)
                lib2 = _library_conv(xm, w2)

                def lib(lib1=lib1, lib2=lib2):
                    return lib1(), lib2()
            else:
                lib = lib1
            lms = time_ms(lib)
            log(f"[time] conv_stage {name}: kernel {ms:.4f} ms, plain "
                f"{pms:.4f} ms, cuDNN conv2d {lms:.4f} ms")
            total["ms"] += ms
            total["plain_ms"] += pms
            total["library_ms"] += lms
            # device time of a frame's five calls, one trace for each side
            calls.append(lambda x=x, w=(w1, b1, w2, b2), pool=pool:
                         conv_stage(x, *w, pool=pool))
            lib_calls.append(lib)
    if not quick:
        total["device_ms"] = device_ms(lambda: [f() for f in calls])
        total["library_device_ms"] = device_ms(
            lambda: [f() for f in lib_calls])
        log(f"[time] conv_stage, the {len(calls)} shapes: device "
            f"{total['device_ms']:.4f} ms, cuDNN conv2d device "
            f"{total['library_device_ms']:.4f} ms")
    total["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    results.append(total)


def check_nms(gen, quick, results):
    from gisnav_tpu_torch.features.nms_kernel import (
        nms_select,
        nms_select_plain,
    )

    # tolerance: cell_max bit-exact (same max ops); positions 1e-4 px (the
    # soft-argmax exp differs by an ulp between CUDA and PyTorch). Path 1's
    # frame, then path 4's frame and pooled query (240 rows: the bottom
    # border rows zeroed first, as select_keypoints does)
    e_max = e_pos = 0.0
    for h, w in ((H, W), (480, 640), (240, 320)):
        heat = torch.rand((h, w), generator=gen, device="cuda") ** 8
        if h % 32:
            heat[h - 4:] = 0.0
        k_out = nms_select(heat, 4)
        p_out = nms_select_plain(heat, 4)
        em = float((k_out[0] - p_out[0]).abs().max())
        ep = max(float((a - b).abs().max()) for a, b in
                 zip(k_out[1:], p_out[1:]))
        log(f"[kernel] nms_select {h}x{w}: cell_max err={em:.3g} "
            f"position err={ep:.3g}")
        if em != 0.0 or ep > 1e-4:
            raise RuntimeError("nms_select disagrees with its plain version")
        e_max, e_pos = max(e_max, em), max(e_pos, ep)
    heat = torch.rand((H, W), generator=gen, device="cuda") ** 8
    entry = {"name": "nms_select", "route": "cuda",
             "source": "gisnav_tpu_torch/kernels/nms_select.cu",
             "replaces": "gisnav_tpu/features/pallas_nms.py:152",
             "max_abs_err": max(e_max, e_pos), "library_ms": None}
    entry["bound_ms"], entry["bound_by"] = bound_ms(
        H * W * 4 + 3 * (H // 4) * (W // 4) * 4, f32_ops=70 * H * W)
    if not quick:
        entry["ms"] = time_ms(lambda: nms_select(heat, 4))
        entry["device_ms"] = device_ms(lambda: nms_select(heat, 4))
        entry["host_ms"] = host_ms(lambda: nms_select(heat, 4))
        entry["plain_ms"] = time_ms(lambda: nms_select_plain(heat, 4))
        # what one library kernel takes to read the same bytes
        read_ms = device_ms(lambda: torch.amax(heat))
        log(f"[time] nms_select {H}x{W}: kernel {entry['ms']:.4f} ms, "
            f"device {entry['device_ms']:.4f} ms, host "
            f"{entry['host_ms']:.4f} ms, plain "
            f"{entry['plain_ms']:.4f} ms; torch.amax of the heatmap, device "
            f"{read_ms:.4f} ms")
    results.append(entry)


def check_cellmax(gen, quick, results):
    from gisnav_tpu_torch.features.nms_kernel import (
        nms_cellmax,
        nms_cellmax_plain,
        nms_select,
    )

    # tolerance: exact (a selection of input values) against the plain
    # version and against nms_select's cell max
    entry = {"name": "nms_cellmax", "route": "cuda",
             "source": "gisnav_tpu_torch/kernels/nms_select.cu",
             "replaces": "gisnav_tpu/features/pallas_nms.py:57",
             "max_abs_err": 0.0, "library_ms": None, "bound_ms": 0.0,
             "ms": 0.0, "device_ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0,
             "bound_by": "bytes"}
    for h, w in ((H, W), (MAP, MAP)):
        heat = torch.rand((h, w), generator=gen, device="cuda") ** 8
        k_out = nms_cellmax(heat, 4)
        e_plain = float((k_out - nms_cellmax_plain(heat, 4)).abs().max())
        e_sel = float((k_out - nms_select(heat, 4)[0]).abs().max())
        log(f"[kernel] nms_cellmax {h}x{w}: err vs plain={e_plain:.3g} "
            f"vs nms_select cell_max={e_sel:.3g}")
        if e_plain != 0.0 or e_sel != 0.0:
            raise RuntimeError("nms_cellmax is not exact")
        b, by = bound_ms(h * w * 4 * (1 + 1 / 16), f32_ops=34 * h * w)
        if by != "bytes":
            raise RuntimeError("nms_cellmax bound is expected to be bytes")
        entry["bound_ms"] += b
        if not quick:
            ms = time_ms(lambda: nms_cellmax(heat, 4))
            dms = device_ms(lambda: nms_cellmax(heat, 4))
            hms = host_ms(lambda: nms_cellmax(heat, 4))
            log(f"[time] nms_cellmax {h}x{w}: kernel {ms:.4f} ms, device "
                f"{dms:.4f} ms, host {hms:.4f} ms")
            entry["ms"] += ms
            entry["device_ms"] += dms
            entry["host_ms"] += hms
            entry["plain_ms"] += time_ms(lambda: nms_cellmax_plain(heat, 4))
    results.append(entry)


def check_attention(gen, quick, results):
    import torch.nn.functional as F

    from gisnav_tpu_torch.matching.attention import (
        masked_attention,
        masked_attention_plain,
    )

    # tolerance: 1e-2 of the plain version's largest |output| (f32 output of
    # bf16 probabilities times bf16 values; the kernel keeps the reference's
    # rounding points, and sums in another order can move a probability by
    # one bf16 ulp). Unit-normal q over some thousand keys gives outputs of
    # ~0.04, so each shape is also held with q x 4: sharp rows, outputs ~1
    heads, d = 4, 64
    entry = {"name": "masked_attention", "route": "cuda",
             "source": "gisnav_tpu_torch/kernels/attention.cu",
             "replaces": "gisnav_tpu/matching/pallas_attention.py:38",
             "max_abs_err": 0.0}
    ms, plain, lib, bounds, dev, lib_dev = [], [], [], [], [], []
    # the module route's four launches a layer: both self and both cross,
    # timed at path 2's sets (MODULE_KP and twice it); path 14's module
    # call (MAX_KP against MODULE_KP) is held at its shapes too, untimed
    n0, n1 = MODULE_KP, 2 * MODULE_KP
    timed = ((n0, n0), (n1, n1), (n0, n1), (n1, n0))
    path14 = ((MAX_KP, MAX_KP), (MAX_KP, n0), (n0, MAX_KP))
    for kq, kk in timed + path14:
        q, k, v = (_rand(gen, (n, heads, d)) for n in (kq, kk, kk))
        mask = torch.rand((kk,), generator=gen, device="cuda") > 1 / 3
        for sharp in (1.0, 4.0):
            k_out = masked_attention(q * sharp, k, v, mask)
            p_out = masked_attention_plain(q * sharp, k, v, mask)
            e = float((k_out - p_out).abs().max())
            tol = 1e-2 * float(p_out.abs().max())
            log(f"[kernel] masked_attention Kq={kq} Kk={kk} H={heads} D={d} "
                f"q x {sharp:g}: max_abs_err={e:.3g} (tolerance {tol:.3g}, "
                f"mean |out| {float(p_out.abs().mean()):.3g})")
            if not (e <= tol) or not torch.isfinite(k_out).all():
                raise RuntimeError("masked_attention disagrees")
            entry["max_abs_err"] = max(entry["max_abs_err"], e)
        if (kq, kk) not in timed:
            continue
        nbytes = (kq + 2 * kk) * heads * d * 2 + kk * 4 + kq * heads * d * 4
        bounds.append(bound_ms(nbytes, bf16_ops=4 * kq * kk * heads * d))
        if not quick:
            # timed on bf16 inputs, as the SDPA yardstick gets them: the
            # wrapper's casts for an f32 caller are PyTorch launches of
            # their own. One call is the wrapper's bias launch and the
            # kernel's two (statistics, then P.V)
            qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
            ms.append(time_ms(lambda: masked_attention(qb, kb, vb, mask)))
            plain.append(time_ms(
                lambda: masked_attention_plain(qb, kb, vb, mask), reps=3))
            qh, kh, vh = (t.transpose(0, 1)[None] for t in (qb, kb, vb))
            bias = torch.where(mask, 0.0, -1e9).to(torch.bfloat16)[
                None, None, None, :]

            def sdpa(qh=qh, kh=kh, vh=vh, bias=bias):
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=bias)

            lib.append(time_ms(sdpa))
            dev.append(lambda qb=qb, kb=kb, vb=vb, mask=mask:
                       masked_attention(qb, kb, vb, mask))
            lib_dev.append(sdpa)
            log(f"[time] masked_attention Kq={kq} Kk={kk}: kernel "
                f"{ms[-1]:.4f} ms, plain {plain[-1]:.4f} ms, SDPA "
                f"{lib[-1]:.4f} ms")
    entry["bound_ms"] = float(np.mean([b for b, _ in bounds]))
    entry["bound_by"] = bounds[0][1]
    if not quick:
        entry["ms"], entry["plain_ms"], entry["library_ms"] = (
            float(np.mean(x)) for x in (ms, plain, lib))
        # device time of the four shapes, one trace each side, per call
        entry["device_ms"], entry["library_device_ms"] = (
            device_ms(lambda fns=fns: [f() for f in fns]) / len(fns)
            for fns in (dev, lib_dev))
        log(f"[time] masked_attention, mean of the 4 shapes: device "
            f"{entry['device_ms']:.4f} ms, SDPA device "
            f"{entry['library_device_ms']:.4f} ms")
    results.append(entry)


def check_shear(gen, quick, results, ab=False):
    """K6's two entries at path 3's shapes, each shift passed as a number
    and read from device memory (a graphed rotation's residual shears),
    then the whole 3-shear rotation. ``ab``: a copy of this script placed
    beside an older package (to time two sources in one call) may find no
    first-axis entry or device shift there."""
    import torch.nn.functional as F

    from gisnav_tpu_torch.raster import shear_kernel
    from gisnav_tpu_torch.raster.shear import rotate_and_crop_center_shear

    last = shear_kernel.shear_last_axis
    axes = [("shear_last_axis", last, shear_kernel.shear_last_axis_plain)]
    if hasattr(shear_kernel, "shear_first_axis"):
        axes.append(("shear_first_axis", shear_kernel.shear_first_axis,
                     shear_kernel.shear_first_axis_plain))
    elif not ab:
        raise RuntimeError("the package has no shear_first_axis")
    c, n = 2, MAP
    img = torch.rand((c, n, n), generator=gen, device="cuda")
    rows = torch.arange(n, dtype=torch.float32, device="cuda")
    # tolerance: 0. Both entries evaluate the plain versions' f32 expression
    # with round-to-nearest intrinsics; the first axis is also held against
    # the transpose route it replaces
    for name, kernel, plain in axes:
        entry = {"name": name, "route": "cuda",
                 "source": "gisnav_tpu_torch/kernels/shear.cu",
                 "replaces": "gisnav_tpu/raster/pallas_shear.py:30",
                 "max_abs_err": 0.0}
        entry["bound_ms"], entry["bound_by"] = bound_ms(
            2 * c * n * n * 4, f32_ops=7 * c * n * n)
        times = {k: [] for k in ("ms", "device_ms", "host_ms", "plain_ms",
                                 "library_ms", "library_device_ms")}
        for shift in (0.41, -0.41, 0.70, -0.70):
            k_out = kernel(img, shift, n / 2)
            e = float((k_out - plain(img, shift, n / 2)).abs().max())
            msg = f"max_abs_err={e:.3g}"
            if kernel is not last:
                route = last(img.transpose(-1, -2).contiguous(), shift,
                             n / 2).transpose(-1, -2)
                e_route = float((k_out - route).abs().max())
                msg += f", vs the transpose route {e_route:.3g}"
                e = max(e, e_route)
            if not ab:  # the shift read from device memory, as a graph does
                s_dev = torch.tensor(shift, device="cuda")
                e_dev = float((kernel(img, s_dev, n / 2)
                               - plain(img, s_dev, n / 2)).abs().max())
                msg += f", shift on the card {e_dev:.3g}"
                e = max(e, e_dev)
            log(f"[kernel] {name} {c}x{n}x{n} shift={shift:+.2f}: {msg}")
            if e != 0.0 or not torch.isfinite(k_out).all():
                raise RuntimeError(f"{name} disagrees")
            if quick:
                continue
            # the same resample through F.grid_sample: x then y coordinates
            moving = rows[None, :] + shift * (rows[:, None] - n / 2)
            still = rows[:, None].expand(n, n)
            gx, gy = ((moving, still) if kernel is last
                      else (still.T, moving.T))
            grid = torch.stack([2 * gx / (n - 1) - 1, 2 * gy / (n - 1) - 1],
                               dim=-1)[None]
            for prefix, fn in (
                    ("", lambda: kernel(img, shift, n / 2)),
                    ("plain_", lambda: plain(img, shift, n / 2)),
                    ("library_", lambda: F.grid_sample(
                        img[None], grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True))):
                times[prefix + "ms"].append(time_ms(
                    fn, reps=3 if prefix == "plain_" else 10))
                if prefix != "plain_":
                    times[prefix + "device_ms"].append(device_ms(fn))
            times["host_ms"].append(host_ms(lambda: kernel(img, shift,
                                                           n / 2)))
        if not quick:
            entry.update({k: float(np.mean(v)) for k, v in times.items()})
            log("[time] {} {}x{}x{}, mean of 4 shifts: {}".format(
                name, c, n, n, ", ".join(f"{k} {entry[k]:.4f}"
                                         for k in times)))
        results.append(entry)
    if quick:
        return
    # the whole zoom-less rotation (3 shears, crop) at path 3's shapes
    stack = torch.rand((n, n, c), generator=gen, device="cuda")
    rot = [(time_ms(lambda: rotate_and_crop_center_shear(stack, yaw, (H, W))),
            device_ms(lambda: rotate_and_crop_center_shear(
                stack, yaw, (H, W))))
           for yaw in SHEAR_YAWS]
    entry = results[-len(axes)]
    entry["rotation_ms"], entry["rotation_device_ms"] = (
        float(np.mean(x)) for x in zip(*rot))
    log(f"[time] shear rotation {n}x{n}x{c} -> {H}x{W}, mean of "
        f"{len(SHEAR_YAWS)} yaws: {entry['rotation_ms']:.4f} ms, device "
        f"{entry['rotation_device_ms']:.4f} ms")


def _block_inputs(gen, n, kk_total, sets):
    dim = 256
    x = _rand(gen, (n, dim))
    q = _rand(gen, (n, dim), 1.0, torch.bfloat16)
    k = _rand(gen, (kk_total, dim), 1.0, torch.bfloat16)
    v = _rand(gen, (kk_total, dim), 1.0, torch.bfloat16)
    kk = kk_total // sets
    bias = torch.where(torch.rand((sets, kk), generator=gen, device="cuda")
                       < 0.9, 0.0, -1e9).float().contiguous()
    w = [_rand(gen, (dim, dim), dim ** -0.5, torch.bfloat16),
         _rand(gen, (dim,), 0.05),
         _rand(gen, (dim, 2 * dim), (2 * dim) ** -0.5, torch.bfloat16),
         _rand(gen, (dim, 2 * dim), (2 * dim) ** -0.5, torch.bfloat16),
         _rand(gen, (2 * dim,), 0.05),
         1.0 + _rand(gen, (2 * dim,), 0.1), _rand(gen, (2 * dim,), 0.1),
         _rand(gen, (2 * dim, dim), (2 * dim) ** -0.5, torch.bfloat16),
         _rand(gen, (dim,), 0.05)]
    return x, q, k, v, bias, w


def _library_block(x, q, k, v, bias, w, heads=4):
    """SDPA + F.linear epilogue on the same inputs (one set)."""
    import torch.nn.functional as F

    n, dim = x.shape
    dh = dim // heads
    wt = [t.T.contiguous() if t.dim() == 2 else t for t in w]
    qh = q.reshape(1, n, heads, dh).transpose(1, 2)
    kh = k.reshape(1, -1, heads, dh).transpose(1, 2)
    vh = v.reshape(1, -1, heads, dh).transpose(1, 2)
    mask = bias[0].to(torch.bfloat16)[None, None, None, :]

    def run():
        m = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        m = m.transpose(1, 2).reshape(n, dim)
        m2 = F.linear(m, wt[0], w[1].to(torch.bfloat16))
        y = F.linear(torch.cat([x.to(torch.bfloat16), m2], 1),
                     torch.cat([wt[2], wt[3]], 1), w[4].to(torch.bfloat16))
        y = F.gelu(F.layer_norm(y.float(), (2 * dim,), w[5], w[6]),
                   approximate="tanh")
        return x + F.linear(y.to(torch.bfloat16), wt[7],
                            w[8].to(torch.bfloat16)).float()
    return run


def check_block(gen, quick, results):
    from gisnav_tpu_torch.matching.lightglue_fused import (
        _attention_cuda,
        _ffn_cuda,
        fused_block,
        fused_block_plain,
    )

    # tolerance: f32 outputs, the kernel mirrors every bf16 rounding point;
    # sums in another order can move a rounded value by one bf16 ulp. The
    # keys are split over a cluster and merged in split order, no atomics:
    # a second run must give the same bits
    tol = 5e-2
    entry = {"name": "fused_block", "route": "cuda",
             "source": "gisnav_tpu_torch/kernels/lightglue_block.cu",
             "replaces": "gisnav_tpu/matching/lightglue_fused.py:142, "
                         "gisnav_tpu/matching/_old_lgf.py:133",
             "max_abs_err": 0.0}
    # the one-stream cases are the cached path's four launches a layer (self
    # at 2048 and 4096, cross both ways), and the whole of what the older
    # layout's TPU kernel (_old_lgf.py) computes
    cases = [("dual self", 2 * MAX_KP, 2 * MAX_KP, 2, False),
             ("dual cross", 2 * MAX_KP, 2 * MAX_KP, 2, True),
             ("single", MAX_KP, MAX_KP, 1, False),
             ("single 2048 q x 4096 k", MAX_KP, 2 * MAX_KP, 1, False),
             ("single 4096 q x 2048 k", 2 * MAX_KP, MAX_KP, 1, False),
             ("single 4096", 2 * MAX_KP, 2 * MAX_KP, 1, False)]
    # path 4 (harris_lg5, 512 keypoints): the warp modes' dual calls and the
    # cached mode's one-stream calls at 512 query x 1024 map keypoints;
    # checked, not timed
    harris = [("harris dual self", 1024, 1024, 2, False),
              ("harris dual cross", 1024, 1024, 2, True),
              ("harris single 512", 512, 512, 1, False),
              ("harris single 512 q x 1024 k", 512, 1024, 1, False),
              ("harris single 1024 q x 512 k", 1024, 512, 1, False),
              ("harris single 1024", 1024, 1024, 1, False)]
    dual = {"ms": [], "plain_ms": [], "attention_ms": [], "epilogue_ms": [],
            "device_ms": []}
    for name, n, kk_total, sets, cross in cases + harris:
        x, q, k, v, bias, w = _block_inputs(gen, n, kk_total, sets)
        kw = dict(heads=4, sets=sets, cross=cross)
        k_out = fused_block(x, q, k, v, bias, *w, **kw)
        again = fused_block(x, q, k, v, bias, *w, **kw)
        p_out = fused_block_plain(x, q, k, v, bias, *w, **kw)
        e = float((k_out - p_out).abs().max())
        same = bool(torch.equal(k_out, again))
        log(f"[kernel] fused_block {name} ({n} rows, sets={sets}): "
            f"max_abs_err={e:.3g} second run bit-equal={same}")
        if not (e <= tol) or not torch.isfinite(k_out).all():
            raise RuntimeError(f"fused_block {name} disagrees")
        if not same:
            raise RuntimeError(f"fused_block {name}: two runs differ")
        entry["max_abs_err"] = max(entry["max_abs_err"], e)
        if quick or name.startswith("harris"):
            continue
        # the wrapper's two launches alone, on the same inputs
        msg = _attention_cuda(q, k, v, bias, 4, sets, cross)
        t = {"ms": time_ms(lambda: fused_block(x, q, k, v, bias, *w, **kw)),
             "attention_ms": time_ms(
                 lambda: _attention_cuda(q, k, v, bias, 4, sets, cross)),
             "epilogue_ms": time_ms(lambda: _ffn_cuda(x, msg, *w))}
        log(f"[time] fused_block {name}: kernel {t['ms']:.4f} ms "
            f"(attention {t['attention_ms']:.4f}, epilogue "
            f"{t['epilogue_ms']:.4f})")
        log("[time] fused_block {}: 20 back to back, per call {:.4f} ms "
            "(attention {:.4f}, epilogue {:.4f})".format(name, *(
                time_ms(f, reps=5, batch=20) for f in (
                    lambda: fused_block(x, q, k, v, bias, *w, **kw),
                    lambda: _attention_cuda(q, k, v, bias, 4, sets, cross),
                    lambda: _ffn_cuda(x, msg, *w)))))
        if sets == 2:
            t["plain_ms"] = time_ms(lambda: fused_block_plain(
                x, q, k, v, bias, *w, **kw), reps=3)
            t["device_ms"] = device_ms(lambda: fused_block(x, q, k, v, bias,
                                                           *w, **kw))
            log(f"[time] fused_block {name}: plain {t['plain_ms']:.4f} ms, "
                f"device {t['device_ms']:.4f} ms")
            for key, val in t.items():
                dual[key].append(val)
            if not cross:
                # the library does one set a call: two calls for the pair
                half = n // 2
                lib = _library_block(x[:half], q[:half], k[:half], v[:half],
                                     bias[:1], w)
                entry["library_ms"] = 2 * time_ms(lib)
                entry["library_device_ms"] = 2 * device_ms(lib)
                log(f"[time] SDPA + F.linear block, both sets: "
                    f"{entry['library_ms']:.4f} ms, device "
                    f"{entry['library_device_ms']:.4f} ms")
    n, kk, dim = 2 * MAX_KP, MAX_KP, 256
    nbytes = (n * dim * 4 * 2 + n * dim * 2 + 2 * 2 * kk * dim * 2
              + 2 * kk * 4 + 7 * dim * dim * 2)
    entry["bound_ms"], entry["bound_by"] = bound_ms(
        nbytes, bf16_ops=4 * n * kk * dim + 14 * n * dim * dim)
    if not quick:
        entry.update({key: float(np.mean(val)) for key, val in dual.items()})
    results.append(entry)


def _grad_check(name, fn, plain, inputs, g, tol, fwd_tol, cpu_tol=None):
    """The kernel's Function ``fn`` against ``plain`` on the same inputs and
    cotangent: the forward within ``fwd_tol`` of the plain output's largest
    |value|, and each input's gradient against autograd of ``plain``, the
    largest |difference| within ``tol`` of that gradient's largest |value|.
    With ``cpu_tol``, each gradient also against autograd of ``plain`` on
    the CPU, on copies of the same inputs: the norm of the difference within
    ``cpu_tol`` of the CPU gradient's norm. Returns (max relative gradient
    error against the card's plain version, the same against the CPU's or
    None, forward output)."""
    a = [t.detach().clone().requires_grad_() for t in inputs]
    b = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*a)
    out.backward(g.to(out.dtype))
    ref = plain(*b)
    ref.backward(g.to(ref.dtype))
    fwd = float((out.float() - ref.float()).abs().max()) / max(
        float(ref.float().abs().max()), 1e-30)
    if not (fwd <= fwd_tol) or not torch.isfinite(out).all():
        raise RuntimeError(f"{name}: forward disagrees ({fwd:.3g} of the "
                           f"largest |output|, tolerance {fwd_tol:g})")
    worst = 0.0
    for x, y in zip(a, b):
        scale = max(float(y.grad.float().abs().max()), 1e-30)
        worst = max(worst, float((x.grad.float() - y.grad.float()).abs()
                                 .max()) / scale)
    log(f"[grad] {name}: forward {fwd:.3g} of max |output| (tolerance "
        f"{fwd_tol:g}); max |grad - plain autograd| / max |grad| = "
        f"{worst:.3g} (tolerance {tol:g})")
    if not (worst <= tol) or not all(torch.isfinite(x.grad).all()
                                     for x in a):
        raise RuntimeError(f"{name}: gradient disagrees")
    worst_cpu = None
    if cpu_tol is not None:
        c = [t.detach().cpu().clone().requires_grad_() for t in inputs]
        ref = plain(*c)
        ref.backward(g.cpu().to(ref.dtype))
        worst_cpu = max(
            float(torch.linalg.vector_norm(x.grad.cpu().float()
                                           - y.grad.float()))
            / max(float(torch.linalg.vector_norm(y.grad.float())), 1e-30)
            for x, y in zip(a, c))
        log(f"[grad] {name}: |grad - CPU plain autograd| / |CPU grad| = "
            f"{worst_cpu:.3g} (tolerance {cpu_tol:g})")
        if not (worst_cpu <= cpu_tol):
            raise RuntimeError(f"{name}: gradient disagrees with the CPU's")
    return worst, worst_cpu, out.detach()


def _fwd_bwd_ms(fn, inputs, g) -> tuple:
    """CUDA-event times of the forward and of forward + backward."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]

    def fwd():
        return fn(*leaves)

    def both():
        fwd().backward(g)
    return time_ms(fwd), time_ms(both)


def check_gradients(gen, quick, results) -> dict:
    """The gradient of every kernel the JAX package differentiates, on the
    card: K5's Function (the kernel forward, the analytic backward) at the
    training shapes with the pair axis, the pair axis bit-equal to single
    calls, and K1, K2, K4 (backward through the plain version) at one path
    shape each; and, unless ``quick``, the forward + backward times."""
    import torch.nn.functional as F

    from gisnav_tpu_torch.features.conv import (
        conv_stage,
        conv_stage_plain,
        stem_stage,
        stem_stage_plain,
    )
    from gisnav_tpu_torch.matching.attention import (
        MaskedAttention,
        masked_attention,
        masked_attention_plain,
    )
    from gisnav_tpu_torch.matching.lightglue_fused import (
        fused_block,
        fused_block_plain,
    )

    bf16 = torch.bfloat16
    out: dict = {}
    # K5. tolerance: the forward as check_attention (1e-2 of the largest
    # |output|); 3e-2 of the largest |gradient|. The analytic backward
    # recomputes the weights in f32 from the unrounded q and k (as the JAX
    # package's does), the plain version's autograd from the bf16-rounded
    # ones through the bf16-rounded probabilities: ~1 % apart on the CPU
    b, heads, d = TRAIN_BATCH, 4, 64
    worst = 0.0
    for kq, kk in K5_TRAIN_SHAPES:
        for cross in (False, True):
            # the self block's q and k are f32 after the rotary encoding,
            # the cross block's bf16; v is bf16 in both
            qk_dtype = bf16 if cross else torch.float32
            q = _rand(gen, (b, kq, heads, d), 1.0, qk_dtype)
            k = _rand(gen, (b, kk, heads, d), 1.0, qk_dtype)
            v = _rand(gen, (b, kk, heads, d), 1.0, bf16)
            mask = torch.rand((b, kk), generator=gen, device="cuda") > 1 / 3
            g = _rand(gen, (b, kq, heads, d))
            e, _, o = _grad_check(
                f"masked_attention B={b} Kq={kq} Kk={kk} "
                f"{'cross' if cross else 'self'}",
                lambda q_, k_, v_: MaskedAttention.apply(q_, k_, v_, mask),
                lambda q_, k_, v_: masked_attention_plain(q_, k_, v_, mask),
                (q, k, v), g, 3e-2, 1e-2)
            worst = max(worst, e)
            single = torch.stack([masked_attention(q[i], k[i], v[i], mask[i])
                                  for i in range(b)])
            if not torch.equal(single, o):
                raise RuntimeError(f"masked_attention pair axis Kq={kq} "
                                   f"Kk={kk}: not bit-equal to {b} calls")
    log(f"[grad] masked_attention pair axis: bit-equal to {b} single calls "
        f"at {len(K5_TRAIN_SHAPES) * 2} shapes")
    out["masked_attention"] = {"grad_max_rel_err": worst}
    if not quick:
        # one call of the step (B = 8 pairs, 256 x 256, the self block's
        # dtypes) forward + backward, against SDPA on bf16 with the same
        # additive bias, forward + backward
        q = _rand(gen, (b, 256, heads, d))
        k = _rand(gen, (b, 256, heads, d))
        v = _rand(gen, (b, 256, heads, d), 1.0, bf16)
        mask = torch.rand((b, 256), generator=gen, device="cuda") > 1 / 3
        g = _rand(gen, (b, 256, heads, d))
        fwd, both = _fwd_bwd_ms(
            lambda q_, k_, v_: MaskedAttention.apply(q_, k_, v_, mask),
            (q, k, v), g)
        bias = torch.where(mask, 0.0, -1e9).to(bf16)[:, None, None, :]
        lib_fwd, lib_both = _fwd_bwd_ms(
            lambda q_, k_, v_: F.scaled_dot_product_attention(
                q_, k_, v_, attn_mask=bias),
            tuple(t.to(bf16).transpose(1, 2) for t in (q, k, v)),
            g.to(bf16).transpose(1, 2))
        out["masked_attention"].update(
            backward_ms=both - fwd, library_backward_ms=lib_both - lib_fwd)
        # device time (torch.profiler) of forward + backward, both sides
        for key, f, ins, gg in (
                ("fwd_bwd_device_ms",
                 lambda q_, k_, v_: MaskedAttention.apply(q_, k_, v_, mask),
                 (q, k, v), g),
                ("library_fwd_bwd_device_ms",
                 lambda q_, k_, v_: F.scaled_dot_product_attention(
                     q_, k_, v_, attn_mask=bias),
                 tuple(t.to(bf16).transpose(1, 2) for t in (q, k, v)),
                 g.to(bf16).transpose(1, 2))):
            leaves = [t.detach().clone().requires_grad_() for t in ins]
            out["masked_attention"][key] = device_ms(
                lambda f=f, leaves=leaves, gg=gg: f(*leaves).backward(gg))
        log("[time] masked_attention B={} 256x256 forward+backward device "
            "{fwd_bwd_device_ms:.4f} ms, SDPA {library_fwd_bwd_device_ms:.4f}"
            " ms".format(b, **out["masked_attention"]))
        log(f"[time] masked_attention B={b} 256x256: forward {fwd:.4f} ms, "
            f"forward+backward {both:.4f} ms; SDPA forward {lib_fwd:.4f} "
            f"ms, forward+backward {lib_both:.4f} ms")

    # K1, K2, K4: the backward is the plain version's vjp, so the Function
    # and autograd of the plain version run the same operations; cuDNN may
    # pick other algorithms for the two, and a bf16 gradient can then round
    # one ulp (2^-8) apart (tolerance 1e-2 of the largest |gradient|); the
    # forwards, bf16 (K1, K2) or with bf16 rounding points (K4), within
    # 2e-2 of the largest |output| (a sum in another order rounds one ulp).
    # The card's gradient also against the CPU's autograd of the plain
    # version (the arithmetic the CPU tests hold against the JAX package's
    # gradient): 2e-2 of the gradient's norm, as a value that rounds one bf16
    # ulp apart before a relu or a pool can move a whole element's gradient
    w1a, b1a = _conv_weights(gen, 1, 64)
    w1b, b1b = _conv_weights(gen, 64, 64)
    w2a, b2a = _conv_weights(gen, 64, 64)
    w2b, b2b = _conv_weights(gen, 64, 64)
    img = torch.rand((480, 640), generator=gen, device="cuda")
    x2 = torch.relu(_rand(gen, (240, 320, 64))).to(bf16)
    xb, qb, kb, vb, biasb, wb = _block_inputs(gen, 1024, 1024, 2)
    cases = {
        "stem_stage": (lambda *a: stem_stage(*a, pool=True),
                       lambda *a: stem_stage_plain(*a, pool=True),
                       (img, w1a, b1a, w1b, b1b), (240, 320, 64)),
        "conv_stage": (lambda *a: conv_stage(*a, pool=True),
                       lambda *a: conv_stage_plain(*a, pool=True),
                       (x2, w2a, b2a, w2b, b2b), (120, 160, 64)),
        "fused_block": (lambda *a: fused_block(*a, heads=4, sets=2),
                        lambda *a: fused_block_plain(*a, heads=4, sets=2),
                        (xb, qb, kb, vb, biasb, *wb), (1024, 256)),
    }
    for name, (fn, plain, inputs, oshape) in cases.items():
        g = _rand(gen, oshape)
        e, e_cpu, _ = _grad_check(f"{name} (path 4 shape)", fn, plain,
                                  inputs, g, 1e-2, 2e-2, cpu_tol=2e-2)
        out[name] = {"grad_max_rel_err": e, "grad_cpu_rel_err": e_cpu}
        if not quick:
            fwd, both = _fwd_bwd_ms(fn, inputs, g)
            out[name]["backward_ms"] = both - fwd
            log(f"[time] {name}: forward {fwd:.4f} ms, forward+backward "
                f"{both:.4f} ms")
    for r in results:
        r.update(out.get(r["name"], {}))
    return out


class _TrainLog(logging.Handler):
    """Collects the training loop's chunk records with their host time."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.rows: list = []

    def emit(self, record):
        self.rows.append((time.perf_counter(), record.args))


def _train_logged(fn):
    """Run ``fn()`` with the loop's chunk records captured: (result, rows
    of (seconds since the start, step, loss, metric))."""
    logger = logging.getLogger("gisnav_tpu_torch.train")
    handler = _TrainLog()
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    t0 = time.perf_counter()
    try:
        result = fn()
    finally:
        logger.removeHandler(handler)
    rows = [(t - t0, a[0], float(a[1]), float(a[3])) for t, a in handler.rows]
    bad = [r for r in rows if not np.isfinite(r[2])]
    if not rows or bad:
        raise RuntimeError(f"training: no chunk logged or a loss not "
                           f"finite: {rows}")
    return result, rows


def _train_step_split(state, step_fn, batch, steps: int = 5) -> dict:
    """Host-clock medians of one step's synchronised phases (forward and
    loss, backward, optimizer) on one batch; the state's params move on, as
    training does."""
    loss_fn = step_fn.loss_fn
    opt = state.opt_state
    parts = {"forward_ms": [], "backward_ms": [], "optimizer_ms": []}
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = loss_fn(state.params, *batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(dt * 1e3)
    return {k: float(np.median(v)) for k, v in parts.items()}


def _chunks_vs_eager(tag: str, make_state, make_chunk, batch_fns,
                     chunks: int = 3, deterministic: bool = False,
                     traced_steps: int = 2) -> dict:
    """A device-data chunk, graphed against eager: two states from one
    init (``make_state()``) and two generators from one seed; ``chunks``
    graphed chunks (the first the side-stream warm-up, then replays) and
    as many eager ones (``.eager``) give the same losses (1e-5 relative),
    each replay draws the pairs the eager chunk draws (read from the
    graph's own memory), successive replays draw different pairs, and the
    generators end in one state. Steps/s: the replays' and the eager
    chunks', each chunk ending in the host's one read of its loss; then
    one more replay traced, and an eager chunk of ``traced_steps`` steps
    (``make_chunk(steps)``; tracing ten eager steps took 40-46 s of the
    host): device busy ms a step and idle share. Returns the summary and
    the eager side's trace.
    ``deterministic`` runs both sides with PyTorch's deterministic
    algorithms (a chunk whose backward accumulates with atomics parts from
    itself between two eager runs)."""
    from gisnav_tpu_torch.train import device_data
    from gisnav_tpu_torch.train.loop import CHUNK

    seen: list = []
    originals = {name: getattr(device_data, name) for name in batch_fns}

    def tapped(fn):
        def draw(*a, **kw):
            pairs = fn(*a, **kw)
            seen.append(pairs[0][0, :8, :8])
            return pairs
        return draw

    for name, fn in originals.items():
        setattr(device_data, name, tapped(fn))
    try:
        chunk_fn = make_chunk(CHUNK)
    finally:
        for name, fn in originals.items():
            setattr(device_data, name, fn)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic or was, warn_only=True)
    spent = {"start": time.perf_counter()}  # host s of each stage, logged
    try:
        (g_state, _), (e_state, _) = make_state(), make_state()
        spent["states"] = time.perf_counter()
        gens = [torch.Generator(device=TRAIN_DEVICE) for _ in range(2)]
        for g in gens:
            g.manual_seed(TRAIN_STEPS)
        losses, drawn, g_s, e_s = [], [], [], []
        for i in range(chunks):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, gm = chunk_fn(g_state, gens[0])
            g_loss = float(gm["loss"])  # the host's one read a chunk
            t1 = time.perf_counter()
            if i == 0:
                tap = seen[-1]  # the capture's pairs: the graph's memory
                spent["first graphed chunk"] = t1 - t
            else:
                g_s.append(t1 - t)
            replayed = tap.clone()
            t = time.perf_counter()
            _, em = chunk_fn.eager(e_state, gens[1])
            losses.append((g_loss, float(em["loss"])))
            e_s.append(time.perf_counter() - t)
            if i and not torch.allclose(replayed, seen[-1], rtol=0,
                                        atol=1e-6):
                raise RuntimeError(f"{tag}: replay {i} drew other pairs "
                                   f"than the eager chunk")
            if i:
                drawn.append(replayed)
        spent["chunks"] = time.perf_counter()
    finally:
        torch.use_deterministic_algorithms(was)
    if not all(abs(g - e) <= 1e-5 * abs(e) for g, e in losses):
        raise RuntimeError(f"{tag}: graphed chunk losses {losses} (graphed, "
                           f"eager) differ")
    if any(torch.equal(a, b) for a, b in zip(drawn, drawn[1:])):
        raise RuntimeError(f"{tag}: two replays drew the same pairs")
    if not torch.equal(gens[0].get_state(), gens[1].get_state()):
        raise RuntimeError(f"{tag}: the generators part")
    (graph,) = chunk_fn.graphs.values()
    out = {"chunks_compared": chunks, "deterministic": deterministic,
           "losses_graphed_eager": losses,
           "graphed_steps_per_s": len(g_s) * CHUNK / sum(g_s),
           "eager_steps_per_s": len(e_s) * CHUNK / sum(e_s),
           "capture_ms": graph.capture_ms,
           "graph_pool_mib": graph.pool_bytes / 2 ** 20,
           "launches_a_replay": graph.launches}
    # one more chunk of each side traced: the device's busy time a step
    _, out["graphed_busy_ms"] = _traced_chunk(chunk_fn, g_state, gens[0])
    spent["graphed trace"] = time.perf_counter()
    prof, out["eager_busy_ms"] = _traced_chunk(
        make_chunk(traced_steps).eager, e_state, gens[1], traced_steps)
    out["eager_traced_steps"] = traced_steps
    spent["eager trace"] = time.perf_counter()
    for side in ("graphed", "eager"):
        out[f"{side}_idle_share"] = 1.0 - out[f"{side}_busy_ms"] * out[
            f"{side}_steps_per_s"] / 1e3
    log(f"[{tag} graph vs eager] " + json.dumps(out))
    first = spent.pop("first graphed chunk")
    marks = list(spent.items())
    log(f"[{tag} graph vs eager] host s: " + ", ".join(
        f"{name} {b - a:.1f}" for (_, a), (name, b) in zip(marks, marks[1:]))
        + f" (the first graphed chunk {first:.1f})")
    return out, prof


def _traced_chunk(fn, state, gen, steps: int = 0) -> tuple:
    """One chunk of ``steps`` steps (0: ``CHUNK``) under torch.profiler:
    (the profile, device busy ms a step)."""
    from torch.profiler import ProfilerActivity, profile

    from gisnav_tpu_torch.train.loop import CHUNK

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, m = fn(state, gen)
        float(m["loss"])
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if _on_device(e))
    return prof, busy / (steps or CHUNK) / 1e3


def _train_chunk_profile(config, params) -> dict:
    """``train()``'s own chunk (``make_device_train_chunk`` with the
    device generator, the curriculum at the step the run reached), from
    ``params`` with a fresh optimizer, graphed against eager
    (``_chunks_vs_eager``); under the eager side's traced chunk the device
    time of the pair generation (``device_batch``) and of K5's backward
    (``MaskedAttentionBackward``), each with every kernel under it, a step
    (a replay runs no host code to label)."""
    from torch import nn

    from gisnav_tpu_torch.train import device_data
    from gisnav_tpu_torch.train.steps import (
        AdamW,
        TrainState,
        _map_tree,
        make_device_train_chunk,
    )

    tx = AdamW(config.learning_rate, weight_decay=config.weight_decay)

    def make_state():
        p = _map_tree(lambda t: nn.Parameter(t.detach().clone()), params)
        return TrainState(p, tx.init(p), torch.tensor(
            TRAIN_STEPS, dtype=torch.int64, device=TRAIN_DEVICE)), tx

    make_pairs = device_data.device_batch

    def labelled_pairs(*args, **kw):  # the trace's span of pair generation
        with torch.profiler.record_function("device_batch"):
            return make_pairs(*args, **kw)

    device_data.device_batch = labelled_pairs
    try:
        vs, prof = _chunks_vs_eager(
            "train", make_state, lambda steps: make_device_train_chunk(
                config, tx, TRAIN_BATCH, chunk=steps), ["device_batch"],
            traced_steps=TRACED_STEPS)
    finally:
        device_data.device_batch = make_pairs
    k5_bwd = [e for e in prof.events() if e.name == "MaskedAttentionBackward"]
    if len(k5_bwd) != 4 * TRAIN_DEPTH * TRACED_STEPS:
        raise RuntimeError(f"train profile: {len(k5_bwd)} K5 backward "
                           f"calls in {TRACED_STEPS} steps, expected "
                           f"{4 * TRAIN_DEPTH * TRACED_STEPS}")
    pairs = [e for e in prof.events() if e.name == "device_batch"
             and e.device_type == torch.autograd.DeviceType.CPU]
    out = {"chunk_step_ms": 1e3 / vs["graphed_steps_per_s"],
           "eager_chunk_step_ms": 1e3 / vs["eager_steps_per_s"],
           "device_busy_ms": vs["graphed_busy_ms"],
           "eager_device_busy_ms": vs["eager_busy_ms"],
           "device_idle_share": vs["graphed_idle_share"],
           "eager_device_idle_share": vs["eager_idle_share"],
           "k5_backward_device_ms": sum(_kernel_us(e) for e in k5_bwd)
           / TRACED_STEPS / 1e3,
           "pairs_device_ms": sum(_kernel_us(e) for e in pairs)
           / TRACED_STEPS / 1e3, "graph": vs}
    if not out["k5_backward_device_ms"] > 0:
        raise RuntimeError("train profile: no device time under K5's "
                           "backward")
    log("[train] train()'s chunk: graphed {chunk_step_ms:.3f} ms a step, "
        "device busy {device_busy_ms:.3f} ms (idle {device_idle_share:.3f});"
        " eager {eager_chunk_step_ms:.3f} ms, busy {eager_device_busy_ms:.3f}"
        " (idle {eager_device_idle_share:.3f}), of it pair generation "
        "{pairs_device_ms:.3f} ms and K5's backward "
        "{k5_backward_device_ms:.3f} ms a step".format(**out))
    return out


def loftr_chunks_vs_eager() -> dict:
    """Path 9 (c): the LoFTR chunk (``train --model loftr``'s config, at
    ``LOFTR_PAIRS`` pairs a step: its pairs run one after another, so the
    eager side costs a second a pair and chunk) graphed against eager, as
    ``_chunks_vs_eager`` holds it."""
    from gisnav_tpu_torch.train.loftr_steps import (
        LoFTRTrainConfig,
        init_loftr_train_state,
        make_loftr_device_train_chunk,
    )
    from gisnav_tpu_torch.train.steps import AdamW

    config = LoFTRTrainConfig()
    tx = AdamW(config.learning_rate, weight_decay=config.weight_decay)
    # deterministic: the backward of LoFTR's overlapping 5x5 fine windows
    # (advanced indexing) accumulates with atomics, and two eager runs of
    # three chunks from one state part by up to 0.9 % of the loss; with
    # PyTorch's deterministic algorithms both sides give the same bits
    return _chunks_vs_eager(
        "train loftr", lambda: init_loftr_train_state(
            torch.Generator().manual_seed(0), config, TRAIN_DEVICE),
        lambda steps: make_loftr_device_train_chunk(config, tx, LOFTR_PAIRS,
                                                    chunk=steps),
        ["device_batch"], deterministic=True, traced_steps=TRACED_STEPS)[0]


def _named_leaves(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _named_leaves(tree[key], f"{prefix}/{key}")
                .items()}
    return {prefix: tree}


def _card_vs_cpu_step(config, params) -> dict:
    """One step's loss, gt_recall and every parameter's gradient on the
    card and on the CPU, from ``params`` and one host batch at the config's
    shape; each gradient's difference as the norm of card minus CPU over
    the CPU's norm, a leaf and overall."""
    from gisnav_tpu_torch.train.data import make_homography_batch
    from gisnav_tpu_torch.train.steps import AdamW, _map_tree, make_train_step

    batch = make_homography_batch(np.random.default_rng(0), TRAIN_BATCH,
                                  config.image_shape)
    loss_fn = make_train_step(config, AdamW(config.learning_rate)).loss_fn
    metrics, leaves = {}, {}
    for dev in (TRAIN_DEVICE, "cpu"):
        tree = _map_tree(
            lambda t: t.detach().to(dev).clone().requires_grad_(), params)
        loss, recall = loss_fn(tree, *(torch.as_tensor(a, device=dev)
                                       for a in batch))
        loss.backward()
        metrics[dev] = {"loss": loss.item(), "gt_recall": recall.item()}
        leaves[dev] = {k: v.grad.cpu().double() for k, v in
                       _named_leaves(tree).items() if v.grad is not None}
    card, cpu = leaves[TRAIN_DEVICE], leaves["cpu"]
    errs = {k: float(torch.linalg.vector_norm(card[k] - g)
                     / (torch.linalg.vector_norm(g) + 1e-12))
            for k, g in cpu.items()}
    worst = max(errs, key=errs.get)
    overall = torch.sqrt(sum(torch.linalg.vector_norm(card[k] - g) ** 2
                             for k, g in cpu.items())
                         / sum(torch.linalg.vector_norm(g) ** 2
                               for g in cpu.values()))
    return {"metrics": metrics, "worst_leaf": worst,
            "worst_leaf_rel_err": errs[worst],
            "overall_rel_err": float(overall)}


def train_cli_defaults() -> dict:
    """Path 9 (a): ``train`` at the CLI defaults from random init."""
    import tempfile

    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.train import checkpoint
    from gisnav_tpu_torch.train.data import make_homography_batch
    from gisnav_tpu_torch.train.loop import CHUNK, train
    from gisnav_tpu_torch.train.steps import (
        TrainConfig,
        init_train_state,
        make_train_step,
        tree_leaves,
    )

    config = TrainConfig()
    if config.lightglue_depth != TRAIN_DEPTH:
        raise RuntimeError("TrainConfig's depth moved: update TRAIN_DEPTH")
    reset_launches()
    params, rows = _train_logged(lambda: train(
        steps=TRAIN_STEPS, batch_size=TRAIN_BATCH, config=config,
        device=TRAIN_DEVICE))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    expect_launches("train", launches,
                    {"masked_attention": TRAIN_K5_STEP * TRAIN_STEPS})
    ends = [0.0] + [r[0] for r in rows]
    per_step = [(b - a) * 1e3 / CHUNK for a, b in zip(ends, ends[1:])]
    per_step = per_step[1:] or per_step  # the first chunk warms up
    out = {"steps": rows[-1][1], "steps_per_s": rows[-1][1] / rows[-1][0],
           "first_chunk_s": rows[0][0],
           "step_p50_ms": float(np.percentile(per_step, 50)),
           "step_p90_ms": float(np.percentile(per_step, 90)),
           "loss_first_chunk": rows[0][2], "loss_last_chunk": rows[-1][2],
           "gt_recall_last_chunk": rows[-1][3], "launches": launches}
    log(f"[train] {TRAIN_STEPS} steps: " + ", ".join(
        f"step {s} loss {lo:.4f} gt_recall {r:.3f}" for _, s, lo, r in rows))

    # one step on the card and on the CPU from the params the run left (a
    # trained matcher, far from random init's near-uniform scores) and one
    # host batch: loss within 2e-3 relative and gt_recall within 0.03 (the
    # card's cuDNN convs and the CPU's round sums in other orders; the
    # learned detector's soft-argmax positions read those logits at
    # temperature 0.1, so keypoints move and a mutual argmax may flip).
    # Its gradients are printed, not held: the moved keypoints move them
    learned = _card_vs_cpu_step(config, params)
    card, cpu = learned["metrics"][TRAIN_DEVICE], learned["metrics"]["cpu"]
    log("[train] one step from the trained params, card {} CPU {}; gradient "
        "(not held): worst leaf {worst_leaf} {worst_leaf_rel_err:.4f} of its "
        "norm, overall {overall_rel_err:.4f}".format(card, cpu, **learned))
    if not (abs(card["loss"] - cpu["loss"]) <= 2e-3 * abs(cpu["loss"])
            and abs(card["gt_recall"] - cpu["gt_recall"]) <= 0.03):
        raise RuntimeError("train: the card's step disagrees with the CPU's")
    if not cpu["gt_recall"] >= 0.3:
        raise RuntimeError(f"train: gt_recall {cpu['gt_recall']:.3f} after "
                           f"{TRAIN_STEPS} steps; the card-vs-CPU check "
                           f"needs a trained matcher")
    # every parameter's gradient of one step, card against CPU, where the
    # keypoints are the Harris detector's (the harris_lg5 bundle at the
    # CLI's shapes). Tolerance: each leaf within 5 % of its norm,
    # as tests/test_torch_train_steps.py holds the CPU step against the
    # JAX package's (bf16 convs and casts round sums in other orders); the
    # loss and gt_recall as above
    from gisnav_tpu_torch.train.steps import master_params
    from gisnav_tpu_torch.weights import load_bundled

    harris = _card_vs_cpu_step(
        dataclasses.replace(config, detector_mode="harris",
                            lightglue_depth=5),
        master_params(load_bundled("harris_lg5")[0], "cpu"))
    log("[train] one step of harris_lg5, card {} CPU {}; gradient: worst "
        "leaf {worst_leaf} {worst_leaf_rel_err:.4f} of its norm, overall "
        "{overall_rel_err:.4f}".format(harris["metrics"][TRAIN_DEVICE],
                                       harris["metrics"]["cpu"], **harris))
    card, cpu = harris["metrics"][TRAIN_DEVICE], harris["metrics"]["cpu"]
    if not (harris["worst_leaf_rel_err"] <= 0.05
            and abs(card["loss"] - cpu["loss"]) <= 2e-3 * abs(cpu["loss"])
            and abs(card["gt_recall"] - cpu["gt_recall"]) <= 0.03):
        raise RuntimeError("train: the card's harris_lg5 step disagrees "
                           "with the CPU's")
    out["card_vs_cpu"] = {"learned": learned, "harris_lg5": harris}
    out.update(_train_chunk_profile(config, params))

    # 8 steps on one fixed batch lower its loss (the JAX package's gate)
    batch = make_homography_batch(np.random.default_rng(0), TRAIN_BATCH,
                                  config.image_shape)
    state, tx = init_train_state(torch.Generator().manual_seed(1), config,
                                 TRAIN_DEVICE)
    step_fn = make_train_step(config, tx)
    dbatch = tuple(torch.as_tensor(a, device=TRAIN_DEVICE) for a in batch)
    losses = []
    for _ in range(8):
        state, m = step_fn(state, *dbatch)
        losses.append(float(m["loss"]))
    log(f"[train] fixed batch, 8 steps: losses {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError("train: 8 steps on a fixed batch did not lower "
                           "its loss")
    out["fixed_batch_losses"] = losses
    out["fixed_batch_phases"] = _train_step_split(state, step_fn, dbatch)

    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_params(tmp, TRAIN_STEPS, params)
        back = checkpoint.load_params(tmp, like=params)
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(back))):
        raise RuntimeError("train: checkpoint restore is not bit-equal")
    out["checkpoint_bit_equal"] = True
    return out


def train_finetune_bundle() -> dict:
    """Path 9 (b): ``python -m gisnav_tpu_torch train --init-weights
    harris_lg5 --regime cached ... --out``, the written bundle loaded as
    ``run --weights`` loads it and flown on path 4's scene."""
    import tempfile

    from gisnav_tpu_torch.cli import main as cli_main
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.runners import make_cached_deep_runner
    from gisnav_tpu_torch.utils.world import render_scene
    from gisnav_tpu_torch.weights import infer_config_from_params, load_npz

    # tools/finetune_bundle.py's cached regime (the bundle's depth and
    # detector, lr 5e-5, seed 7) at full difficulty from the first step:
    # the bundle is converged on the full task, and the tool's 600-step
    # ramp spends these 20 steps near +-30 deg, after 10 of which the JAX
    # package's own trainer, as the port's, leaves a yaw of path 4's scene
    # invalid or over 10 m off (tools/finetune_ramp_jax.py and
    # tools/finetune_ramp_check.py)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/tuned_harris_lg5.npz"
        reset_launches()
        rc, rows = _train_logged(lambda: cli_main(
            ["train", "--init-weights", "harris_lg5", "--regime", "cached",
             "--lr", "5e-5", "--curriculum", "0", "--seed", "7",
             "--steps", str(FINETUNE_STEPS), "--batch", str(TRAIN_BATCH),
             "--out", path]))
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"train --init-weights exited {rc}")
        launches = dict(LAUNCHES)
        expect_launches("finetune", launches, {
            "masked_attention": FINETUNE_K5_STEP * FINETUNE_STEPS})
        wparams = load_npz(path)
    out = {"launches": launches, "steps_per_s": rows[-1][1] / rows[-1][0],
           "losses": [r[2] for r in rows], "gt_recall": [r[3] for r in rows]}
    runner = make_cached_deep_runner(
        wparams, infer_config_from_params(wparams), device=TRAIN_DEVICE)
    scene = render_scene(**HARRIS_SCENE)
    out["fix_errors_m"] = [fly(runner, scene, i, f"[finetune] frame {i}")[1]
                           for i in range(len(HARRIS_YAWS))]
    log("[train finetune] " + json.dumps(out))
    return out


def train_loftr_cli() -> dict:
    """Path 9 (c): ``python -m gisnav_tpu_torch train --model loftr`` at
    its defaults, no kernel of the port launching."""
    from gisnav_tpu_torch.cli import main as cli_main
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    t = time.perf_counter()
    rc, rows = _train_logged(lambda: cli_main(
        ["train", "--model", "loftr", "--steps", str(LOFTR_STEPS)]))
    torch.cuda.synchronize()
    log(f"[train loftr] the CLI's {LOFTR_STEPS} steps in "
        f"{time.perf_counter() - t:.1f} s")
    if rc != 0:
        raise RuntimeError(f"train --model loftr exited {rc}")
    expect_launches("train loftr", dict(LAUNCHES), {})
    out = {"steps_per_s": rows[-1][1] / rows[-1][0],
           "losses": [r[2] for r in rows], "coarse_acc": rows[-1][3]}
    out["graph"] = loftr_chunks_vs_eager()
    log("[train loftr] " + json.dumps(out))
    return out


def phase_train_path() -> dict:
    """Path 9: training on the card, (a) ``train`` at the CLI defaults, (b)
    the bundle fine-tune served by the cached runner, (c) LoFTR training."""
    t0 = time.time()
    out = {"cli": train_cli_defaults()}
    log("[train cli] " + json.dumps(out["cli"]))
    log(f"[train] (a) done in {time.time() - t0:.1f} s")
    out["finetune"] = train_finetune_bundle()
    log(f"[train] (b) done in {time.time() - t0:.1f} s")
    out["loftr"] = train_loftr_cli()
    log(f"[train] (c) done in {time.time() - t0:.1f} s")
    return out


def profile_frames(run_frame, frames, n: int = 10,
                   union: bool = False) -> float:
    """Device time by kernel over ``n`` frames (torch.profiler);
    returns the device's busy ms per frame: the kernels' and copies'
    summed durations, or with ``union`` the span of the union of their
    intervals (where branches of one graph overlap, the sum counts the
    overlap twice)."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        for i in range(n):
            run_frame(frames[i % len(frames)])
        torch.cuda.synchronize()

    run()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    # device-side rows only (kernels and copies), so no time counts twice
    dev = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
           if _on_device(e) and e.self_device_time_total > 0]
    busy = sum(d for _, d, _ in dev) / n
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if _on_device(e)
                   and e.time_range.end > e.time_range.start)
    covered, end = 0.0, -np.inf
    for a, b in spans:
        covered += max(0.0, b - max(a, end))
        end = max(end, b)
    covered_ms = covered / 1e3 / n
    log(f"[profile] device busy {busy:.3f} ms/frame over {n} frames "
        f"(union of intervals {covered_ms:.3f}); the profiled wall "
        f"({wall_ms / n:.1f} ms/frame) carries the "
        f"tracer's own cost, so the idle share is taken against the "
        f"unprofiled frame p50 of this run")
    for key, d, count in sorted(dev, key=lambda x: -x[1])[:20]:
        log(f"[profile] {d / n:9.3f} ms/frame {count // n:6d} calls/frame "
            f"{key[:90]}")
    return covered_ms if union else busy


def _frame(runner, scene, i: int, tag: str = "", **kw):
    """One frame of ``scene`` through ``runner``, logged under ``tag`` if
    given: (pose, ms on the host clock around the synchronised frame,
    horizontal error in m, f64 fix)."""
    from gisnav_tpu_torch.geometry.crs import haversine_m
    from gisnav_tpu_torch.pipeline.geopose import geopose_to_wgs84_f64

    yaw, (lon, lat) = scene.yaws[i], scene.truth_lonlat[i]
    t = time.perf_counter()
    pose = runner(scene.frames[i], scene.ortho, scene.dem, yaw, scene.k,
                  scene.crs_affine, map_stamp=1, altitude_agl=scene.alt_m,
                  **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    fix = geopose_to_wgs84_f64(pose, scene.crs_affine)
    err = haversine_m(lat, lon, fix["lat"], fix["lon"])
    if tag:
        log(f"{tag} yaw {yaw:6.1f}: {ms:8.2f} ms valid={bool(pose.valid)} "
            f"matches={int(pose.num_matches)} "
            f"inliers={int(pose.num_inliers)} error={err:.3f} m")
    return pose, ms, err, fix


def _gate(pose, err: float, fix: dict, what: str) -> None:
    """Raise unless the fix is valid, finite and within 10 m."""
    if not (bool(pose.valid) and err < 10.0
            and np.isfinite(fix["alt_ellipsoid"])):
        raise RuntimeError(f"{what}: fix invalid or {err:.2f} m off")


def fly(runner, scene, i: int, tag: str = "", **kw):
    """One frame of ``scene`` through ``runner``: (ms on the host clock
    around a synchronised frame, error in metres); raises unless the fix is
    valid, finite and within 10 m of the truth."""
    pose, ms, err, fix = _frame(runner, scene, i, tag, **kw)
    _gate(pose, err, fix, f"{tag or f'frame {i}'} (yaw {scene.yaws[i]})")
    return ms, err


def expect_launches(path: str, launches: dict, expected: dict) -> None:
    """Fail unless ``launches`` holds exactly ``expected`` for its keys and
    nothing for every other kernel."""
    want = {k: expected.get(k, 0) for k in launches}
    if launches != want:
        raise RuntimeError(f"{path}: launches {launches}, expected {want}")


def phase_cached_path(params, config, profile_run: bool = False) -> dict:
    """Path 2: the cached-reference runner on a MAP x MAP orthoimage."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.runners import make_cached_deep_runner
    from gisnav_tpu_torch.utils.world import render_scene

    t0 = time.time()
    scene = render_scene(seed=1, h=H, w=W, yaws=CACHED_YAWS, map_side=MAP,
                         coverage=CACHED_COVERAGE)
    log(f"[cached] scene {scene.ortho.shape} in {time.time() - t0:.1f} s")
    out = {}
    for name, kp, frames in (("fused", MAX_KP, len(CACHED_YAWS)),
                             ("module", MODULE_KP, 4)):
        cfg = dataclasses.replace(config, max_keypoints=kp)
        runner = make_cached_deep_runner(params, cfg)
        # the first frame extracts the map; run it twice untimed (kernel
        # loading, allocator), then time one extraction on a new map stamp
        fly(runner, scene, 0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        runner(scene.frames[0], scene.ortho, scene.dem, scene.yaws[0],
               scene.k, scene.crs_affine, map_stamp=2,
               altitude_agl=scene.alt_m)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t) * 1e3
        reset_launches()
        runner(scene.frames[0], scene.ortho, scene.dem, scene.yaws[0],
               scene.k, scene.crs_affine, map_stamp=1,
               altitude_agl=scene.alt_m)
        extract_launches = dict(LAUNCHES)
        reset_launches()
        rows = [fly(runner, scene, i, f"[cached {name}] frame {i}")
                for i in range(frames)]
        launches = dict(LAUNCHES)
        ms = [r[0] for r in rows]
        # the extraction frame also ran one query frame
        per_frame = {k: n // frames for k, n in launches.items()}
        extract_only = {k: extract_launches[k] - per_frame[k]
                        for k in launches}
        log(f"[cached {name}] launches over {frames} frames: {launches}; "
            f"map extraction alone: {extract_only}")
        # query SuperPoint: stem 1, stages 8, select 1; LightGlue-9: 36
        # block calls of 2 launches (fused) or 36 attention calls of 2
        # launches (row statistics, then P.V)
        block = {"fused": {"fused_block": 72 * frames},
                 "module": {"masked_attention": 72 * frames}}[name]
        expect_launches(f"cached {name}", launches,
                        {"stem_stage": frames, "conv_stage": 8 * frames,
                         "nms_select": frames, **block})
        expect_launches(f"cached {name} extraction", extract_only,
                        {"stem_stage": 1, "conv_stage": 8})
        if runner.stats != {"frames": frames + 3, "map_extractions": 3}:
            raise RuntimeError(f"cached {name}: stats {runner.stats}")
        p50 = float(np.median(ms))
        out[name] = {
            "keypoints": kp, "frames": frames, "frame_p50_ms": p50,
            "frame_p90_ms": float(np.percentile(ms, 90)),
            "map_extraction_ms": first_ms - p50,
            "max_error_m": float(max(r[1] for r in rows)),
            "mean_error_m": float(np.mean([r[1] for r in rows])),
            "launches": launches}
        if profile_run:
            busy = profile_frames(lambda i: fly(runner, scene, i),
                                  list(range(frames)))
            out[name]["device_busy_ms"] = busy
            out[name]["device_idle_share"] = 1.0 - busy / p50
        if name == "fused":
            out["extraction"] = extraction_vs_eager(runner, cfg, scene)
            out["options"] = cached_options(params, cfg, scene, runner)
    log("[cached] " + json.dumps(out))
    return out


def extraction_vs_eager(runner, cfg, scene, reps: int = 5) -> dict:
    """Path 2's map extraction, graphed against eager: the runner's
    extraction graph replayed on the map and the reference extractor run
    eagerly on it (keypoints, descriptors and mask identical); ms p50 /
    p90, device busy ms and idle share each."""
    from gisnav_tpu_torch.pipeline.geopose import build_reference_extractor

    o = torch.from_numpy(scene.ortho)
    graph = runner.graphs[("extract", tuple(o.shape), o.dtype)]
    extract = build_reference_extractor(cfg)
    sides = {"graphed": lambda _: graph(o),
             "eager": lambda _: extract(runner.models,
                                        o.cuda().float() / 255.0)}
    ms = {side: [] for side in sides}
    for _ in range(reps):
        outs = []
        for side, run in sides.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            outs.append(run(0))
            torch.cuda.synchronize()
            ms[side].append((time.perf_counter() - t) * 1e3)
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            raise RuntimeError("path 2: the graphed map extraction differs "
                               "from eager")
    out = {"compared": reps}
    for side, run in sides.items():
        p50 = float(np.median(ms[side]))
        busy = profile_frames(run, [0], n=2)
        out.update({f"{side}_p50_ms": p50,
                    f"{side}_p90_ms": float(np.percentile(ms[side], 90)),
                    f"{side}_busy_ms": busy,
                    f"{side}_idle_share": 1.0 - busy / p50})
    log("[cached extraction] " + json.dumps(out))
    return out


def cached_options(params, cfg, scene, runner) -> dict:
    """The cached runner's two options on the card: a position prior (at the
    truth the fix stands; a degree off the map no reference keypoint is
    left, so the frame must come back invalid with no match) and query
    derotation (a runner of its own over ``DEROTATE_FRAMES``)."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.runners import make_cached_deep_runner

    errors = []
    for i in PRIOR_FRAMES:
        lon, lat = scene.truth_lonlat[i]
        errors.append(fly(runner, scene, i, f"[cached prior] frame {i}",
                          prior_lonlat=(lon, lat))[1])
        pose = runner(scene.frames[i], scene.ortho, scene.dem, scene.yaws[i],
                      scene.k, scene.crs_affine, map_stamp=1,
                      altitude_agl=scene.alt_m, prior_lonlat=(lon + 1.0, lat))
        if bool(pose.valid) or int(pose.num_matches) != 0:
            raise RuntimeError(f"cached prior: frame {i} with its prior off "
                               f"the map kept {int(pose.num_matches)} "
                               f"matches, valid={bool(pose.valid)}")
    taps: list = []
    with TappedRansac(taps), GraphSide("graphed", taps=taps):
        derot = make_cached_deep_runner(params, cfg, derotate=True)
        tap_programs(derot.models, taps)
        fly(derot, scene, 0)
        reset_launches()
        rows = [fly(derot, scene, i, f"[cached derotate] frame {i}")
                for i in DEROTATE_FRAMES]
        n = len(rows)
        # the 1088x1920 camera is not square: its derotation is the gather
        # warp
        expect_launches("cached derotate", dict(LAUNCHES),
                        {"stem_stage": n, "conv_stage": 8 * n,
                         "nms_select": n, "fused_block": 72 * n})
        vs = graphed_vs_eager(
            "cached derotate", lambda i: fly(derot, scene, i),
            list(DEROTATE_FRAMES), [r[0] for r in rows], scene.crs_affine,
            taps)
    return {"prior_frames": len(errors), "prior_max_error_m": max(errors),
            "derotate_frames": n,
            "derotate_max_error_m": float(max(r[1] for r in rows)),
            "derotate_frame_p50_ms": float(np.median([r[0] for r in rows])),
            "derotate_graph": vs}


def phase_exact_warp_path(params, config, scene,
                          profile_run: bool = False) -> dict:
    """Path 3: the exact-warp runner on path 1's scene, then the zoom-less
    exact-warp runner (``runners._warp_runner`` with no zoom: the 3-shear
    rotation, a graph a quadrant) on a map at the query's ground sample
    distance; each graphed against eager on its frames."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.geopose import (
        build_frame_to_geopose,
        build_models,
    )
    from gisnav_tpu_torch.pipeline.runners import _warp_runner, make_deep_runner
    from gisnav_tpu_torch.utils.world import render_scene
    from gisnav_tpu_torch.weights import params_from_jax

    frames = 4
    taps: list = []
    with TappedRansac(taps), GraphSide("graphed", taps=taps):
        runner = make_deep_runner(params, config)
        tap_programs(runner.models, taps)
        fly(runner, scene, 0)
        reset_launches()
        rows = [fly(runner, scene, i, f"[exact] frame {i}")
                for i in range(3, 3 + frames)]
        launches = dict(LAUNCHES)
        log(f"[exact] launches over {frames} frames: {launches}")
        # pair SuperPoint (2 x (1 + 8 + 1)), dual LightGlue (18 calls of 2)
        expect_launches("exact warp", launches,
                        {"stem_stage": 2 * frames, "conv_stage": 16 * frames,
                         "nms_select": 2 * frames,
                         "fused_block": 36 * frames})
        ms = [r[0] for r in rows]
        out = {"runner": {"frames": frames,
                          "frame_p50_ms": float(np.median(ms)),
                          "frame_p90_ms": float(np.percentile(ms, 90)),
                          "max_error_m": float(max(r[1] for r in rows)),
                          "launches": launches}}
        out["runner"]["graph"] = graphed_vs_eager(
            "exact", lambda i: fly(runner, scene, i),
            list(range(3, 3 + frames)), ms, scene.crs_affine, taps)

        t0 = time.time()
        zl = render_scene(seed=2, h=H, w=W, yaws=SHEAR_YAWS, map_side=MAP,
                          coverage=MAP / W)
        log(f"[shear] scene {zl.ortho.shape} at the query's GSD in "
            f"{time.time() - t0:.1f} s")
        dev = torch.device("cuda")
        models = build_models(params_from_jax(params, dev), config)
        tap_programs(models, taps)
        zoomless = _warp_runner(build_frame_to_geopose(config), models, dev,
                                config, zoom=False)
        frames = len(SHEAR_YAWS)
        for i in range(frames):  # a graph a quadrant, each captured
            fly(zoomless, zl, i)
        reset_launches()
        rows = [fly(zoomless, zl, i, f"[shear] frame {i}")
                for i in range(frames)]
        ms, errors = [r[0] for r in rows], [r[1] for r in rows]
        launches = dict(LAUNCHES)
        log(f"[shear] launches over {frames} frames: {launches}")
        # the rotation's two x-shears and its y-shear
        expect_launches("zoom-less exact warp", launches,
                        {"shear_last_axis": 2 * frames,
                         "shear_first_axis": frames,
                         "stem_stage": 2 * frames, "conv_stage": 16 * frames,
                         "nms_select": 2 * frames,
                         "fused_block": 36 * frames})
        out["zoomless"] = {"frames": frames,
                           "frame_p50_ms": float(np.median(ms)),
                           "frame_p90_ms": float(np.percentile(ms, 90)),
                           "max_error_m": float(max(errors)),
                           "launches": launches,
                           "graphs": sorted(str(key[-1]) for key in
                                            zoomless.graphs)}
        out["zoomless"]["graph"] = graphed_vs_eager(
            "shear", lambda i: fly(zoomless, zl, i), list(range(frames)),
            ms, zl.crs_affine, taps)
    log("[exact] " + json.dumps(out))
    return out


def _times(rows) -> dict:
    ms = [r[0] for r in rows]
    return {"frames": len(rows), "frame_p50_ms": float(np.median(ms)),
            "frame_p90_ms": float(np.percentile(ms, 90)),
            "max_error_m": float(max(r[1] for r in rows))}


def phase_harris_path(profile_run: bool = False) -> dict:
    """Path 4: the default bundle (``params=None``: harris_lg5 with
    PRETRAINED_CONFIG) through the three deep runners on the JAX 8-yaw
    sweep's sizing, then the cached runner on bench.py's 2048-px map."""
    from gisnav_tpu_torch.pipeline.runners import (
        make_bucketed_warp_runner,
        make_cached_deep_runner,
        make_deep_runner,
    )
    from gisnav_tpu_torch.utils.world import render_scene

    t0 = time.time()
    scene = render_scene(**HARRIS_SCENE)
    log(f"[harris] scene {scene.ortho.shape} in {time.time() - t0:.1f} s")
    # a Harris SuperPoint pass: stem 1, stages 2-4 two convs each and
    # convDa (no detector head), select 1. LightGlue-5: 5 layers of a self
    # and a cross stage, each one dual call (warp modes: 512 / 512) or two
    # one-stream calls (cached: 512 / 1024), 2 launches a call
    sp = {"stem_stage": 1, "conv_stage": 7, "nms_select": 1}
    plans = {
        "cached": (make_cached_deep_runner, list(range(len(HARRIS_YAWS))),
                   {**sp, "fused_block": 40}),
        "bucketed": (make_bucketed_warp_runner, [0, 1, 2, 3],
                     {**sp, "fused_block": 20}),
        "exact": (make_deep_runner, [0, 1, 2, 3],
                  {k: 2 * n for k, n in sp.items()} | {"fused_block": 20}),
    }
    out = {}
    taps: list = []
    with TappedRansac(taps), GraphSide("graphed", taps=taps):
        for name, (make, frames, per_frame) in plans.items():
            out[name] = _harris_runner(name, make(), scene, frames,
                                       per_frame, taps, profile_run)
    out["bench_map"] = harris_bench_map()
    log("[harris] " + json.dumps(out))
    return out


def _harris_runner(name, runner, scene, frames, per_frame, taps,
                   profile_run) -> dict:
    """One of path 4's runners on its frames; the exact warp also graphed
    against eager."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches

    tap_programs(runner.models, taps)
    # untimed: the cached runner extracts the map at its first frame; the
    # bucketed runner fills one bucket a yaw (4 yaws, 4 buckets of 15 deg,
    # a 4-entry cache), so the counted frames all hit
    for i in (frames if name == "bucketed" else frames[:1]):
        fly(runner, scene, i)
    reset_launches()
    rows = [fly(runner, scene, i, f"[harris {name}] frame {i}")
            for i in frames]
    launches = dict(LAUNCHES)
    n = len(frames)
    log(f"[harris {name}] launches over {n} frames: {launches}")
    expect_launches(f"harris {name}", launches,
                    {k: c * n for k, c in per_frame.items()})
    out = {**_times(rows), "launches": launches}
    if name == "cached":
        # one more map extraction (a new stamp) and its frame
        reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        runner(scene.frames[0], scene.ortho, scene.dem, 0.0, scene.k,
               scene.crs_affine, map_stamp=2, altitude_agl=scene.alt_m)
        torch.cuda.synchronize()
        out["map_extraction_ms"] = (
            (time.perf_counter() - t) * 1e3 - out["frame_p50_ms"])
        expect_launches("harris cached extraction", dict(LAUNCHES),
                        {"stem_stage": 2, "conv_stage": 14,
                         "nms_select": 1, "fused_block": 40})
    if name == "exact":
        out["graph"] = graphed_vs_eager(
            "harris exact", lambda i: fly(runner, scene, i), frames,
            [r[0] for r in rows], scene.crs_affine, taps)
    elif profile_run:
        busy = profile_frames(lambda i: fly(runner, scene, i), frames)
        out["device_busy_ms"] = busy
        out["device_idle_share"] = 1.0 - busy / out["frame_p50_ms"]
    return out


def harris_bench_map() -> dict:
    """Printed, not gated: the cached runner with harris_lg5 on bench.py's
    2048-px cached-mode map at 3x the footprint (the map at about the 480x640
    query's ground sample distance: no pooling), all 8 yaws."""
    from gisnav_tpu_torch.pipeline.runners import make_cached_deep_runner
    from gisnav_tpu_torch.utils.world import render_scene

    t0 = time.time()
    scene = render_scene(**{**HARRIS_SCENE, "map_side": BENCH_MAP})
    log(f"[harris bench map] scene {scene.ortho.shape} in "
        f"{time.time() - t0:.1f} s")
    runner = make_cached_deep_runner()
    rows = []
    for i in range(len(HARRIS_YAWS)):
        pose, _, err, _ = _frame(runner, scene, i, "[harris bench map]")
        rows.append((bool(pose.valid), err))
    return {"map": BENCH_MAP, "frames": len(rows),
            "valid_fraction": sum(v for v, _ in rows) / len(rows),
            "under_10m": sum(v and e < 10.0 for v, e in rows),
            "errors_m": [round(float(e), 3) for _, e in rows]}


def phase_semidense_path(profile_run: bool = False) -> dict:
    """Path 5: the semi-dense runner (bundled LoFTR, plain PyTorch: no
    kernel of the port) on path 4's scene. Each frame holds the JAX
    program's behaviour on the CPU: valid and within 10 m where it
    localizes, invalid where it does not."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.runners import make_semidense_runner
    from gisnav_tpu_torch.utils.world import render_scene

    scene = render_scene(**HARRIS_SCENE)
    taps: list = []
    with TappedRansac(taps), GraphSide("graphed", taps=taps):
        runner = make_semidense_runner()
        tap_programs(runner.models, taps)
        _frame(runner, scene, SEMIDENSE_FRAMES[0])
        reset_launches()
        rows = []

        def run_frame(i, tag=""):
            pose, ms, err, _ = _frame(runner, scene, i, tag)
            valid = bool(pose.valid)
            if i in SEMIDENSE_VALID:
                if not (valid and err < 10.0):
                    raise RuntimeError(f"semidense frame {i}: fix invalid or "
                                       f"{err:.2f} m off")
            elif valid:
                raise RuntimeError(f"semidense frame {i}: valid where the "
                                   f"JAX program's fix is not")
            return ms, err

        rows = [run_frame(i, f"[semidense] frame {i}")
                for i in SEMIDENSE_FRAMES]
        if any(LAUNCHES.values()):
            raise RuntimeError(f"semidense path launched {dict(LAUNCHES)}")
        out = {**_times([rows[SEMIDENSE_FRAMES.index(i)]
                         for i in SEMIDENSE_VALID]),
               "all_frames_p50_ms": float(np.median([r[0] for r in rows])),
               "launches": dict(LAUNCHES)}
        out["graph"] = graphed_vs_eager(
            "semidense", run_frame, list(SEMIDENSE_FRAMES),
            [r[0] for r in rows], scene.crs_affine, taps)
    log("[semidense] " + json.dumps(out))
    return out


def phase_classical_path(profile_run: bool = False) -> dict:
    """Path 6: the classical frame program on the card. The map and DEM are
    uploaded once, as a node keeps them; each frame seeds RANSAC with its
    number."""
    from gisnav_tpu_torch.device import resolve_device
    from gisnav_tpu_torch.features.sift import (
        extract_sift,
        extract_sift_batch,
        pad_features,
    )
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.classical import (
        _device_tail,
        classical_frame_to_geopose,
    )
    from gisnav_tpu_torch.pipeline.geopose import PipelineConfig
    from gisnav_tpu_torch.raster import rotate_and_crop_auto
    from gisnav_tpu_torch.utils.world import render_scene

    t0 = time.time()
    scene = render_scene(**CLASSICAL_SCENE)
    log(f"[classical] scene {scene.ortho.shape} in {time.time() - t0:.1f} s")
    dev = resolve_device()
    config = PipelineConfig(image_shape=(480, 640),
                            ortho_shape=scene.ortho.shape,
                            max_keypoints=1024)
    ortho = torch.as_tensor(scene.ortho, device=dev)
    dem = torch.as_tensor(scene.dem, device=dev)
    state = {"n": 0}

    def runner(query, _ortho, _dem, rotation_deg, k, crs_affine, **_):
        state["n"] += 1
        return classical_frame_to_geopose(query, ortho, dem, rotation_deg, k,
                                          crs_affine, config,
                                          seed=state["n"])

    frames = list(range(len(CLASSICAL_YAWS)))
    taps: list = []
    with TappedRansac(taps), GraphSide("graphed", taps=taps):
        for i in frames:  # the tail's graph and a warp graph a quadrant
            fly(runner, scene, i)
        reset_launches()
        rows = [fly(runner, scene, i, f"[classical] frame {i}")
                for i in frames]
        launches = dict(LAUNCHES)
        n = len(frames)
        log(f"[classical] launches over {n} frames: {launches}")
        expect_launches("classical", launches,
                        {"shear_last_axis": 2 * n, "shear_first_axis": n})
        out = {**_times(rows), "launches": launches}
        out["graph"] = graphed_vs_eager(
            "classical", lambda i: fly(runner, scene, i), frames[:4],
            [r[0] for r in rows[:4]], scene.crs_affine, taps)

    # frame 0's parts: SIFT of one image and of the pair, and the tail
    stack = torch.stack([ortho.float(), dem], dim=-1)
    warped, m_crop = rotate_and_crop_auto(stack, scene.yaws[0], (480, 640))
    crop = torch.clamp(warped[:, :, 0], 0, 255).to(torch.uint8)
    query = torch.as_tensor(scene.frames[0], device=dev)
    pair = torch.stack([query, crop])
    raw = extract_sift_batch(pair, 1024)
    fq, fr = (pad_features(*r, 1024) for r in raw)
    tail = _device_tail(config)
    k, aff = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
              for a in (scene.k, scene.crs_affine))

    def run_tail():
        return tail(fq.keypoints, fq.descriptors, fq.mask, fr.keypoints,
                    fr.descriptors, fr.mask, warped[:, :, 1].contiguous(),
                    m_crop.to(dev), k, aff,
                    generator=torch.Generator(device=dev).manual_seed(1))

    pair_host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        extract_sift_batch(pair, 1024)
        torch.cuda.synchronize()
        pair_host.append((time.perf_counter() - t) * 1e3)
    out.update({
        "keypoints": [int(len(r[0])) for r in raw],
        "matches": int(run_tail().num_matches),
        "sift_device_ms": device_ms(lambda: extract_sift(query, 1024),
                                    calls=5),
        "sift_pair_device_ms": device_ms(
            lambda: extract_sift_batch(pair, 1024), calls=5),
        "sift_pair_host_ms": float(np.median(pair_host)),
        "tail_device_ms": device_ms(run_tail, calls=5)})
    out["sift_share"] = out["sift_pair_host_ms"] / out["frame_p50_ms"]
    if "cv2" in sys.modules:
        raise RuntimeError("the classical path imported cv2")
    log("[classical] " + json.dumps(out))
    return out


def phase_vo_path(profile_run: bool = False) -> dict:
    """Path 7: the port's twist node over a rendered straight, level
    flight, on a LocalBus as the node graph drives it."""
    from gisnav_tpu_torch.constants import (
        ROS_TOPIC_CAMERA_INFO,
        ROS_TOPIC_IMAGE,
        ROS_TOPIC_MAVROS_GLOBAL_POSITION,
    )
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.nodes.bus import LocalBus
    from gisnav_tpu_torch.nodes.twist_node import TOPIC_TWIST_POSE, TwistNode
    from gisnav_tpu_torch.utils.world import render_flight

    t0 = time.time()
    flight = render_flight(**VO_FLIGHT)
    log(f"[vo] {len(flight.frames)} frames in {time.time() - t0:.1f} s")

    def node_on_bus():
        bus, poses = LocalBus(), []
        node = TwistNode(bus)
        bus.subscribe(TOPIC_TWIST_POSE, poses.append)
        node.initialize_pose(flight.poses[0])
        bus.publish(ROS_TOPIC_CAMERA_INFO, {"k": flight.k, "width": 640,
                                            "height": 480})
        bus.publish(ROS_TOPIC_MAVROS_GLOBAL_POSITION,
                    {"alt_ellipsoid": flight.alt_m})

        def step(i):
            t = time.perf_counter()
            bus.publish(ROS_TOPIC_IMAGE, {"image": flight.frames[i],
                                          "stamp_us": i * 100_000})
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3

        return step, poses

    step, poses = node_on_bus()
    reset_launches()
    ms = [step(i) for i in range(len(flight.frames))]
    expect_launches("vo", dict(LAUNCHES), {})
    if len(poses) != len(flight.frames) - 1:
        raise RuntimeError(f"vo: {len(poses)} poses of "
                           f"{len(flight.frames) - 1}")
    step_err = []
    for i, pose in enumerate(poses, start=1):
        est = pose["position"] - (poses[i - 2]["position"] if i > 1 else
                                  flight.poses[0][:3, 3])
        true = flight.poses[i][:3, 3] - flight.poses[i - 1][:3, 3]
        step_err.append(float(np.linalg.norm(est - true)))
    final = float(np.linalg.norm(poses[-1]["position"]
                                 - flight.poses[-1][:3, 3]))
    log(f"[vo] step translation errors (m): "
        f"{[round(e, 3) for e in step_err]}; last position {final:.3f} m "
        f"from the truth")
    if not (final < 10.0 and np.isfinite(final)):
        raise RuntimeError(f"vo: last pose {final:.2f} m off")
    out = {"frames": len(flight.frames), "poses": len(poses),
           "step_p50_ms": float(np.median(ms[1:])),
           "step_p90_ms": float(np.percentile(ms[1:], 90)),
           "max_step_error_m": max(step_err), "final_error_m": final,
           "launches": dict(LAUNCHES)}
    if profile_run:
        step2, _ = node_on_bus()
        step2(0)
        busy = profile_frames(step2, list(range(1, len(flight.frames))))
        out["device_busy_ms"] = busy
        out["device_idle_share"] = 1.0 - busy / out["step_p50_ms"]
    log("[vo] " + json.dumps(out))
    return out


def _graph_params(wms_url: str) -> dict:
    """Per-node parameters of path 8's graph: the stub WMS over loopback
    at the GIS node's default format (JPEG), flat ground at 0 m."""
    ground = {"ground_altitude_m": 0.0}
    return {"gis_node": {"wms_url": wms_url, "wms_layers": ["imagery"],
                         "wms_dem_layers": ["dem"]},
            "twist_node": dict(ground), "bbox_node": dict(ground),
            "pose_node": dict(ground)}


def _fix_errors(fix, lon, lat, alt) -> tuple:
    """(horizontal, vertical) metres of a SensorGps fix from the truth."""
    from gisnav_tpu_torch.geometry.crs import haversine_m

    return (haversine_m(lat, lon, fix["lat"] / 1e7, fix["lon"] / 1e7),
            abs(fix["alt_ellipsoid"] / 1e3 - alt))


def _publish_step(bus, stamp, lon, lat, alt, yaw, frame, gis=None) -> float:
    """The inputs of one camera frame in ``tests/test_envelope.py``'s order
    (global position, gimbal attitude, the GIS timer, the image); returns
    the host clock at the image's publish."""
    from gisnav_tpu_torch.constants import (
        ROS_TOPIC_IMAGE,
        ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS,
        ROS_TOPIC_MAVROS_GLOBAL_POSITION,
    )
    from gisnav_tpu_torch.utils.world_wms import camera_attitude_quat

    bus.publish(ROS_TOPIC_MAVROS_GLOBAL_POSITION,
                {"stamp_us": stamp, "lat": lat, "lon": lon,
                 "alt_ellipsoid": alt})
    bus.publish(ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS,
                {"stamp_us": stamp, "quat_xyzw": camera_attitude_quat(yaw)})
    if gis is not None:
        gis.tick()
    t = time.perf_counter()
    bus.publish(ROS_TOPIC_IMAGE, {"stamp_us": stamp,
                                  "frame_id": "camera_optical",
                                  "image": frame})
    return t


def _latencies(published: dict, arrivals: dict) -> list:
    """Frame-to-fix ms: host clock from an image's publish to the SensorGps
    fix stamped with that image's stamp."""
    return [(arrivals[s] - published[s]) * 1e3 for s in arrivals
            if s in published]


def _pcts(ms) -> dict:
    ms = [float(v) for v in ms]
    return {"n": len(ms), "p50_ms": float(np.median(ms)) if ms else None,
            "p90_ms": float(np.percentile(ms, 90)) if ms else None}


def _fly_graph(world, wms_url: str, step_m: float, overlap: float) -> dict:
    """``GisNavApp`` on a synchronous ``LocalBus`` with the production pose
    backend (learned_lg9, bucketed warp, 480x640 / 512 keypoints) over
    ``GRAPH_STEPS`` steps of ``step_m`` every 500 ms at 500 m AGL, the
    heading oscillating 22.5 +- 1.5 deg across a 15-deg bucket edge (the
    track of the JAX package's ``test_map_refresh_continuity_bucketed``);
    the GIS node refreshes its map below ``overlap``. Returns the app (not shut down),
    the flight's records and its launch counts by frame."""
    from gisnav_tpu_torch.constants import ROS_TOPIC_CAMERA_INFO
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.nodes.app import GisNavApp
    from gisnav_tpu_torch.nodes.gis_node import TOPIC_ORTHOIMAGE
    from gisnav_tpu_torch.nodes.mock_gps import TOPIC_SENSOR_GPS
    from gisnav_tpu_torch.nodes.pose_node import TOPIC_POSE
    from gisnav_tpu_torch.utils.world_wms import east_of

    lon0, lat0 = world.to_lonlat(*GRAPH_START_PX)
    track = [(east_of(lon0, lat0, step_m * i), lat0, GRAPH_ALT_M,
              22.5 + 1.5 * (-1) ** i) for i in range(GRAPH_STEPS)]
    t0 = time.time()
    frames = [world.render_frame(lon, lat, alt, yaw, GRAPH_K)
              for lon, lat, alt, yaw in track]
    params = _graph_params(wms_url)
    params["gis_node"]["min_map_overlap_update_threshold"] = overlap
    params["pose_node"].update(backend="deep", deep_mode="warp-bucketed",
                               weights="learned_lg9")
    app = GisNavApp(params=params)
    tag = f"[graph {step_m:g} m {overlap}]"
    log(f"{tag} {len(frames)} frames and the app in "
        f"{time.time() - t0:.1f} s")
    rec = {"app": app, "track": track, "frames": frames, "fixes": [],
           "poses": [], "maps": [], "arrivals": {}, "truth": {},
           "published": {}, "step_ms": [], "per_frame": []}

    def on_fix(msg):
        rec["arrivals"][msg["timestamp_sample"]] = time.perf_counter()
        rec["fixes"].append(msg)

    app.bus.subscribe(TOPIC_SENSOR_GPS, on_fix)
    app.bus.subscribe(TOPIC_ORTHOIMAGE,
                      lambda m: rec["maps"].append(m["stamp_us"]))
    app.bus.subscribe(TOPIC_POSE, rec["poses"].append)
    app.bus.publish(ROS_TOPIC_CAMERA_INFO,
                    {"k": GRAPH_K, "width": 640, "height": 480})
    stamp = 1_000_000
    reset_launches()
    for (lon, lat, alt, yaw), frame in zip(track, frames):
        stamp += 500_000
        rec["truth"][stamp] = (lon, lat, alt)
        before = dict(LAUNCHES)
        t = _publish_step(app.bus, stamp, lon, lat, alt, yaw, frame, app.gis)
        torch.cuda.synchronize()
        rec["published"][stamp] = t
        rec["step_ms"].append((time.perf_counter() - t) * 1e3)
        rec["per_frame"].append({k: LAUNCHES[k] - before[k]
                                 for k in LAUNCHES})
    rec["launches"] = dict(LAUNCHES)
    rec["stamp"] = stamp
    rec["errors"] = [_fix_errors(f, *rec["truth"][f["timestamp_sample"]])
                     for f in rec["fixes"]]
    rec["pose_errors"] = [
        (p["stamp_us"], round(_fix_errors(
            {"lat": p["lat"] * 1e7, "lon": p["lon"] * 1e7,
             "alt_ellipsoid": p["alt_ellipsoid"] * 1e3},
            *rec["truth"][p["stamp_us"]])[0], 2)) for p in rec["poses"]]
    log(f"{tag} {len(set(rec['maps']))} maps; pose node fixes "
        f"(stamp, m): {rec['pose_errors']}")
    log(f"{tag} SensorGps fixes (stamp, m, m): " + str(
        [(f["timestamp_sample"], round(h, 2), round(v, 2))
         for f, (h, v) in zip(rec["fixes"], rec["errors"])]))
    return rec


def graph_refresh_edge(world, wms_url: str) -> dict:
    """Printed, not gated: the JAX package's own track, 60 m steps (120
    m/s) at the reference's refresh threshold (0.85 overlap). The bucketed
    crop is the camera footprint at the map's centre, and at 0.85 the
    camera moves 45 % of its footprint from it before the next map: on
    this world the last frames before a refresh match only half their
    area."""
    rec = _fly_graph(world, wms_url, EDGE_STEP_M, EDGE_OVERLAP)
    rec["app"].shutdown()
    far = [e for e in rec["errors"] if not (e[0] < 10.0 and e[1] < 10.0)]
    return {"maps": len(set(rec["maps"])), "fixes": len(rec["fixes"]),
            "fixes_over_10m": len(far),
            "max_horiz_m": max((e[0] for e in rec["errors"]), default=None),
            "max_vert_m": max((e[1] for e in rec["errors"]), default=None),
            "pose_fixes": len(rec["poses"]),
            "max_pose_horiz_m": max((e[1] for e in rec["pose_errors"]),
                                    default=None)}


def graph_flight(world, wms_url: str, profile_run: bool = False) -> dict:
    """Path 8 (a): the flight of :func:`_fly_graph` at ``GRAPH_STEP_M``
    with the map refreshed below ``GRAPH_OVERLAP``, every gate."""
    rec = _fly_graph(world, wms_url, GRAPH_STEP_M, GRAPH_OVERLAP)
    app, per_frame, launches = rec["app"], rec["per_frame"], rec["launches"]
    log(f"[graph] launches over {len(per_frame)} frames: {launches}")
    cached = [i for i, n in enumerate(per_frame)
              if n == {k: GRAPH_FRAME.get(k, 0) for k in n}]
    refresh = [i for i, n in enumerate(per_frame)
               if n == {k: GRAPH_REFRESH.get(k, 0) for k in n}]
    if len(cached) + len(refresh) != len(per_frame):
        raise RuntimeError(f"graph: a frame launched other than a cached "
                           f"or a refresh frame: {per_frame}")
    expect_launches("graph cached frames",
                    {k: sum(per_frame[i][k] for i in cached)
                     for k in launches},
                    {k: n * len(cached) for k, n in GRAPH_FRAME.items()})
    if not all(launches[k] > 0 for k in GRAPH_FRAME):
        raise RuntimeError(f"graph: a kernel of the path never launched "
                           f"{launches}")
    maps = sorted(set(rec["maps"]))
    if len(maps) < 3:
        raise RuntimeError(f"graph: {len(maps)} map stamps, the refresh "
                           "gate fired fewer than twice")
    fixes, errors = rec["fixes"], rec["errors"]
    for fix, (horiz, vert) in zip(fixes, errors):
        if fix["satellites_used"] != 255:
            raise RuntimeError(f"graph: satellites_used {fix}")
        if not (horiz < 10.0 and vert < 10.0):
            raise RuntimeError(f"graph: fix at {fix['timestamp_sample']} "
                               f"{horiz:.2f} m / {vert:.2f} m off")
    if len(fixes) < 12:
        raise RuntimeError(f"graph: {len(fixes)} fixes of 12")
    if not any(f["timestamp_sample"] > maps[-1] for f in fixes):
        raise RuntimeError("graph: no fix after the last map refresh")
    step_ms = rec["step_ms"]
    out = {"frames": len(per_frame), "map_stamps": len(maps),
           "cached_frames": len(cached), "refresh_frames": len(refresh),
           "fixes": len(fixes),
           "max_horiz_m": max(e[0] for e in errors),
           "max_vert_m": max(e[1] for e in errors),
           "mean_horiz_m": float(np.mean([e[0] for e in errors])),
           "step": _pcts([step_ms[i] for i in cached]),
           "refresh_step": _pcts([step_ms[i] for i in refresh]),
           "frame_to_fix": _pcts(_latencies(rec["published"],
                                            rec["arrivals"])),
           "launches": launches}
    if profile_run:
        lon, lat, alt, yaw = rec["track"][-1]
        stamp = rec["stamp"]

        def hover(_):
            nonlocal stamp
            stamp += 500_000
            _publish_step(app.bus, stamp, lon, lat, alt, yaw,
                          rec["frames"][-1])

        busy = profile_frames(hover, [0])
        out["device_busy_ms"] = busy
        out["device_idle_share"] = 1.0 - busy / out["step"]["p50_ms"]
    stats = app.shutdown()
    out["handlers"] = {n: {h: {k: v[k] for k in ("calls", "p50_ms",
                                                  "p90_ms")}
                           for h, v in stats[n].items()}
                       for n in ("pose_node", "twist_node", "fusion_node")}
    return out


def graph_cli(world, wms_url: str) -> dict:
    """Path 8 (b): the graph that ``python -m gisnav_tpu_torch run`` builds
    from its default arguments (deep, learned_lg9, warp-bucketed, uorb; the
    threaded bus), hovering as ``tests/test_cli_run.py`` does: a frame
    every 250 ms, the GIS timer every 2 s, until 8 fixes or 60 s."""
    import os
    import tempfile

    from gisnav_tpu_torch.cli import build_app, build_parser
    from gisnav_tpu_torch.constants import ROS_TOPIC_CAMERA_INFO
    from gisnav_tpu_torch.nodes.mock_gps import TOPIC_SENSOR_GPS

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "params.json")
        with open(path, "w") as f:
            json.dump(_graph_params(wms_url), f)
        app = build_app(build_parser().parse_args(["run", "--params", path]))
    cfg = app.pose._config
    if not (app.bus._async and app.pose._deep_runner is not None
            and cfg.lightglue_depth == 9 and cfg.detector_mode == "learned"
            and cfg.image_shape == (480, 640) and cfg.max_keypoints == 512):
        raise RuntimeError(f"cli: not the production graph ({cfg})")
    lon, lat = world.to_lonlat(world.raster.shape[1] / 2,
                               world.raster.shape[0] / 2)
    yaw = 15.0
    frame = world.render_frame(lon, lat, GRAPH_ALT_M, yaw, GRAPH_K)
    fixes, arrivals, published = [], {}, {}

    def on_fix(msg):  # on the mock-GPS node's worker thread
        arrivals[msg["timestamp_sample"]] = time.perf_counter()
        fixes.append(msg)

    app.bus.subscribe(TOPIC_SENSOR_GPS, on_fix)
    app.bus.publish(ROS_TOPIC_CAMERA_INFO,
                    {"k": GRAPH_K, "width": 640, "height": 480})
    stamp = 1_000_000
    t0 = time.monotonic()
    while len(fixes) < GRAPH_CLI_FIXES \
            and time.monotonic() - t0 < GRAPH_CLI_DEADLINE_S:
        stamp += 250_000
        published[stamp] = _publish_step(
            app.bus, stamp, lon, lat, GRAPH_ALT_M, yaw, frame,
            app.gis if stamp % 2_000_000 < 250_000 else None)
        time.sleep(0.25)
    hover_s = time.monotonic() - t0
    stats = app.shutdown()
    if len(fixes) < GRAPH_CLI_FIXES:
        raise RuntimeError(f"cli: {len(fixes)} fixes in {hover_s:.0f} s")
    errors = [_fix_errors(f, lon, lat, GRAPH_ALT_M)
              for f in fixes[-5:]]
    horiz = float(np.median([e[0] for e in errors]))
    vert = float(np.median([e[1] for e in errors]))
    log(f"[graph cli] last 5 fixes (m): "
        f"{[(round(h, 2), round(v, 2)) for h, v in errors]}")
    if not (horiz < 10.0 and vert < 10.0):
        raise RuntimeError(f"cli: median of the last 5 fixes {horiz:.2f} m "
                           f"/ {vert:.2f} m off")
    return {"fixes": len(fixes), "frames": len(published),
            "hover_s": hover_s, "dropped": app.bus.dropped,
            "median_horiz_m": horiz, "median_vert_m": vert,
            "frame_to_fix": _pcts(_latencies(published, arrivals)),
            "handlers": {n: {h: {k: v[k] for k in ("calls", "p50_ms",
                                                    "p90_ms")}
                             for h, v in stats[n].items()}
                         for n in ("pose_node", "twist_node",
                                   "fusion_node")}}


def graph_filter_steps(calls: int = 50) -> dict:
    """Host ms of one global-filter (UKF) ``submit`` and one ``state_at``
    on the card, each ending in a synchronise, over a 4 Hz pose stream; the
    filters' steps replay their graphs, then the same stream runs them
    eagerly (``GraphSide``): the state's ``x`` and ``P`` after each call
    within 1e-6 relative (of each array's largest entry), for the UKF and
    the EKF; each side's device busy ms a submit and query (4 more calls
    traced) and idle share against their summed p50."""
    from gisnav_tpu_torch.fusion.filter import PoseFusionFilter, SensorConfig

    quat = np.array([0.0, 0.0, 0.0, 1.0])

    def call(f, i):  # one submit and one state query at 4 Hz
        stamp = 1_000_000 + 250_000 * i
        t = time.perf_counter()
        f.submit("pose", stamp, np.array([5.0 * i, 0.0, 500.0]), quat)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        est = f.state_at(stamp + 100_000)
        return est, (t1 - t) * 1e3, (time.perf_counter() - t1) * 1e3

    def stream(backend):
        f = PoseFusionFilter({"pose": SensorConfig(rejection_threshold=3.0)},
                             backend=backend)
        submit, query, states = [], [], []
        for i in range(calls + 3):
            est, s_ms, q_ms = call(f, i)
            states.append((f._state.x.clone(), f._state.p.clone()))
            if i >= 3:  # the first calls load the kernels
                submit.append(s_ms)
                query.append(q_ms)
        if not np.all(np.isfinite(est["position"])):
            raise RuntimeError(f"filter: non-finite state {est}")
        both = float(np.median(np.add(submit, query)))
        later = iter(range(calls + 3, calls + 11))  # fresh stamps
        busy = profile_frames(lambda _: call(f, next(later)), [0], n=4)
        return {"submit": _pcts(submit), "state_at": _pcts(query),
                "busy_ms": busy, "idle_share": 1.0 - busy / both}, states, f

    out = {}
    for backend in ("ukf", "ekf"):
        graphed, g_states, graphed_filter = stream(backend)
        with GraphSide("eager"):
            eager, e_states, _ = stream(backend)
        err = max(float((a - b).abs().max() / b.abs().max())
                  for g, e in zip(g_states, e_states) for a, b in zip(g, e))
        if not err <= 1e-6:
            raise RuntimeError(f"filter {backend}: graphed state {err} "
                               f"(relative) from eager")
        out[backend] = {**graphed, "eager": eager,
                        "max_rel_err_vs_eager": err,
                        "capture_ms": [g.capture_ms for g in
                                       graphed_filter._graphs.values()]}
    out.update(out["ukf"])
    return out


def phase_graph_path(profile_run: bool = False) -> dict:
    """Path 8: the node graph from camera frame to mock GPS, (a) on a
    synchronous bus, (b) as ``run`` wires it; then the filter steps."""
    from gisnav_tpu_torch.utils.world_wms import World, WorldWMS

    t0 = time.time()
    world = World.make(**GRAPH_WORLD)
    log(f"[graph] world {world.raster.shape} in {time.time() - t0:.1f} s")
    with WorldWMS(world) as wms:
        out = {"flight": graph_flight(world, wms.url, profile_run)}
        log("[graph flight] " + json.dumps(out["flight"]))
        out["refresh_edge"] = graph_refresh_edge(world, wms.url)
        log("[graph refresh edge] " + json.dumps(out["refresh_edge"]))
        out["cli"] = graph_cli(world, wms.url)
        log("[graph cli] " + json.dumps(out["cli"]))
        out["replies"] = dict(wms.formats)
    log(f"[graph] GetMap replies by format: {out['replies']}")
    if set(out["replies"]) != {"image/jpeg"}:
        raise RuntimeError(f"graph: the stub answered {out['replies']}, "
                           "not JPEG alone (the GIS node's default)")
    out["filter"] = graph_filter_steps()
    log("[graph filter] " + json.dumps(out["filter"]))
    leaked = [m for m in ("cv2", "requests") if m in sys.modules]
    if leaked:
        raise RuntimeError(f"graph: imported {leaked}")
    return out


# path 10: the deployed constellation, a process each (the compose
# service's ``run``, ``gis-serve``, ``health``, the vehicle's ``serial``)
DEPLOY_STEP_S = 1.0  # wall time and stamp step between frames: 30 m/s
# steps flown on the same line before path 8's 24 gated ones: the graph
# loads its map and kernels and its filters converge at the flight's speed
# (printed, not gated)
DEPLOY_LEAD_STEPS = 20
DEPLOY_START_S = 90.0  # deadline for a process to come up
DEPLOY_QUIET_S = 2.0  # no fix for this long: the fix stream has ended
DEPLOY_STREAM_S = 45.0  # the fusion node extrapolates 10 s past its input
DEPLOY_HOVER_GGA, DEPLOY_HOVER_S = 8, 90.0
HEALTH_TIMEOUT_S = 12.0
DEPLOY_DEVICE = "cuda"  # paths 10, 11 and 16's device; a CPU rehearsal: "cpu"
# path 11: tools/make_replay_dataset.py's defaults (12 frames of 640x480 at
# 500 m, yaw 25, a square map at 3x the footprint), on path 8's world
REPLAY_FRAMES, REPLAY_CLASSICAL_FRAMES = 12, 3
REPLAY_GIS_MOVE_M = 1e-3  # a GIS-export fix from the PNG one's, at most
# the classical run's map side: a multiple of 128 the shear kernel serves
# (the tool's 800 px takes the gather rotation, as on the JAX package's
# accelerator route), the smallest above the frame's 800-px diagonal
REPLAY_CLASSICAL_MAP = 896
REPLAY_FRAME = {"stem_stage": 1, "conv_stage": 7, "nms_select": 1,
                "fused_block": 40}  # a harris_lg5 cached frame (path 4)
REPLAY_EXTRACTION = {"stem_stage": 1, "conv_stage": 7}  # the map, once


class _Proc:
    """``python -m gisnav_tpu_torch ARGS`` from this checkout, its output in
    ``<logdir>/<name>.log``. ``stop`` interrupts it as Ctrl-C does and
    waits for it; every wait has a deadline, after which it is killed."""

    def __init__(self, name: str, args: list, logdir: str, env=None):
        import os

        self.name = name
        self.log_path = os.path.join(logdir, f"{name}.log")
        with open(self.log_path, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "gisnav_tpu_torch", *args],
                stdout=out, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__)),
                env={**os.environ, **(env or {})})
        self.pid = self.proc.pid

    def output(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def wait_for(self, text: str, deadline_s: float = DEPLOY_START_S
                 ) -> None:
        t0 = time.monotonic()
        while text not in self.output():
            if self.proc.poll() is not None or \
                    time.monotonic() - t0 > deadline_s:
                raise RuntimeError(
                    f"{self.name}: no {text!r} (rc {self.proc.poll()}, "
                    f"{time.monotonic() - t0:.0f} s):\n"
                    f"{self.output()[-3000:]}")
            time.sleep(0.1)

    def wait(self, deadline_s: float) -> int:
        try:
            return self.proc.wait(timeout=deadline_s)
        except subprocess.TimeoutExpired:
            self.kill()
            raise RuntimeError(f"{self.name} ran past its {deadline_s:.0f} s "
                               f"deadline:\n{self.output()[-3000:]}")

    def stop(self, deadline_s: float = 30.0) -> int:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
        rc = self.wait(deadline_s)
        if rc != 0:
            raise RuntimeError(f"{self.name} exited {rc}:\n"
                               f"{self.output()[-3000:]}")
        return rc

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _holds_card(pid: int) -> bool:
    """Whether process ``pid`` has a device file of the card open (a CUDA
    context keeps ``/dev/nvidia*`` open)."""
    import os

    fds = f"/proc/{pid}/fd"
    for fd in os.listdir(fds):
        try:
            if os.readlink(os.path.join(fds, fd)).startswith("/dev/nvidia"):
                return True
        except OSError:  # closed meanwhile
            pass
    return False


def _check_card_holders(tag: str, graph: "_Proc", others: list) -> list:
    """Print ``nvidia-smi``'s compute processes, then fail unless the graph
    holds the card and none of ``others`` (the server, the bridge,
    ``health``) does. The processes' own open device files decide: in a
    container ``nvidia-smi`` lists pids of another namespace."""
    import os

    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    holders = [p.name for p in (graph, *others) if _holds_card(p.pid)]
    log(f"[deploy {tag}] nvidia-smi compute apps "
        f"{smi.stdout.split()}; chip_smoke {os.getpid()}, "
        + ", ".join(f"{p.name} {p.pid}" for p in (graph, *others))
        + f"; holding the card: {holders}")
    if holders != [graph.name]:
        raise RuntimeError(f"deploy {tag}: the card is held by {holders}, "
                           f"only {graph.name} may")
    return holders


def _write_maps(world, root: str) -> None:
    """``imagery/`` (the world) and ``dem/`` (0 m at 1/8 the resolution)
    GeoTIFFs of ``world``: the layout ``gis-serve --maps`` loads."""
    import os

    from gisnav_tpu_torch.gis.geotiff import GeoRef, write_geotiff

    dlon, dlat = world._deg_per_px
    n = world.raster.shape[0]
    for layer, raster, scale in (
            ("imagery", world.raster, 1),
            ("dem", np.zeros((n // 8, n // 8), np.float32), 8)):
        os.makedirs(os.path.join(root, layer), exist_ok=True)
        write_geotiff(os.path.join(root, layer, f"world_{layer}.tif"),
                      raster, GeoRef(left=world.left, top=world.top,
                                     gsd_lon=scale * dlon,
                                     gsd_lat=scale * dlat))


def _deploy_params(root: str, name: str, wfst_url=None) -> str:
    """A ``run --params`` file: path 8's nodes (flat ground, the default
    JPEG replies, the map refreshed below ``GRAPH_OVERLAP``), the WMS left to
    ``GISNAV_WMS_URL``; with ``wfst_url``, the WFS-T sink's endpoint."""
    import os

    params = _graph_params("")
    del params["gis_node"]["wms_url"]
    params["gis_node"]["min_map_overlap_update_threshold"] = GRAPH_OVERLAP
    if wfst_url:
        params["wfst_node"] = {"wfst_url": wfst_url}
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(params, f)
    return path


def _gga_fix(sentence: str) -> tuple:
    """(lon, lat, ellipsoid altitude) of a GGA sentence (``(d)ddmm.mmmm``
    fields, the AMSL altitude plus the geoid's height there)."""
    from gisnav_tpu_torch.geometry.geoid import geoid_height

    def degrees(field: str, hemisphere: str) -> float:
        dot = field.index(".")
        value = int(field[:dot - 2]) + float(field[dot - 2:]) / 60.0
        return -value if hemisphere in ("S", "W") else value

    f = sentence.split("*")[0].split(",")
    lat, lon = degrees(f[2], f[3]), degrees(f[4], f[5])
    return lon, lat, float(f[9]) + float(f[11]) + geoid_height(lon, lat)


def deploy_compose(world, root: str, gis_url: str, procs: list) -> dict:
    """Path 10 (a): the compose service's ``run --shm --wfst --protocol
    uorb`` (learned_lg9, warp-bucketed, 480x640 / 512 keypoints) as a
    process of its own, fed over the ShmBus by this process with path 8's
    gated track, a step of 30 m a second, after ``DEPLOY_LEAD_STEPS`` on
    the same line. Gates: every ``SensorGps`` fix stamped within the 24
    gated steps within 10 m of the track, ``health`` 0 while
    the graph runs, one WFS-T feature a fix once the fix stream has ended,
    each within 10 m of its fix. Returns the ``health`` process started
    after the graph stopped (it must exit 1)."""
    import os
    import urllib.request

    from gisnav_tpu_torch.constants import ROS_TOPIC_CAMERA_INFO
    from gisnav_tpu_torch.geometry.crs import haversine_m
    from gisnav_tpu_torch.nodes.bus import ShmBus
    from gisnav_tpu_torch.nodes.fusion_node import TOPIC_ODOMETRY
    from gisnav_tpu_torch.nodes.mock_gps import TOPIC_SENSOR_GPS
    from gisnav_tpu_torch.nodes.pose_node import TOPIC_POSE
    from gisnav_tpu_torch.nodes.twist_node import TOPIC_TWIST_POSE
    from gisnav_tpu_torch.utils.world_wms import east_of

    ns = f"smoke{os.getpid()}a"
    graph = _Proc("graph_compose", [
        "run", "--shm", "--wfst", "--protocol", "uorb", "--namespace", ns,
        "--params", _deploy_params(root, "compose", f"{gis_url}/wfst"),
        "--device", DEPLOY_DEVICE],
        root, env={"GISNAV_WMS_URL": f"{gis_url}/wms"})
    procs.append(graph)
    bus = ShmBus(namespace=ns)
    try:
        fixes, arrivals, published = [], {}, {}

        def on_fix(msg):  # on this bus's reader thread
            arrivals.setdefault(msg["timestamp_sample"], time.perf_counter())
            fixes.append(msg)
            wall.append(time.monotonic())

        wall: list = []
        # the fusion node's inputs and outputs with their publish stamps:
        # the feed tests/test_torch_fusion_deployed.py replays
        heard: list = []
        for kind, topic in (("vo", TOPIC_TWIST_POSE), ("pose", TOPIC_POSE),
                            ("odom", TOPIC_ODOMETRY)):
            bus.subscribe(topic, lambda m, us, k=kind: heard.append(
                (k, us, m)), stamped=True)
        bus.subscribe(TOPIC_SENSOR_GPS, on_fix)
        t0 = time.monotonic()
        graph.wait_for("Ctrl-C to stop")
        log(f"[deploy compose] graph up in {time.monotonic() - t0:.1f} s")
        health = _Proc("health_live", ["health", "--namespace", ns,
                                       "--timeout", str(HEALTH_TIMEOUT_S)],
                       root)
        procs.append(health)
        lon0, lat0 = world.to_lonlat(*GRAPH_START_PX)
        track = [(1_000_000 + int((i + DEPLOY_LEAD_STEPS) * DEPLOY_STEP_S
                                  * 1e6),
                  east_of(lon0, lat0, GRAPH_STEP_M * i), lat0, GRAPH_ALT_M,
                  22.5 + 1.5 * (-1) ** i)
                 for i in range(-DEPLOY_LEAD_STEPS, GRAPH_STEPS)]
        frames = [world.render_frame(lon, lat, alt, yaw, GRAPH_K)
                  for _, lon, lat, alt, yaw in track]
        t_start, holders = time.monotonic(), None
        t_start_us = time.time_ns() // 1000
        for i, ((stamp, lon, lat, alt, yaw), frame) in enumerate(
                zip(track, frames)):
            bus.publish(ROS_TOPIC_CAMERA_INFO,
                        {"k": GRAPH_K, "width": 640, "height": 480})
            published[stamp] = _publish_step(bus, stamp, lon, lat, alt, yaw,
                                             frame)
            if i == DEPLOY_LEAD_STEPS:
                holders = _check_card_holders("compose", graph, [health])
            time.sleep(max(0.0, t_start + (i + 1) * DEPLOY_STEP_S
                           - time.monotonic()))
        live_rc = health.wait(HEALTH_TIMEOUT_S + DEPLOY_START_S)
        log(f"[deploy compose] health while running: rc {live_rc}, "
            f"{health.output().strip()!r}")
        # the fusion node extrapolates past its last input until its output
        # timeout: wait for the end of the stream, so that the WFS-T sink
        # has posted every fix
        n, quiet = -1, time.monotonic()
        while time.monotonic() - quiet < DEPLOY_QUIET_S:
            if len(fixes) != n:
                n, quiet = len(fixes), time.monotonic()
            if time.monotonic() - t_start > GRAPH_STEPS * DEPLOY_STEP_S \
                    + DEPLOY_STREAM_S:
                raise RuntimeError("deploy compose: the fix stream never "
                                   "ended")
            time.sleep(0.1)
        with urllib.request.urlopen(
                f"{gis_url}/wfst?service=WFS&version=1.1.0&request="
                "GetFeature&typename=gisnav:position&outputFormat="
                "application/json", timeout=30) as resp:
            features = json.loads(resp.read())["features"]
        graph.stop()
        log(f"[deploy compose] graph stopped; its output:\n{graph.output()}")
        stopped = _Proc("health_stopped", [
            "health", "--namespace", ns, "--timeout", str(HEALTH_TIMEOUT_S)],
            root)
        procs.append(stopped)
        fixes = list(fixes)
    finally:
        bus.close()
    truth = np.array([t[:4] for t in track], np.float64)

    def errors_of(fs):
        return [_fix_errors(f, *(np.interp(f["timestamp_sample"],
                                           truth[:, 0], truth[:, j])
                                 for j in (1, 2, 3))) for f in fs]

    first = track[DEPLOY_LEAD_STEPS][0]
    lead = [f for f in fixes if f["timestamp_sample"] < first]
    flight = [f for f in fixes if first <= f["timestamp_sample"]
              <= track[-1][0]]
    errors = errors_of(flight)
    log("[deploy compose] lead-in fixes (stamp, s after the flight's start, "
        "m, m), not gated: " + str(
            [(f["timestamp_sample"], round(t - t_start, 2), round(h, 2),
              round(v, 2)) for f, t, (h, v) in zip(fixes, wall,
                                                   errors_of(lead))]))
    log("[deploy compose] SensorGps fixes in the flight (stamp, m, m): "
        + str([(f["timestamp_sample"], round(h, 2), round(v, 2))
               for f, (h, v) in zip(flight, errors)]))
    far = [(f["timestamp_sample"], h, v)
           for f, (h, v) in zip(flight, errors) if not (h < 10.0 and v < 10.0)]
    feed = path10_feed(heard, t_start_us, track, first, fixes, errors_of)
    log(f"[deploy compose] the fusion node's feed: {feed['counts']} "
        f"events, written to {feed['path']}")
    # the pose node's fixes, judged as the uORB fixes are: a fused fix
    # over 10 m follows a pose fix off by more (the global filter moves
    # about half way to each pose fix its gate lets through, and the gate
    # may then turn away the next, correct one, as the JAX node's does)
    poses = sorted({m["stamp_us"]: m for k, _, m in heard
                    if k == "pose"}.values(), key=lambda m: m["stamp_us"])
    pose_errors = [(m["stamp_us"], round(h, 2), round(v, 2))
                   for m, (h, v) in zip(poses, errors_of([{
                       "timestamp_sample": m["stamp_us"],
                       "lat": m["lat"] * 1e7, "lon": m["lon"] * 1e7,
                       "alt_ellipsoid": m["alt_ellipsoid"] * 1e3}
                       for m in poses]))]
    log("[deploy compose] pose fixes (stamp, m, m): " + str(pose_errors))
    if far or len(flight) < 12:
        raise RuntimeError(
            f"deploy compose: {len(flight)} fixes in the flight (12 "
            f"needed), over 10 m: {far}; the pose fixes over 10 m: "
            f"{[p for p in pose_errors if max(p[1], p[2]) >= 10.0]}")
    if live_rc != 0:
        raise RuntimeError(f"deploy compose: health exited {live_rc} while "
                           "the graph ran")
    feature_m = [haversine_m(f["lat"] / 1e7, f["lon"] / 1e7,
                             ft["geometry"]["coordinates"][1],
                             ft["geometry"]["coordinates"][0])
                 for f, ft in zip(fixes, features)]
    if len(features) != len(fixes) or max(feature_m) >= 10.0:
        raise RuntimeError(f"deploy compose: {len(features)} WFS-T features "
                           f"for {len(fixes)} fixes, the farthest "
                           f"{max(feature_m, default=None)} m from its fix")
    return {"fixes": len(fixes), "flight_fixes": len(flight),
            "lead_in_fixes": len(lead),
            "max_horiz_m": max(e[0] for e in errors),
            "max_vert_m": max(e[1] for e in errors),
            "mean_horiz_m": float(np.mean([e[0] for e in errors])),
            "features": len(features), "max_feature_m": max(feature_m),
            "health_live_rc": live_rc, "card_pids": holders,
            "first_fix_s": wall[0] - t_start if wall else None,
            "frame_to_fix": _pcts(_latencies(
                {s: t for s, t in published.items() if s >= first},
                arrivals)),
            "frames_with_fix": len(set(arrivals) & set(published)),
            "shm_dropped": bus.dropped, "health_stopped": stopped}


PATH10_FEED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out", "path10_feed.json")


def path10_feed(heard: list, t_start_us: int, track: list, first: int,
                fixes: list, errors_of) -> dict:
    """Write path 10's gated flight as the fusion node received it to
    ``PATH10_FEED``: every VO pose ("vo") and pose fix ("pose") and the
    stamp of every odometry message the node published ("odom"), in
    publish order, each with its publish time in us after the flight's
    start (the shared-memory bus's publisher stamps); the track (stamp, lon,
    lat, ellipsoid altitude) and the card's SensorGps fixes (stamp, lat,
    lon in 1e-7 degrees, ellipsoid altitude in mm, horizontal and vertical
    metres from the track). Returns the event counts and the path."""
    def floats(a):
        return [float(v) for v in np.ravel(a)]

    events = []
    for kind, us, m in sorted(heard, key=lambda e: e[1]):
        row = [kind, int(us) - t_start_us, int(m["stamp_us"])]
        if kind != "odom":
            row += [floats(m["position"]), floats(m["quat_xyzw"]),
                    floats(m["covariance"])]
        if kind == "pose":
            row += [float(m["lon"]), float(m["lat"]),
                    float(m["alt_ellipsoid"])]
        events.append(row)
    feed = {"track": [[int(t[0]), *map(float, t[1:4])] for t in track],
            "first_gated_stamp_us": int(first),
            "events": events,
            "fixes": [[int(f["timestamp_sample"]), int(f["lat"]),
                       int(f["lon"]), int(f["alt_ellipsoid"]), h, v]
                      for f, (h, v) in zip(fixes, errors_of(fixes))]}
    os.makedirs(os.path.dirname(PATH10_FEED), exist_ok=True)
    with open(PATH10_FEED, "w") as f:
        json.dump(feed, f, separators=(",", ":"))
    counts = {k: sum(e[0] == k for e in events) for k in ("vo", "pose",
                                                           "odom")}
    return {"counts": counts, "path": PATH10_FEED}


def deploy_vehicle(world, root: str, gis_url: str, procs: list,
                   others: list) -> dict:
    """Path 10 (b): the vehicle topology, ``run --shm --protocol nmea`` and
    a ``serial --tcp`` process bridging its NMEA over TCP to this process
    (the simulator's side of the reference's socat hop), hovering until 8
    GGA sentences arrive; the median of the last 5 within 10 m."""
    import os
    import socket

    from gisnav_tpu_torch.constants import ROS_TOPIC_CAMERA_INFO
    from gisnav_tpu_torch.geometry.crs import haversine_m
    from gisnav_tpu_torch.nodes.bus import ShmBus

    ns = f"smoke{os.getpid()}b"
    listener = socket.create_server(("127.0.0.1", 0))
    listener.settimeout(0.05)
    graph = _Proc("graph_vehicle", [
        "run", "--shm", "--protocol", "nmea", "--namespace", ns, "--params",
        _deploy_params(root, "vehicle"), "--device", DEPLOY_DEVICE], root,
        env={"GISNAV_WMS_URL": f"{gis_url}/wms"})
    serial = _Proc("serial", ["serial", "--tcp",
                              f"127.0.0.1:{listener.getsockname()[1]}",
                              "--namespace", ns], root)
    procs += [graph, serial]
    bus, conn = ShmBus(namespace=ns), None
    try:
        graph.wait_for("Ctrl-C to stop")
        serial.wait_for("serial bridge up")
        lon, lat = world.to_lonlat(world.raster.shape[1] / 2,
                                   world.raster.shape[0] / 2)
        frame = world.render_frame(lon, lat, GRAPH_ALT_M, 15.0, GRAPH_K)
        gga, buf, stamp, holders = [], b"", 1_000_000, None
        t0 = time.monotonic()
        while len(gga) < DEPLOY_HOVER_GGA:
            if time.monotonic() - t0 > DEPLOY_HOVER_S:
                raise RuntimeError(f"deploy vehicle: {len(gga)} GGA in "
                                   f"{DEPLOY_HOVER_S:.0f} s")
            stamp += 250_000
            bus.publish(ROS_TOPIC_CAMERA_INFO,
                        {"k": GRAPH_K, "width": 640, "height": 480})
            _publish_step(bus, stamp, lon, lat, GRAPH_ALT_M, 15.0, frame)
            t_next = time.monotonic() + 0.25
            while time.monotonic() < t_next:
                if conn is None:
                    try:
                        conn, _ = listener.accept()
                        conn.settimeout(0.05)
                    except socket.timeout:
                        continue
                try:
                    buf += conn.recv(65536)
                except socket.timeout:
                    pass
            *lines, buf = buf.split(b"\r\n")
            gga += [ln.decode() for ln in lines if ln[3:6] == b"GGA"]
            if gga and holders is None:
                holders = _check_card_holders("vehicle", graph,
                                              [serial, *others])
        serial.stop()
        graph.stop()
    finally:
        if conn is not None:
            conn.close()
        listener.close()
        bus.close()
    errors = [(haversine_m(lat, lon, fla, flo), abs(alt - GRAPH_ALT_M))
              for flo, fla, alt in map(_gga_fix, gga[-5:])]
    log(f"[deploy vehicle] {len(gga)} GGA in {time.monotonic() - t0:.1f} "
        f"s, the last 5 (m): "
        f"{[(round(h, 2), round(v, 2)) for h, v in errors]}")
    horiz = float(np.median([e[0] for e in errors]))
    vert = float(np.median([e[1] for e in errors]))
    if not (horiz < 10.0 and vert < 10.0):
        raise RuntimeError(f"deploy vehicle: median of the last 5 GGA "
                           f"{horiz:.2f} m / {vert:.2f} m off")
    return {"gga": len(gga), "median_horiz_m": horiz, "median_vert_m": vert,
            "card_pids": holders}


def _probe_gis_serve(world, url: str) -> dict:
    """One GetMap from ``gis-serve`` as the GIS node asks for its map: the
    default format (the JAX node's ``image/jpeg``) must come back JPEG and
    decode through the port's codec to the requested size."""
    from gisnav_tpu_torch.gis.jpeg import decode_image
    from gisnav_tpu_torch.gis.wms import DEFAULT_FORMAT, WMSClient

    lon0, lat0 = world.to_lonlat(*GRAPH_START_PX)
    lon1, lat1 = world.to_lonlat(GRAPH_START_PX[0] + 400,
                                 GRAPH_START_PX[1] + 400)
    ctype, body = WMSClient(f"{url}/wms")._get({
        "service": "WMS", "request": "GetMap", "version": "1.1.1",
        "layers": "imagery", "styles": "", "srs": "EPSG:4326",
        "bbox": f"{lon0},{lat1},{lon1},{lat0}", "width": "800",
        "height": "800", "format": DEFAULT_FORMAT})
    img = decode_image(body)
    out = {"format": DEFAULT_FORMAT, "content_type": ctype,
           "bytes": len(body), "shape": None if img is None else img.shape}
    log(f"[deploy] gis-serve GetMap at the default format: {out}")
    if ctype != "image/jpeg" or not body.startswith(b"\xff\xd8") \
            or out["shape"] != (800, 800):
        raise RuntimeError(f"deploy: gis-serve's default GetMap {out}")
    return out


def phase_deploy_path(graph_frame_to_fix=None) -> dict:
    """Path 10: the deployed constellation over path 8's world, served by
    ``gis-serve`` from GeoTIFFs: (a) the compose service, (b) the vehicle
    topology. Every process started here is stopped before it returns,
    and the shared-memory segments they made are removed."""
    import os
    import shutil
    import tempfile

    from gisnav_tpu_torch.utils.world_wms import World

    shm_before = set(os.listdir("/dev/shm"))
    usage = shutil.disk_usage("/dev/shm")
    log(f"[deploy] /dev/shm {usage.total / 2**30:.1f} GiB, "
        f"{usage.free / 2**30:.1f} GiB free (a topic maps 8 x 32 MiB, "
        "sparse)")
    world = World.make(**GRAPH_WORLD)
    procs: list = []
    with tempfile.TemporaryDirectory() as root:
        try:
            _write_maps(world, os.path.join(root, "maps"))
            port = _free_port()
            gis = _Proc("gis_serve", ["gis-serve", "--maps",
                                      os.path.join(root, "maps"), "--host",
                                      "127.0.0.1", "--port", str(port)],
                        root)
            procs.append(gis)
            gis.wait_for("GIS server on")
            url = f"http://127.0.0.1:{port}"
            out_probe = _probe_gis_serve(world, url)
            out = {"gis_serve": out_probe,
                   "compose": deploy_compose(world, root, url, procs)}
            stopped = out["compose"].pop("health_stopped")
            out["vehicle"] = deploy_vehicle(world, root, url, procs,
                                            [gis, stopped])
            rc = stopped.wait(HEALTH_TIMEOUT_S + DEPLOY_START_S)
            log(f"[deploy] health after the graph stopped: rc {rc}, "
                f"{stopped.output().strip()!r}")
            if rc != 1:
                raise RuntimeError(f"deploy: health exited {rc} after the "
                                   "graph stopped")
            out["health_stopped_rc"] = rc
            gis.stop()
        finally:
            for p in procs:
                p.kill()
            for name in set(os.listdir("/dev/shm")) - shm_before:
                if name.startswith("gisnav_"):
                    os.remove(os.path.join("/dev/shm", name))
    ftf = out["compose"]["frame_to_fix"]
    log(f"[deploy] frame-to-fix over the ShmBus p50 {ftf['p50_ms']} / p90 "
        f"{ftf['p90_ms']} ms; path 8's LocalBus: "
        + (json.dumps(graph_frame_to_fix) if graph_frame_to_fix
           else "not run"))
    log("[deploy] " + json.dumps(out))
    return out


def _replay_cli(argv: list) -> tuple:
    """``python -m gisnav_tpu_torch replay ARGV`` in this process (so the
    kernel counts see its launches): (exit code, report, launches)."""
    from gisnav_tpu_torch.cli import main as cli_main
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    rc = cli_main(["replay", *argv, "--quiet", "--device", DEPLOY_DEVICE])
    launches = dict(LAUNCHES)
    with open(argv[argv.index("--out") + 1]) as f:
        return rc, json.load(f), launches


def _replay_harris(data: str, report: str, tag: str) -> dict:
    """harris_lg5 ``replay --fused`` on ``data``, gated (rc 0: every frame
    within 10 m; every fused frame within 10 m; a harris_lg5 cached frame's
    K1-K4 counts), then once more for the frame p50."""
    from gisnav_tpu_torch.replay import replay

    rc, rep, launches = _replay_cli([data, "--weights", "harris_lg5",
                                     "--fused", "--out", report])
    s = rep["summary"]
    log(f"[replay harris {tag}] rc {rc} {json.dumps(s)}; launches "
        f"{launches}")
    if rc != 0 or s["fused_pass_10m"] != s["fused_frames"] \
            or s["frames"] != REPLAY_FRAMES:
        raise RuntimeError(f"replay harris_lg5 {tag}: rc {rc}, {s}")
    expect_launches(f"replay harris_lg5 {tag}", launches, {
        k: REPLAY_FRAMES * n + REPLAY_EXTRACTION.get(k, 0)
        for k, n in REPLAY_FRAME.items()})
    ticks = []
    replay(data, weights="harris_lg5", fused=True, device=DEPLOY_DEVICE,
           progress=lambda *_: ticks.append(time.perf_counter()))
    return {**s, "launches": launches, "fixes": rep["frames"],
            "frame": _pcts(np.diff(ticks) * 1e3)}


def grey_palette_png(grey: np.ndarray) -> bytes:
    """An (H, W) uint8 image as an 8-bit palette PNG whose 256 entries are
    the grey levels (MapServer's ``mode=8bit`` kind of file), written with
    ``zlib`` and ``struct``: test data for path 11."""
    import struct
    import zlib

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    h, w = grey.shape
    rows = np.zeros((h, 1 + w), np.uint8)
    rows[:, 1:] = grey
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
            + chunk(b"PLTE", np.repeat(np.arange(256, dtype=np.uint8), 3)
                    .tobytes())
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def with_exif_orientation(jpeg: bytes, orientation: int) -> bytes:
    """JPEG bytes with an APP1 Exif segment (big-endian TIFF, IFD0 holding
    one Orientation SHORT) spliced in after the JFIF APP0: test data for
    path 11, as a camera tags a frame it stored turned."""
    import struct

    tiff = (b"MM" + struct.pack(">HI", 42, 8) + struct.pack(">H", 1)
            + struct.pack(">HHIH", 0x0112, 3, 1, orientation) + b"\0\0"
            + struct.pack(">I", 0))
    body = b"Exif\0\0" + tiff
    at = 4 + int.from_bytes(jpeg[4:6], "big")
    return (jpeg[:at] + b"\xff\xe1" + struct.pack(">H", len(body) + 2)
            + body + jpeg[at:])


def store_as_camera(src: str, dst: str) -> None:
    """Copy replay dataset ``src`` to ``dst`` with each frame stored as a
    camera stores it (its pixels turned 90 degrees, the port's baseline
    JPEG, Orientation 6, which turns them back) and its map as a 256-entry
    grey palette PNG."""
    import shutil

    from gisnav_tpu_torch.gis.jpeg import (IMREAD_GRAYSCALE, encode_jpeg,
                                           read_image)

    shutil.copytree(src, dst)
    frames = os.path.join(dst, "frames")
    for name in sorted(os.listdir(frames)):
        path = os.path.join(frames, name)
        upright = read_image(path, IMREAD_GRAYSCALE)
        stored = np.ascontiguousarray(np.rot90(upright, 1))
        with open(path, "wb") as f:
            f.write(with_exif_orientation(encode_jpeg(stored), 6))
    path = os.path.join(dst, "map.png")
    ortho = read_image(path, IMREAD_GRAYSCALE)
    with open(path, "wb") as f:
        f.write(grey_palette_png(ortho))


def _moved(fixes_a: list, fixes_b: list) -> list:
    """Each frame's fix moved from one dataset's run to another's."""
    return [{"stamp_us": a["stamp_us"],
             "horiz_m": round(float(np.hypot(a["east_m"] - b["east_m"],
                                             a["north_m"] - b["north_m"])),
                              3),
             "up_m": round(abs(a["up_m"] - b["up_m"]), 3)}
            for a, b in zip(fixes_a, fixes_b)]


def check_gis_export(png: str, gis: str) -> dict:
    """The GIS-export dataset (``write_replay_dataset(image_format="tiff")``:
    a tiled deflate GeoTIFF map with predictor 2, a float32 GeoTIFF DEM,
    TIFF and PGM frames) decodes to the PNG dataset's arrays bit for
    bit."""
    from gisnav_tpu_torch.gis.imgcodecs import (IMREAD_GRAYSCALE,
                                                image_format, read_image)
    from gisnav_tpu_torch.replay import load_dataset

    a, b = load_dataset(png), load_dataset(gis)
    kinds = {}
    for key in ("ortho", "dem"):
        if a[key].dtype != b[key].dtype or not np.array_equal(a[key],
                                                              b[key]):
            raise RuntimeError(f"replay: the GIS export's {key} is not the "
                               "PNG dataset's")
    for ra, rb in zip(a["poses"], b["poses"]):
        with open(rb["frame_path"], "rb") as f:
            kind = image_format(f.read(8))
        kinds[kind] = kinds.get(kind, 0) + 1
        if not np.array_equal(read_image(ra["frame_path"], IMREAD_GRAYSCALE),
                              read_image(rb["frame_path"], IMREAD_GRAYSCALE)):
            raise RuntimeError(f"replay: GIS-export frame {rb['frame_path']} "
                               "is not the PNG dataset's")
    with open(os.path.join(gis, "map.png"), "rb") as f:
        kinds["map"] = image_format(f.read(8))
    out = {"equal": True, "frames": kinds, "dem_dtype": str(b["dem"].dtype)}
    log(f"[replay] GIS export decodes to the PNG dataset's arrays: "
        f"{json.dumps(out)}")
    return out


def phase_replay_path() -> dict:
    """Path 11: ``replay`` on a dataset of ``tools/make_replay_dataset.py``'s
    defaults over path 8's world, written as PNG, as JPEG, as a GIS exports
    it (:func:`check_gis_export`) and stored as a camera stores it
    (:func:`store_as_camera`): harris_lg5 fused on each
    (:func:`_replay_harris`) and each frame's fix moved between the PNG and
    the JPEG dataset, between the JPEG and the camera one and between the
    PNG and the GIS export (at most ``REPLAY_GIS_MOVE_M``), the classical
    backend on 3 frames over an 896-px map (K6 2 + 1 a frame), then
    learned_lg9, printed only."""
    import os
    import tempfile

    from gisnav_tpu_torch.replay import replay
    from gisnav_tpu_torch.utils.world_wms import World, write_replay_dataset

    world = World.make(**GRAPH_WORLD)
    out = {}
    with tempfile.TemporaryDirectory() as root:
        data, three = os.path.join(root, "flight"), os.path.join(root, "3")
        jpeg = os.path.join(root, "flight_jpeg")
        write_replay_dataset(world, data, frames=REPLAY_FRAMES)
        write_replay_dataset(world, jpeg, frames=REPLAY_FRAMES,
                             image_format="jpeg")
        with open(os.path.join(jpeg, "map.png"), "rb") as f:
            if f.read(2) != b"\xff\xd8":
                raise RuntimeError("replay: the JPEG dataset holds no JPEG")
        write_replay_dataset(world, three, frames=REPLAY_CLASSICAL_FRAMES,
                             map_px=REPLAY_CLASSICAL_MAP)
        camera = os.path.join(root, "flight_camera")
        store_as_camera(data, camera)
        gis = os.path.join(root, "flight_gis")
        write_replay_dataset(world, gis, frames=REPLAY_FRAMES,
                             image_format="tiff")
        out["gis_export"] = check_gis_export(data, gis)
        report = os.path.join(root, "r.json")
        out["harris"] = _replay_harris(data, report, "png")
        out["harris_jpeg"] = _replay_harris(jpeg, report, "jpeg")
        out["harris_camera"] = _replay_harris(camera, report, "camera")
        out["harris_gis"] = _replay_harris(gis, report, "gis-export")
        fixes = {k: out[k].pop("fixes") for k in (
            "harris", "harris_jpeg", "harris_camera", "harris_gis")}
        for key, a, b, what in (
                ("png_to_jpeg", "harris", "harris_jpeg", "PNG -> JPEG"),
                ("jpeg_to_camera", "harris_jpeg", "harris_camera",
                 "upright JPEG -> camera (EXIF 6, palette map)"),
                ("png_to_gis", "harris", "harris_gis",
                 "PNG -> GIS export (GeoTIFF map and DEM, TIFF / PGM "
                 "frames)")):
            moved = _moved(fixes[a], fixes[b])
            out[key] = {"max_horiz_m": max(m["horiz_m"] for m in moved),
                        "max_up_m": max(m["up_m"] for m in moved)}
            log(f"[replay harris] each fix's move, {what} dataset: {moved}")
        if max(out["png_to_gis"].values()) > REPLAY_GIS_MOVE_M:
            raise RuntimeError(f"replay: a GIS-export fix moved "
                               f"{out['png_to_gis']} from the PNG one's")
        out["gis_frame_p50_delta_ms"] = (out["harris_gis"]["frame"]["p50_ms"]
                                         - out["harris"]["frame"]["p50_ms"])
        log(f"[replay harris] frame p50: PNG {out['harris']['frame']} ms, "
            f"GIS export {out['harris_gis']['frame']} ms ({card_label()})")
        rc, rep, launches = _replay_cli([three, "--backend", "classical",
                                         "--out", report])
        s = rep["summary"]
        log(f"[replay classical] rc {rc} {json.dumps(s)}; launches "
            f"{launches}")
        if rc != 0 or s["valid"] != REPLAY_CLASSICAL_FRAMES:
            raise RuntimeError(f"replay classical: rc {rc}, {s}")
        expect_launches("replay classical", launches,
                        {"shear_last_axis": 2 * REPLAY_CLASSICAL_FRAMES,
                         "shear_first_axis": REPLAY_CLASSICAL_FRAMES})
        out["classical"] = {**s, "launches": launches}
        rc, rep, _ = _replay_cli([data, "--weights", "learned_lg9",
                                  "--out", report])
        out["learned_lg9"] = {"rc": rc, **rep["summary"]}
    log("[replay] " + json.dumps(out))
    return out


def phase_jpeg() -> dict:
    """Phase 17: the JPEG codec on seeded world crops (host times), its
    round trip, and its bytes and pixels against OpenCV's digests."""
    from gisnav_tpu_torch.gis.jpeg import decode_jpeg, encode_jpeg
    from gisnav_tpu_torch.gis.png import decode_png, encode_png
    from gisnav_tpu_torch.gis.wms import WMSClient, request_orthoimage
    from gisnav_tpu_torch.native import build_native_lib
    from gisnav_tpu_torch.utils.world_wms import World, WorldWMS

    t0 = time.time()
    lib = build_native_lib("jpeg")
    card = card_label()  # beside every host time of this phase
    log(f"[jpeg] codec {lib} in {time.time() - t0:.1f} s")
    data = encode_jpeg(jpeg_digest_image())
    out = {"sha256": hashlib.sha256(data).hexdigest(),
           "decode_sha256": jpeg_decode_digest(data), "rasters": []}
    log(f"[jpeg] encoder sha256 {out['sha256']} (OpenCV's {JPEG_DIGEST}); "
        f"decoder {out['decode_sha256']} (OpenCV's {JPEG_DECODE_DIGEST})")
    if out["sha256"] != JPEG_DIGEST or \
            out["decode_sha256"] != JPEG_DECODE_DIGEST:
        raise RuntimeError("jpeg: the codec's output is not OpenCV's")
    world = World.make(**GRAPH_WORLD)
    raster = world.raster
    for side, reps in zip(JPEG_SIDES, JPEG_REPS):
        at = (raster.shape[0] - side) // 2  # the world's centre
        grey = raster[at:at + side, at:at + side]
        for kind, img in (("grey", grey), ("bgr420", _tinted(grey))):
            if kind == "bgr420" and side == JPEG_SIDES[0]:
                continue
            jpg, png = encode_jpeg(img), encode_png(img)
            back = decode_jpeg(jpg)
            if back is None or back.shape != img.shape:
                raise RuntimeError(f"jpeg: {side} {kind} round trip gave "
                                   f"{None if back is None else back.shape}")
            err = np.abs(back.astype(np.int32) - img)
            row = {"side": side, "kind": kind, "jpeg_bytes": len(jpg),
                   "png_bytes": len(png),
                   "encode_ms": host_ms(lambda: encode_jpeg(img), 1, reps),
                   "decode_ms": host_ms(lambda: decode_jpeg(jpg), 1, reps),
                   "png_encode_ms": host_ms(lambda: encode_png(img), 1, reps),
                   "png_decode_ms": host_ms(lambda: decode_png(png), 1, reps),
                   "max_err": int(err.max()), "mean_err": float(err.mean())}
            if kind == "bgr420":  # the DEM read: IMREAD_GRAYSCALE, Y only
                row["decode_grey_ms"] = host_ms(
                    lambda: decode_jpeg(jpg, grayscale=True), 1, reps)
            log(f"[jpeg] {json.dumps(row)} ({card})")
            out["rasters"].append(row)
    half = JPEG_FETCH_SIDE_M / 2 / GRAPH_WORLD["gsd_m"]
    x, y = GRAPH_START_PX
    left, top = world.to_lonlat(x - half, y - half)
    right, bottom = world.to_lonlat(x + half, y + half)
    times: dict = {"image/png": [], "image/jpeg": [], "image/tiff": []}
    bbox = (left, bottom, right, top)
    served = world.crop(bbox, 800, 800)
    with WorldWMS(world) as wms:  # the GIS node's fetch: imagery + DEM
        client = WMSClient(wms.url)
        for _ in range(JPEG_FETCHES):
            for fmt in times:
                t = time.perf_counter()
                got = request_orthoimage(client, bbox, (800, 800),
                                         ["imagery"], ["dem"], format_=fmt)
                times[fmt].append((time.perf_counter() - t) * 1e3)
                if got is None or got[0].shape != (800, 800):
                    raise RuntimeError(f"jpeg: the {fmt} map fetch failed")
                if fmt != "image/jpeg" and not np.array_equal(got[0],
                                                              served):
                    raise RuntimeError(f"jpeg: the {fmt} map is not the "
                                       "served raster")
        if wms.formats.get("image/tiff") != 2 * JPEG_FETCHES:
            raise RuntimeError(f"jpeg: the stub answered {wms.formats}")
    out["fetch_p50_ms"] = {fmt: float(np.median(ms))
                           for fmt, ms in times.items()}
    log(f"[jpeg] 800-px map fetch (imagery + DEM, stub WMS) p50 ms: "
        f"{json.dumps(out['fetch_p50_ms'])}; the PNG and TIFF maps equal "
        f"the served raster ({card})")
    out["fixtures"] = check_image_fixtures()
    out["progressive"] = time_progressive_decode(card)
    out["formats"] = time_format_decodes(raster, card)
    return out


def image_writers():
    """``tests/torch_image_writers.py`` of this checkout, loaded by its path
    (a ``tests`` package installed on the host would shadow the
    checkout's)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_image_writers.py")
    spec = importlib.util.spec_from_file_location("torch_image_writers",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_format_decodes(raster: np.ndarray, card: str) -> list:
    """Host ms (``host_ms``, one call, p50 of ``FORMAT_REPS``) of
    ``decode_image`` on the world's centre at 800 and 2208 px as TIFF
    (uncompressed, LZW + predictor 2 and deflate + predictor 2 in 16-row
    strips, deflate + predictor 2 in 256-px tiles) and GIF (a 256-entry grey
    table), beside PNG; each decode must equal the raster it was written
    from (the writers: ``tests/torch_image_writers.py``)."""
    from gisnav_tpu_torch.gis.imgcodecs import decode_image
    from gisnav_tpu_torch.gis.png import encode_png

    writers = image_writers()
    gif_frame, write_gif, write_tiff = (writers.gif_frame, writers.write_gif,
                                        writers.write_tiff)

    grey_table = np.repeat(np.arange(256)[:, None], 3, axis=1)
    rows = []
    for side, reps in zip(JPEG_SIDES, FORMAT_REPS):
        at = (raster.shape[0] - side) // 2
        grey = np.ascontiguousarray(raster[at:at + side, at:at + side])
        files = {
            "png": encode_png(grey),
            "tiff": write_tiff(grey, rows_per_strip=16),
            "tiff_lzw_pred2": write_tiff(grey, compression=5, predictor=2,
                                         rows_per_strip=16),
            "tiff_deflate_pred2": write_tiff(grey, compression=8,
                                             predictor=2, rows_per_strip=16),
            "tiff_tiled_deflate_pred2": write_tiff(
                grey, compression=8, predictor=2, tile=(256, 256)),
            "gif": write_gif(grey.shape, [gif_frame(grey)], grey_table),
        }
        for kind, data in files.items():
            img = decode_image(data)
            want = np.repeat(grey[..., None], 3, axis=2) if kind == "gif" \
                else grey
            if img is None or not np.array_equal(img, want):
                raise RuntimeError(f"formats: the {side}-px {kind} decode "
                                   "is not the raster it was written from")
            row = {"side": side, "kind": kind, "bytes": len(data),
                   "decode_ms": host_ms(lambda: decode_image(data), 1, reps),
                   "card": card}
            log(f"[formats] {json.dumps(row)}")
            rows.append(row)
    return rows


def image_digest(img) -> dict:
    """An array's shape, dtype and sha256, as ``digests.json`` holds
    cv2's (None for None)."""
    if img is None:
        return None
    return {"shape": list(img.shape), "dtype": str(img.dtype),
            "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes())
            .hexdigest()}


def check_image_fixtures() -> dict:
    """Every committed image fixture decoded by ``decode_image`` under
    ``IMREAD_UNCHANGED`` and ``IMREAD_GRAYSCALE``: each digest must be the
    one cv2 gave where the fixtures were written (``digests.json``)."""
    from gisnav_tpu_torch.gis.jpeg import (IMREAD_GRAYSCALE, IMREAD_UNCHANGED,
                                           decode_image)

    with open(os.path.join(IMAGE_FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    flags = {"unchanged": IMREAD_UNCHANGED, "grayscale": IMREAD_GRAYSCALE}
    bad = []
    for name, want in sorted(digests.items()):
        with open(os.path.join(IMAGE_FIXTURES, name), "rb") as f:
            data = f.read()
        if hashlib.sha256(data).hexdigest() != want["file_sha256"]:
            bad.append((name, "file"))
            continue
        for key, flag in flags.items():
            try:
                got = image_digest(decode_image(data, flag))
            except ValueError as e:
                got = f"ValueError: {e}"
            if got != want[key]:
                bad.append((name, key, got))
    out = {"files": len(digests), "decodes": 2 * len(digests),
           "mismatches": len(bad)}
    log(f"[jpeg] image fixtures against cv2's digests: {json.dumps(out)}")
    if bad:
        raise RuntimeError(f"jpeg: fixtures not decoded as cv2: {bad}")
    return out


def time_progressive_decode(card: str) -> dict:
    """Host ms p50 of the progressive 800-px grey fixture's decode beside
    the baseline file of the same pixels (their arrays must be equal)."""
    from gisnav_tpu_torch.gis.jpeg import decode_jpeg

    files = []
    for name in JPEG_PROGRESSIVE_PAIR:
        with open(os.path.join(IMAGE_FIXTURES, name), "rb") as f:
            files.append(f.read())
    prog, base = files
    a, b = decode_jpeg(prog), decode_jpeg(base)
    if a is None or b is None or a.shape != (800, 800) or \
            not np.array_equal(a, b):
        raise RuntimeError("jpeg: the progressive and baseline 800-px "
                           "files decode to different pixels")
    out = {"side": 800, "progressive_bytes": len(prog),
           "baseline_bytes": len(base),
           "progressive_decode_ms": host_ms(lambda: decode_jpeg(prog), 1,
                                            JPEG_PROGRESSIVE_REPS),
           "baseline_decode_ms": host_ms(lambda: decode_jpeg(base), 1,
                                         JPEG_PROGRESSIVE_REPS),
           "card": card}
    log(f"[jpeg] progressive vs baseline decode, host p50: "
        f"{json.dumps(out)}")
    return out


def phase_seed_spread(seeds: int = 12) -> None:
    """How far the cached runner's fix moves with the RANSAC seed: every
    frame of path 2's scene ``seeds`` times (the runner seeds its generator
    with its frame counter), with a prior at the truth and through a
    derotating runner. Prints a table and checks nothing."""
    from gisnav_tpu_torch.geometry.crs import haversine_m
    from gisnav_tpu_torch.pipeline.geopose import geopose_to_wgs84_f64
    from gisnav_tpu_torch.pipeline.runners import make_cached_deep_runner
    from gisnav_tpu_torch.utils.world import render_scene
    from gisnav_tpu_torch.weights import load_bundled

    params, config = load_bundled("learned_lg9")
    config = dataclasses.replace(config, image_shape=(H, W),
                                 max_keypoints=MAX_KP, lightglue_depth=9)
    scene = render_scene(seed=1, h=H, w=W, yaws=CACHED_YAWS, map_side=MAP,
                         coverage=CACHED_COVERAGE)
    for name, derotate in (("prior", False), ("derotate", True)):
        runner = make_cached_deep_runner(params, config, derotate=derotate)
        for i, (yaw, (lon, lat)) in enumerate(zip(scene.yaws,
                                                  scene.truth_lonlat)):
            poses = [runner(scene.frames[i], scene.ortho, scene.dem, yaw,
                            scene.k, scene.crs_affine, map_stamp=1,
                            altitude_agl=scene.alt_m,
                            prior_lonlat=None if derotate else (lon, lat))
                     for _ in range(seeds)]
            fixes = [geopose_to_wgs84_f64(p, scene.crs_affine) for p in poses]
            err = [haversine_m(lat, lon, f["lat"], f["lon"]) for f in fixes]
            inl = [int(p.num_inliers) for p in poses]
            log(f"[seeds {name}] frame {i} yaw {yaw:6.1f}: matches "
                f"{int(poses[0].num_matches)} inliers {min(inl)}-{max(inl)} "
                f"valid {sum(bool(p.valid) for p in poses)}/{seeds} error "
                f"min {min(err):.2f} median {float(np.median(err)):.2f} "
                f"max {max(err):.2f} m")


def phase_digest() -> None:
    """sha256 of kernel outputs on seeded inputs, to hold two sources of the
    kernels bit for bit (run this script from a copy placed beside the other
    source's package): the stem's bf16 output (pool on and off), K3's three
    outputs and K7's at the frame and map sizes, and K6's last-axis shear of
    a 2 x 2048 x 2048 stack at four shifts. Where the package has the
    first-axis shear, its digests too, and it must equal the transpose route
    on the card bit for bit."""
    from gisnav_tpu_torch.features.conv import stem_stage
    from gisnav_tpu_torch.features.nms_kernel import nms_cellmax, nms_select
    from gisnav_tpu_torch.raster import shear_kernel

    def show(what, t):
        digest = hashlib.sha256(
            t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        log(f"[digest] {what}: {digest.hexdigest()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    img = torch.rand((H, W), generator=gen, device="cuda")
    args = (*_conv_weights(gen, 1, 64), *_conv_weights(gen, 64, 64))
    for pool in (True, False):
        show(f"stem {H}x{W} pool={pool}", stem_stage(img, *args, pool=pool))
    for h, w in ((H, W), (MAP, MAP)):
        heat = torch.rand((h, w), generator=gen, device="cuda") ** 8
        for name, t in zip(("cell_max", "cell_x", "cell_y"),
                           nms_select(heat, 4)):
            show(f"nms_select {h}x{w} {name}", t)
        show(f"nms_cellmax {h}x{w}", nms_cellmax(heat, 4))
    stack = torch.rand((2, MAP, MAP), generator=gen, device="cuda")
    first = getattr(shear_kernel, "shear_first_axis", None)
    for shift in (0.41, -0.41, 0.70, -0.999):
        show(f"shear_last_axis 2x{MAP}x{MAP} shift={shift:+.3f}",
             shear_kernel.shear_last_axis(stack, shift, MAP / 2))
        if first is None:
            continue
        out = first(stack, shift, MAP / 2)
        show(f"shear_first_axis 2x{MAP}x{MAP} shift={shift:+.3f}", out)
        route = shear_kernel.shear_last_axis(
            stack.transpose(-1, -2).contiguous(), shift, MAP / 2)
        if not torch.equal(out, route.transpose(-1, -2)):
            raise RuntimeError("shear_first_axis differs from the transpose "
                               "route")
    log("[digest] done")


def _tick_times(tick, ticks: int) -> dict:
    """``ticks`` calls of ``tick(t)`` issued back to back between CUDA
    events: each tick's device-timeline span, the whole window, and the
    kernels launched over it."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(ticks + 1)]
    marks[0].record()
    for t in range(ticks):
        tick(t)
        marks[t + 1].record()
    marks[-1].synchronize()
    ms = [marks[t].elapsed_time(marks[t + 1]) for t in range(ticks)]
    return {"tick_p50_ms": float(np.median(ms)),
            "tick_p90_ms": float(np.percentile(ms, 90)),
            "window_ms": float(marks[0].elapsed_time(marks[-1])),
            "launches": dict(LAUNCHES)}


def phase_multistream_path() -> dict:
    """Path 12: STREAMS camera feeds in one captured graph a tick.

    learned_lg9 in cached mode at 1088x1920 with 2048 keypoints, each
    stream over a map of its own like path 2's (2048 px at 1.3x the
    footprint) at a point of a 150 m ring of one world, the camera 50 m off
    its map's centre (``utils.world.render_streams``): neighbours are 115 m
    apart, and a fix read through another stream's map lands 38 m off, so
    a stream-to-output scramble fails the 10 m gate. Every stream's fix
    within 10 m of its own truth; stream i equal to the single-stream
    graphed frame on the same input and seed (``matches0`` identical, the
    fix within 1 mm), and the sequential capture equal to the forked one;
    then 32 ticks back to back between CUDA events for each of the forked
    capture, the sequential capture and STREAMS single-frame replays, and
    the forked tick's device busy time (torch.profiler over 4 ticks).
    """
    from gisnav_tpu_torch.features.superpoint import SuperPointFeatures
    from gisnav_tpu_torch.pipeline.geopose import (
        build_frame_to_geopose_cached,
        build_models,
        build_reference_extractor,
        geopose_to_wgs84_f64,
    )
    from gisnav_tpu_torch.pipeline.graph import FrameGraph
    from gisnav_tpu_torch.pipeline.multistream import (
        build_multistream_pipeline,
    )
    from gisnav_tpu_torch.pnp.ransac import draw_noise
    from gisnav_tpu_torch.utils.world import render_streams
    from gisnav_tpu_torch.weights import load_bundled, params_from_jax

    t0 = time.time()
    dev = torch.device("cuda")
    scenes = render_streams(seed=12, h=H, w=W, yaws=STREAM_YAWS,
                            map_side=MAP, coverage=CACHED_COVERAGE)
    log(f"[multistream] {STREAMS} scenes in {time.time() - t0:.1f} s")
    params, config = load_bundled("learned_lg9")
    # the cached runner's mean-pool rule at this altitude and map GSD
    s0 = scenes[0]
    gsd_scale = (s0.alt_m / float(s0.k[0, 0])) / abs(float(
        s0.crs_affine[2, 2]))
    ds = next((c for c in (4, 2) if gsd_scale < 0.7 / c * 2), 1)
    cfg = dataclasses.replace(config, image_shape=(H, W),
                              max_keypoints=MAX_KP, lightglue_depth=9,
                              ortho_shape=(MAP, MAP), detector_downsample=ds)
    taps: list = []
    models = _tapped(build_models(params_from_jax(params, dev), cfg), taps)
    extract = build_reference_extractor(cfg)
    refs = [extract(models, torch.as_tensor(s.ortho, device=dev).float()
                    / 255.0) for s in scenes]
    ref_feats = SuperPointFeatures(*(torch.stack(f) for f in zip(*refs)))
    queries = torch.stack([torch.as_tensor(s.frames[0], device=dev).float()
                           / 255.0 for s in scenes])
    dems = torch.stack([torch.as_tensor(s.dem, device=dev) for s in scenes])
    ks, affs = (torch.stack([torch.as_tensor(np.asarray(getattr(s, a),
                                                        np.float32),
                                             device=dev) for s in scenes])
                for a in ("k", "crs_affine"))
    batch = (queries, ref_feats, dems, ks, affs)
    gens = [torch.Generator(device=dev) for _ in range(STREAMS)]

    def seeded(t):
        for i, g in enumerate(gens):
            g.manual_seed(1000 * t + i + 1)
        return gens

    def fixes(out, shift=0):
        """Stream i's fix, read through stream (i + shift)'s map, and its
        error against that stream's truth."""
        from gisnav_tpu_torch.geometry.crs import haversine_m

        rows = []
        for i in range(STREAMS):
            j = (i + shift) % STREAMS
            pose = type(out)(*(f[i] for f in out))
            fix = geopose_to_wgs84_f64(pose, scenes[j].crs_affine)
            lon, lat = scenes[j].truth_lonlat[0]
            rows.append((pose, fix, haversine_m(lat, lon, fix["lat"],
                                                fix["lon"])))
        return rows

    forked = build_multistream_pipeline(cfg)
    sequential = build_multistream_pipeline(cfg, fork_streams=False)
    forked(models, *batch, seeded(0))  # captures; the warm-up's result
    out = forked(models, *batch, seeded(1))
    m0_forked = [m.clone() for m in taps[-STREAMS:]]
    rows = fixes(out)
    for i, (pose, fix, err) in enumerate(rows):
        _gate(pose, err, fix, f"[multistream] stream {i}")
    scrambled = [err for _, _, err in fixes(out, shift=1)]
    if min(scrambled) < 10.0:
        raise RuntimeError(f"path 12: a scrambled stream passes the 10 m "
                           f"gate ({min(scrambled):.2f} m)")

    # each stream against the single-stream graphed frame, same seed
    frame = build_frame_to_geopose_cached(cfg)
    single = FrameGraph(
        lambda q, feats, dem, k, aff, noise: frame(
            models, q, feats, dem, k, aff, noise=noise),
        dev, sticky=(1, 2))

    def one(i, t):
        feats = SuperPointFeatures(*(f[i] for f in ref_feats))
        gens[i].manual_seed(1000 * t + i + 1)
        return single(queries[i], feats, dems[i], ks[i], affs[i],
                      draw_noise(gens[i], cfg.num_hypotheses,
                                 cfg.max_keypoints))

    one(0, 0)  # captures
    moved = []
    for i in range(STREAMS):
        pose = one(i, 1)
        stream = type(out)(*(f[i] for f in out))
        if not (torch.equal(taps[-1], m0_forked[i])
                and _same_pose(pose, stream)):
            raise RuntimeError(f"path 12: stream {i} differs from its "
                               f"single-stream frame")
        moved.append(_fix_moved(rows[i][1], geopose_to_wgs84_f64(
            pose, scenes[i].crs_affine)))
    sequential(models, *batch, seeded(0))  # captures
    seq = sequential(models, *batch, seeded(1))
    for i, (pose, fix, _) in enumerate(fixes(seq)):
        stream = type(out)(*(f[i] for f in out))
        if not (torch.equal(taps[-STREAMS + i], m0_forked[i])
                and _same_pose(pose, stream)):
            raise RuntimeError(f"path 12: the sequential capture differs "
                               f"from the forked one on stream {i}")
        moved.append(_fix_moved(rows[i][1], fix))
    if max(moved) > 1e-3:
        raise RuntimeError(f"path 12: a stream's fix moved {max(moved)} m "
                           f"between captures")

    per_frame = {"stem_stage": 1, "conv_stage": 8, "nms_select": 1,
                 "fused_block": 72}  # path 2's cached frame at 2048
    modes = {
        "forked": lambda t: forked(models, *batch, seeded(t + 2)),
        "sequential": lambda t: sequential(models, *batch, seeded(t + 2)),
        "single_frames": lambda t: [one(i, t + 2) for i in range(STREAMS)],
    }
    out_modes = {}
    for name, tick in modes.items():
        r = _tick_times(tick, MULTISTREAM_TICKS)
        expect_launches(f"multistream {name}", r["launches"],
                        {k: n * STREAMS * MULTISTREAM_TICKS
                         for k, n in per_frame.items()})
        r["stream_frames_per_s"] = (STREAMS * MULTISTREAM_TICKS
                                    / r["window_ms"] * 1e3)
        out_modes[name] = r
        log(f"[multistream] {name}: {r['stream_frames_per_s']:.1f} "
            f"stream-frames/s, tick p50 {r['tick_p50_ms']:.2f} ms, p90 "
            f"{r['tick_p90_ms']:.2f} ms")
    busy = profile_frames(modes["forked"], list(range(4)), n=4,
                          union=True)
    (graph,) = forked.graphs.values()
    single = None  # the graphs of path 12 go: path 13 captures its own
    sequential.graphs.clear()
    result = {
        "streams": STREAMS, "detector_downsample": ds,
        "max_error_m": float(max(r[2] for r in rows)),
        "min_scrambled_error_m": float(min(scrambled)),
        "max_fix_move_m": float(max(moved)), **out_modes,
        "forked_busy_ms": busy,
        "forked_idle_share": 1.0 - busy / out_modes["forked"]["tick_p50_ms"],
        "launches_a_tick": {k: n // MULTISTREAM_TICKS for k, n in
                            out_modes["forked"]["launches"].items()},
        "capture_ms": graph.capture_ms,
        "graph_pool_mib": graph.pool_bytes / 2 ** 20,
        "seconds": time.time() - t0}
    log("[multistream] " + json.dumps(result))
    forked.graphs.clear()
    del graph
    torch.cuda.empty_cache()
    # what path 13 runs again over a mesh: the feeds, the draws and the
    # forked tick's output at seed 1
    result["feeds"] = {"scenes": scenes, "config": cfg, "params": params,
                       "batch": batch, "seeded": seeded, "out": out,
                       "per_frame": per_frame}
    return result


def _mesh_devices(slots: int = 8) -> list:
    """Every card there is, cycled to ``slots`` mesh slots."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(slots)]


def _layout(mesh) -> list:
    return [[str(d) for d in row] for row in mesh.devices]


def mesh_feeds(path12: dict) -> dict:
    """Path 13 (a): path 12's 8 feeds over a (data, model) mesh at model 1
    (4 x 1) and model 2 (4 x 2), each row its 2 streams with its own tree
    of the weights (``shard_params_tp``) and its own draws."""
    from gisnav_tpu_torch.geometry.crs import haversine_m
    from gisnav_tpu_torch.parallel import make_mesh, shard_params_tp
    from gisnav_tpu_torch.pipeline.geopose import (
        build_models,
        geopose_to_wgs84_f64,
    )
    from gisnav_tpu_torch.pipeline.multistream import (
        build_mesh_multistream_pipeline,
        shard_stream_batch,
    )
    from gisnav_tpu_torch.weights import params_from_jax

    feeds = path12["feeds"]
    scenes, cfg, seeded = feeds["scenes"], feeds["config"], feeds["seeded"]
    tree = params_from_jax(feeds["params"], feeds["batch"][0].device)
    devs = _mesh_devices()
    outs, result = {}, {}
    for model in (1, 2):
        t0 = time.time()
        mesh = make_mesh(4 * model, model_parallel=model,
                         devices=devs[:4 * model])
        rows = [build_models(t, cfg) for t in shard_params_tp(mesh, tree)]
        blocks = shard_stream_batch(mesh, feeds["batch"])
        fn = build_mesh_multistream_pipeline(cfg)
        fn(mesh, rows, blocks, seeded(0))  # captures the graphed rows
        out = outs[model] = fn(mesh, rows, blocks, seeded(1))
        errors = []
        for i, sc in enumerate(scenes):
            pose = type(out)(*(f[i] for f in out))
            fix = geopose_to_wgs84_f64(pose, sc.crs_affine)
            lon, lat = sc.truth_lonlat[0]
            errors.append(haversine_m(lat, lon, fix["lat"], fix["lon"]))
            _gate(pose, errors[-1], fix, f"[mesh] model {model} stream {i}")
            if model == 1:  # path 12's graphed tick, stream by stream
                want = type(out)(*(f[i] for f in feeds["out"]))
                moved = _fix_moved(fix, geopose_to_wgs84_f64(
                    want, sc.crs_affine))
                if not (_same_pose(pose, want) and moved < 1e-3):
                    raise RuntimeError(f"path 13: stream {i} at model 1 "
                                       f"differs from path 12's tick "
                                       f"({moved} m)")
        r = _tick_times(lambda t: fn(mesh, rows, blocks, seeded(t + 2)),
                        MULTISTREAM_TICKS)
        expect_launches(f"mesh model {model}", r["launches"], {
            k: n * STREAMS * MULTISTREAM_TICKS
            for k, n in feeds["per_frame"].items()})
        r.update(layout=_layout(mesh), modes=dict(fn.modes),
                 max_error_m=float(max(errors)),
                 stream_frames_per_s=STREAMS * MULTISTREAM_TICKS
                 / r["window_ms"] * 1e3,
                 launches_a_tick={k: n // MULTISTREAM_TICKS
                                  for k, n in r["launches"].items()},
                 seconds=time.time() - t0)
        result[f"model{model}"] = r
        p12 = path12["forked"]
        log(f"[mesh] model {model} layout {r['layout']} rows {r['modes']}: "
            f"{r['stream_frames_per_s']:.1f} stream-frames/s, tick p50 "
            f"{r['tick_p50_ms']:.2f} ms, p90 {r['tick_p90_ms']:.2f} ms "
            f"(path 12's forked tick: {p12['stream_frames_per_s']:.1f} "
            f"stream-frames/s, p50 {p12['tick_p50_ms']:.2f} ms)")
        fn.graphs.clear()
        del rows, blocks, fn
        torch.cuda.empty_cache()
    # TP2 against TP1: the JAX test's own bound
    d = (outs[2].lon_lat_alt[:, :2] - outs[1].lon_lat_alt[:, :2]).abs()
    result["tp2_vs_tp1_max_deg"] = float(d.max())
    result["tp2_vs_tp1_max_m"] = max(_fix_moved(
        geopose_to_wgs84_f64(type(outs[2])(*(f[i] for f in outs[2])),
                             sc.crs_affine),
        geopose_to_wgs84_f64(type(outs[1])(*(f[i] for f in outs[1])),
                             sc.crs_affine)) for i, sc in enumerate(scenes))
    result["tp2_matches_equal"] = all(
        torch.equal(getattr(outs[2], f), getattr(outs[1], f))
        for f in ("matched_qry", "matched_ref", "num_matches"))
    if not (result["tp2_vs_tp1_max_deg"] <= 2e-5
            and torch.equal(outs[2].valid, outs[1].valid)):
        raise RuntimeError(f"path 13: TP2 off TP1 by "
                           f"{result['tp2_vs_tp1_max_deg']} deg")
    result["path12_forked"] = {k: path12["forked"][k] for k in (
        "stream_frames_per_s", "tick_p50_ms", "tick_p90_ms")}
    return result


def mesh_train(path9_steps_per_s=None) -> dict:
    """Path 13 (b): path 9 (a)'s config (128x160, 256 keypoints,
    LightGlue-3, batch 8) on the (4 x 2) mesh against the replicated step
    from the same state and batch, then 10 mesh steps."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.parallel import make_mesh
    from gisnav_tpu_torch.parallel.mesh import shard_batch
    from gisnav_tpu_torch.parallel.tp import Sharded, gather_tree, leaves
    from gisnav_tpu_torch.train.data import make_homography_batch
    from gisnav_tpu_torch.train.steps import (
        TrainConfig,
        init_train_state,
        make_mesh_train_step,
        make_train_step,
        relative_error,
        shard_train_state,
        tree_grads,
        tree_leaves,
    )

    t0 = time.time()
    config = TrainConfig()
    lr = config.learning_rate

    def fresh():
        return init_train_state(torch.Generator().manual_seed(2), config,
                                TRAIN_DEVICE)

    args = tuple(torch.as_tensor(a, device=TRAIN_DEVICE) for a in
                 make_homography_batch(np.random.default_rng(3),
                                       TRAIN_BATCH, config.image_shape))
    state, tx = fresh()
    replicated = make_train_step(config, tx)
    state, m = replicated(state, *args)
    mesh = make_mesh(8, model_parallel=2, devices=_mesh_devices())
    mstate = shard_train_state(mesh, fresh()[0], tx)
    step = make_mesh_train_step(config, tx)
    blocks = shard_batch(mesh, args)
    mstate, mm = step(mstate, blocks)
    loss, ref = float(mm["loss"]), float(m["loss"])
    rows = [gather_tree(r.params) for r in mstate.rows]
    with torch.no_grad():
        worst = max(float((a.to(b.device) - b).abs().max()) for a, b in zip(
            tree_leaves(rows[0]), tree_leaves(state.params)))
        spread = max(float((a.to(b.device) - b).abs().max())
                     for tree in rows for a, b in zip(
                         tree_leaves(tree), tree_leaves(rows[0])))
    sharded = sum(isinstance(leaf, Sharded) for leaf in leaves(
        mstate.rows[-1].params))
    # Adam's first step moves each parameter by about lr whatever its
    # gradient, so the gradient the update read is held too: the worst
    # leaf against the replicated step's, and, to show the gate sees a
    # wrong mean, the gradient of row 0's block alone
    ref_grads = tree_leaves(tree_grads(state.params))

    def worst_grad(params):
        return max(relative_error(a, b) for a, b in zip(
            tree_leaves(gather_tree(tree_grads(params))), ref_grads))

    grad_worst = [worst_grad(r.params) for r in mstate.rows]
    row0_state = fresh()[0]
    make_train_step(config, tx).eager(row0_state, *blocks[0])
    row0_grad = worst_grad(row0_state.params)
    log(f"[mesh train] layout {_layout(mesh)}: loss {loss:.6f} against the "
        f"replicated step's {ref:.6f}, parameters within {worst:.3g} "
        f"(5 lr = {5 * lr:.3g}), replicas {spread} apart, {sharded} "
        f"sharded leaves a row; gradient's worst leaf {grad_worst} "
        f"relative (gate {MESH_GRAD_RTOL}; row 0's block alone "
        f"{row0_grad:.4g})")
    if not (abs(loss - ref) <= 1e-2 * abs(ref) and worst < 5 * lr
            and spread == 0.0 and sharded > 0
            and max(grad_worst) < MESH_GRAD_RTOL < row0_grad):
        raise RuntimeError("path 13: the mesh train step disagrees with "
                           "the replicated one")
    timed = {}
    for name, fn in (("mesh", lambda: step(mstate, blocks)),
                     ("replicated", lambda: replicated(state, *args))):
        torch.cuda.synchronize()
        reset_launches()
        losses, start = [], time.perf_counter()
        for _ in range(10):
            losses.append(fn()[1]["loss"])
        torch.cuda.synchronize()
        timed[name] = {"steps_per_s": 10 / (time.perf_counter() - start),
                       "launches": dict(LAUNCHES),
                       "losses": [float(v) for v in losses]}
        if not all(np.isfinite(timed[name]["losses"])):
            raise RuntimeError(f"path 13: a {name} step's loss is not "
                               f"finite")
    expect_launches("mesh train", timed["mesh"]["launches"], {
        "masked_attention": 10 * TRAIN_K5_STEP * len(mstate.rows)})
    out = {"layout": _layout(mesh), "loss": loss, "replicated_loss": ref,
           "max_param_diff": worst, "replica_spread": spread,
           "grad_worst_leaf_rel": grad_worst,
           "row0_only_grad_worst_leaf_rel": row0_grad,
           "sharded_leaves": sharded, "graphs": len(step.graphs),
           **{f"{k}_steps_per_s": v["steps_per_s"]
              for k, v in timed.items()},
           "path9_steps_per_s": path9_steps_per_s,
           "launches_10_steps": timed["mesh"]["launches"],
           "mesh_losses": timed["mesh"]["losses"],
           "seconds": time.time() - t0}
    log(f"[mesh train] 10 steps: mesh {out['mesh_steps_per_s']:.2f} "
        f"steps/s, replicated {out['replicated_steps_per_s']:.2f} steps/s "
        f"(path 9 (a): {path9_steps_per_s})")
    return out


def phase_mesh_path(path12: dict, path9_steps_per_s=None) -> dict:
    """Path 13: the (data, model) mesh laid over every card there is."""
    t0 = time.time()
    out = {"cards": torch.cuda.device_count(), "feeds": mesh_feeds(path12),
           "train": mesh_train(path9_steps_per_s)}
    out["seconds"] = time.time() - t0
    log("[mesh] " + json.dumps(out))
    return out


def phase_cellmax_stage() -> int:
    """The NMS cell-max stage on a frame-sized and a map-sized heatmap, as
    the JAX package's stage bench runs its kernel; returns the launches."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.features.nms_kernel import nms_cellmax

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    reset_launches()
    for h, w in ((H, W), (MAP, MAP)):
        heat = torch.rand((h, w), generator=gen, device="cuda") ** 8
        cells = nms_cellmax(heat, 4)
        torch.cuda.synchronize()
        if cells.shape != (h // 4, w // 4) or not (
                torch.isfinite(cells).all() and float(cells.max()) > 0):
            raise RuntimeError("nms_cellmax stage gave no cell maxima")
    launches = dict(LAUNCHES)
    expect_launches("cell-max stage", launches, {"nms_cellmax": 2})
    log(f"[cellmax] launches: {launches}")
    return launches["nms_cellmax"]


def main_scene():
    """Path 1's seeded 1088x1920 scene (frames at ``MAIN_YAWS`` then
    ``MAIN_CYCLE_YAWS``)."""
    from gisnav_tpu_torch.utils.world import render_scene

    return render_scene(seed=0, h=H, w=W, yaws=MAIN_YAWS + MAIN_CYCLE_YAWS)


def phase_main_path() -> dict:
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.runners import make_bucketed_warp_runner
    from gisnav_tpu_torch.weights import load_bundled

    t0 = time.time()
    yaws = MAIN_YAWS
    scene = main_scene()
    params, config = load_bundled("learned_lg9")
    config = dataclasses.replace(config, image_shape=(H, W),
                                 max_keypoints=MAX_KP, lightglue_depth=9)
    runner = make_bucketed_warp_runner(params, config, bucket_deg=15.0)
    log(f"[main] scene {scene.ortho.shape} + runner in "
        f"{time.time() - t0:.1f} s")
    errors = []

    def run_frame(i: int, tag: str = "") -> float:
        ms, err = fly(runner, scene, i, tag and f"[main] {tag} bucket "
                      f"{round(scene.yaws[i] / 15.0)}")
        errors.append(err)
        return ms

    # one untimed frame loads the kernels and warms the allocator; the
    # counts start at 0 after it
    run_frame(0)

    # the main path: 8 frames over 3 buckets, the counts read after them
    reset_launches()
    for i in range(len(yaws)):
        run_frame(i, f"frame {i}")
    launches = dict(LAUNCHES)
    log(f"[main] launches over {len(yaws)} frames: {launches}")
    missing = [k for k in PATH1_KERNELS if launches[k] == 0]
    if missing:
        raise RuntimeError(f"main path never launched {missing}")

    # timing window. Refresh: one frame per bucket of 7, cycled; more
    # buckets than the 4-entry LRU in a fixed order miss on every frame
    # after the first cycle, so the 2 cycles after it are all refreshes.
    # Cached: then the frames of the last 4 buckets, cycled, all hits.
    cycle = [0, 3, 5] + list(range(len(yaws), len(scene.yaws)))
    for i in cycle:
        run_frame(i)
    refresh_ms = [run_frame(i) for i in cycle * 2]
    last4 = cycle[-4:]
    # the cached frames replay the runner's graph; each is kept with its
    # RANSAC seed for the eager program to run again
    cached_ms, graphed = [], []
    for j in range(CACHED_FRAMES):
        i = last4[j % 4]
        pose, ms, err, fix = _frame(runner, scene, i)
        _gate(pose, err, fix, f"[main] cached frame {j} (yaw "
                              f"{scene.yaws[i]})")
        errors.append(err)
        cached_ms.append(ms)
        # the LRU's newest entry is the bucket this frame matched against
        bucket = runner.buckets[next(reversed(runner.buckets))]
        graphed.append((i, runner.stats["frames"], pose, fix, bucket))
    p50 = float(np.median(cached_ms))
    out = {"frame_p50_ms": p50,
           "frame_p90_ms": float(np.percentile(cached_ms, 90)),
           "refresh_frame_p50_ms": float(np.median(refresh_ms)),
           "bucket_refresh_ms": float(np.median(refresh_ms)) - p50,
           "cached_frames": len(cached_ms), "refresh_frames": len(refresh_ms),
           "fixes": len(errors), "max_error_m": float(max(errors)),
           "mean_error_m": float(np.mean(errors)), "launches": launches}
    out["graph"] = graph_vs_eager(runner, scene, config, graphed, run_frame,
                                  last4)
    out["refresh"] = refresh_vs_eager(runner, scene, config, cycle)
    out["device_busy_ms"] = out["graph"]["graphed_busy_ms"]
    out["device_idle_share"] = 1.0 - out["device_busy_ms"] / p50
    log("[main] " + json.dumps(out))
    out["scene"], out["params"], out["config"] = scene, params, config
    return out


def _tapped(models, taps: list):
    """``models`` whose LightGlue also appends its ``matches0`` to
    ``taps``: inside a captured graph the tensor kept there is the graph's
    own, which each replay rewrites."""
    lightglue = models["lightglue"]

    def tap(*args):
        match = lightglue(*args)
        taps.append(match.matches0)
        return match

    return {**models, "lightglue": tap}


def _same_pose(a, b) -> bool:
    """The match and inlier fields of two poses identical."""
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in (
        "matched_qry", "matched_ref", "match_mask", "num_matches",
        "num_inliers", "valid"))


def _fix_moved(a: dict, b: dict) -> float:
    """Metres between two f64 fixes, horizontally and in altitude."""
    from gisnav_tpu_torch.geometry.crs import haversine_m

    return max(haversine_m(a["lat"], a["lon"], b["lat"], b["lon"]),
               abs(a["alt_ellipsoid"] - b["alt_ellipsoid"]))


def graph_vs_eager(runner, scene, config, graphed, run_frame, last4) -> dict:
    """Path 1, graphed against eager on the same cached frames.

    The runner's frames replayed its captured program; here
    ``build_frame_to_geopose_warpcached`` runs each again eagerly, on the
    same bucket features and with RANSAC's noise from the same seed: the
    matches and inliers must be identical and the fix within 1 mm. A tapped
    copy of the program (LightGlue's ``matches0`` and RANSAC's sample
    indices as outputs) is captured as well and held against its eager run
    on 16 of the frames: ``matches0`` and the indices identical. Both
    sides' device busy time comes from torch.profiler over 10 frames.
    """
    from gisnav_tpu_torch.pipeline.geopose import (
        build_frame_to_geopose_warpcached,
        geopose_to_wgs84_f64,
    )
    from gisnav_tpu_torch.pipeline.graph import FrameGraph
    from gisnav_tpu_torch.pnp.ransac import draw_noise, draw_samples

    dev = torch.device("cuda")
    hot = build_frame_to_geopose_warpcached(config)
    models = runner.models
    gen = torch.Generator(device=dev)
    k, aff = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
              for a in (scene.k, scene.crs_affine))

    def inputs(i, seed, bucket):
        q = torch.as_tensor(scene.frames[i].astype(np.float32),
                            device=dev) / 255.0
        gen.manual_seed(seed)
        return (q, *bucket, draw_noise(gen, config.num_hypotheses,
                                       config.max_keypoints))

    def eager(i, seed, bucket):
        q, feats, dem, m_crop, noise = inputs(i, seed, bucket)
        return hot(models, q, feats, dem, m_crop, k, aff, noise=noise)

    first = (graphed[0][0], graphed[0][1], graphed[0][4])
    eager_ms, moved = [], []
    eager(*first)  # once untimed, as the runner's first frame
    for i, seed, pose, fix, bucket in graphed:
        torch.cuda.synchronize()
        t = time.perf_counter()
        e = eager(i, seed, bucket)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t) * 1e3)
        if not _same_pose(pose, e):
            raise RuntimeError(f"path 1: graphed and eager frames differ "
                               f"in their matches (frame {i})")
        moved.append(_fix_moved(fix, geopose_to_wgs84_f64(
            e, scene.crs_affine)))
    if max(moved) > 1e-3:
        raise RuntimeError(f"path 1: graphed fix {max(moved)} m from the "
                           f"eager one")

    # the tapped program, graphed and eager
    taps: list = []
    tapped_models = _tapped(models, taps)

    def tapped(q, feats, dem, m_crop, k_, aff_, noise):
        def samples(mask, _):
            idx = draw_samples(mask, config.num_hypotheses, noise=noise)
            taps.append(idx)
            return idx

        pose = hot(tapped_models, q, feats, dem, m_crop, k_, aff_,
                   sample_idx=samples)
        return pose, taps[-2], taps[-1]

    program = FrameGraph(tapped, dev, sticky=(1, 2, 3))
    q, feats, dem, m_crop, noise = inputs(*first)
    program(q, feats, dem, m_crop, k, aff, noise)  # captures
    for i, seed, _, _, bucket in graphed[:16]:
        q, feats, dem, m_crop, noise = inputs(i, seed, bucket)
        g_pose, g_m0, g_idx = program(q, feats, dem, m_crop, k, aff, noise)
        e_pose, e_m0, e_idx = tapped(q, feats, dem, m_crop, k, aff, noise)
        if not (torch.equal(g_m0, e_m0) and torch.equal(g_idx, e_idx)
                and _same_pose(g_pose, e_pose)):
            raise RuntimeError(f"path 1: the graphed program's matches0 or "
                               f"RANSAC indices differ from eager (frame "
                               f"{i})")
        moved.append(_fix_moved(
            geopose_to_wgs84_f64(g_pose, scene.crs_affine),
            geopose_to_wgs84_f64(e_pose, scene.crs_affine)))
    if max(moved) > 1e-3:
        raise RuntimeError(f"path 1: tapped graph {max(moved)} m from eager")

    busy_graphed = profile_frames(run_frame, last4)
    buckets = {row[0]: row[4] for row in graphed}
    busy_eager = profile_frames(
        lambda i: eager(i, graphed[0][1], buckets[i]), last4)
    (graph,) = (g for key, g in runner.graphs.items() if key[0] == "frame")
    out = {"eager_p50_ms": float(np.median(eager_ms)),
           "eager_p90_ms": float(np.percentile(eager_ms, 90)),
           "graphed_busy_ms": busy_graphed, "eager_busy_ms": busy_eager,
           "eager_idle_share": 1.0 - busy_eager / float(np.median(eager_ms)),
           "frames_compared": len(graphed), "tapped_frames_compared": 16,
           "max_fix_move_m": float(max(moved)),
           "capture_ms": graph.capture_ms,
           "graph_pool_mib": graph.pool_bytes / 2 ** 20,
           "replays": graph.replays, "launches_a_replay": graph.launches}
    log("[main graph] " + json.dumps(out))
    return out


# --- every other program the JAX package jits, graphed against eager ------


def _on_card(tree):
    """A tree of tensors (host or card) moved to the card, as a graph's
    copy-in does."""
    if isinstance(tree, torch.Tensor):
        return tree.cuda()
    if isinstance(tree, dict):
        return {k: _on_card(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [_on_card(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            type(tree)(items)
    return tree


class GraphSide:
    """Runs the port's ``FrameGraph``s one of three ways, for the
    comparisons of this script (the package itself never runs a graphed
    program eagerly on the card):

    - ``graphed``: as the package runs them, each capture noting which of
      ``taps`` it made (the ones each replay rewrites);
    - ``eager``: every call runs the program's function on the card on the
      same inputs, op by op, and no graph is captured or replayed;
    - ``shadow``: every replay is followed by the same function run
      eagerly on the same inputs and held against it (``rows``: whether
      every output, and every tap, is identical; the fix's move; the
      replay's and the eager run's host ms; ``calls`` counts every graph
      call, ``added_ms`` sums the host ms the shadow spent on a compared
      call besides its eager run: the replay, the taps, the comparison,
      so a frame's ms less it is the frame's ms with its programs run
      eagerly). ``taps`` collects what the
      program's taps append (LightGlue's ``matches0`` or LoFTR's mask,
      RANSAC's sample indices): inside a graph the capture's own tensors,
      which each replay rewrites.

    Training graphs (``grad=True``) are never shadowed: an eager run would
    take another optimizer step.
    """

    def __init__(self, mode: str, aff=None, taps=None):
        self.mode, self.aff = mode, aff
        self.taps = taps if taps is not None else []
        self.rows: list = []
        self.calls, self.added_ms = 0, 0.0

    def __enter__(self):
        from gisnav_tpu_torch.pipeline.graph import FrameGraph

        self._orig = FrameGraph.__call__
        side = self

        def call(graph, *args):
            if side.mode == "eager":
                return side._eager(graph, args)
            return side._shadow(graph, args, side.mode == "shadow")

        FrameGraph.__call__ = call
        return self

    def __exit__(self, *exc):
        from gisnav_tpu_torch.pipeline.graph import FrameGraph

        FrameGraph.__call__ = self._orig

    @staticmethod
    def _eager(graph, args):
        from gisnav_tpu_torch.device import strict_fp32

        strict_fp32()
        with torch.no_grad():
            return graph.fn(*_on_card(args))

    def _shadow(self, graph, args, compare: bool = True):
        t0 = time.perf_counter()
        self.calls += 1
        first = graph._graph is None
        n0 = len(self.taps)
        if first or not compare or graph.grad:
            out = self._orig(graph, *args)
            if first:  # warm-up and capture each tapped k tensors
                k = (len(self.taps) - n0) // 2
                graph.taps = self.taps[len(self.taps) - k:]
            return out
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = self._orig(graph, *args)
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t) * 1e3
        g_taps = [x.clone() for x in getattr(graph, "taps", [])]
        n1 = len(self.taps)
        t = time.perf_counter()
        want = self._eager(graph, args)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t) * 1e3
        same, moved = _held(out, want, g_taps, self.taps[n1:], self.aff)
        self.rows.append((same, moved, replay_ms, eager_ms))
        self.added_ms += (time.perf_counter() - t0) * 1e3 - eager_ms
        return out


def _held(out, want, g_taps, e_taps, aff) -> tuple:
    """(identical?, fix move in m) of a replay's output against the eager
    run's: a GeoPose's matches, inliers and taps identical and its fix
    moved; filter states within 1e-6 relative; anything else bit-equal."""
    from gisnav_tpu_torch.fusion.ekf import EKFState
    from gisnav_tpu_torch.pipeline.geopose import GeoPose, geopose_to_wgs84_f64
    from gisnav_tpu_torch.pipeline.graph import _flatten

    taps_same = len(g_taps) == len(e_taps) and all(
        torch.equal(a, b) for a, b in zip(g_taps, e_taps))
    if isinstance(out, GeoPose):
        moved = _fix_moved(geopose_to_wgs84_f64(out, aff),
                           geopose_to_wgs84_f64(want, aff))
        return _same_pose(out, want) and taps_same, moved
    if isinstance(out, EKFState):
        return taps_same and all(
            float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
            for a, b in zip(out, want)), 0.0
    a, b = _flatten(out)[0], _flatten(want)[0]
    return taps_same and len(a) == len(b) and all(
        torch.equal(x, y) for x, y in zip(a, b)), 0.0


def tap_programs(models: dict, taps: list) -> None:
    """Make ``models``' matcher (LightGlue's ``matches0``, LoFTR's mask)
    append what it finds to ``taps``, in place (a runner's graphs captured
    after this call hold the taps)."""
    for name, field in (("lightglue", "matches0"), ("loftr", "mask")):
        if name in models:
            inner = models[name]

            def tapped(*args, inner=inner, field=field):
                out = inner(*args)
                taps.append(getattr(out, field))
                return out

            models[name] = tapped


class TappedRansac:
    """Within the block, RANSAC's sample indices are appended to ``taps``
    (``pnp.ransac.draw_samples`` wrapped where ``ransac_pnp`` reads it)."""

    def __init__(self, taps: list):
        self.taps = taps

    def __enter__(self):
        from gisnav_tpu_torch.pnp import ransac

        self._orig = ransac.draw_samples
        taps, orig = self.taps, self._orig

        def draw(*a, **kw):
            idx = orig(*a, **kw)
            taps.append(idx)
            return idx

        ransac.draw_samples = draw
        return self

    def __exit__(self, *exc):
        from gisnav_tpu_torch.pnp import ransac

        ransac.draw_samples = self._orig


def graphed_vs_eager(tag: str, run_frame, frames, graphed_ms, aff, taps,
                     profile_n: int = 4, eager_profile_n: int = 2,
                     max_move_m: float = 1e-3) -> dict:
    """A path's frames (``run_frame(i)``, graphs inside) shadowed: each
    replay held against its eager run (taps and matches identical, the fix
    within ``max_move_m``). A frame's eager ms is its shadowed ms less what
    the shadow added besides the eager runs (``GraphSide``), over the
    frames whose every graph call was compared; their p50 / p90 stand
    beside the graphed ``graphed_ms``, with each side's device busy ms
    (torch.profiler over ``profile_n`` frames graphed and
    ``eager_profile_n`` eager) and idle share against its p50."""
    eager_ms = []
    with GraphSide("shadow", aff, taps) as side:
        for i in frames:
            rows, calls, added = len(side.rows), side.calls, side.added_ms
            torch.cuda.synchronize()
            t = time.perf_counter()
            run_frame(i)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            if side.calls - calls == len(side.rows) - rows > 0:
                eager_ms.append(ms - (side.added_ms - added))
    bad = [r for r in side.rows if not r[0]]
    moved = max((r[1] for r in side.rows), default=0.0)
    if not eager_ms or bad or moved > max_move_m:
        raise RuntimeError(f"{tag}: {len(bad)} of {len(side.rows)} replays "
                           f"differ from eager, fix moved {moved} m, "
                           f"{len(eager_ms)} frames compared whole")
    with GraphSide("eager"):
        busy_eager = profile_frames(run_frame, frames, n=eager_profile_n)
    busy = profile_frames(run_frame, frames, n=profile_n)
    g50, e50 = float(np.median(graphed_ms)), float(np.median(eager_ms))
    out = {"graphed_p50_ms": g50,
           "graphed_p90_ms": float(np.percentile(graphed_ms, 90)),
           "eager_p50_ms": e50,
           "eager_p90_ms": float(np.percentile(eager_ms, 90)),
           "eager_frames": len(eager_ms),
           "graphed_busy_ms": busy, "eager_busy_ms": busy_eager,
           "graphed_idle_share": 1.0 - busy / g50,
           "eager_idle_share": 1.0 - busy_eager / e50,
           "replays_compared": len(side.rows), "max_fix_move_m": moved,
           "replay_ms_p50": float(np.median([r[2] for r in side.rows])),
           "shadow_eager_ms_p50": float(np.median([r[3]
                                                   for r in side.rows]))}
    log(f"[{tag} graph vs eager] " + json.dumps(out))
    return out


def refresh_vs_eager(runner, scene, config, cycle) -> dict:
    """Path 1's bucket refresh, graphed against eager, on each bucket of
    the refresh cycle: the runner's refresh graph (angle and zoom () inputs)
    replayed and the extractor run eagerly on the same inputs (features,
    DEM crop and crop matrix identical); the card's crop matrix within 1
    f32 ulp (of its largest entry) of the one the host built before this
    port built it on the device (``crop_to_original`` of host numbers on
    the CPU), and the frame's fix through either matrix within 1 mm. Both
    sides' refresh ms and device busy ms."""
    from gisnav_tpu_torch.pipeline.geopose import (
        build_frame_to_geopose_warpcached,
        build_warp_reference_extractor,
        geopose_to_wgs84_f64,
    )
    from gisnav_tpu_torch.pnp.ransac import draw_noise
    from gisnav_tpu_torch.raster.warp import crop_to_original

    dev = torch.device("cuda")
    models = runner.models
    graph = runner.graphs[("refresh", tuple(scene.ortho.shape))]
    extract = build_warp_reference_extractor(config)
    hot = build_frame_to_geopose_warpcached(config)
    ortho = torch.as_tensor(scene.ortho.astype(np.float32),
                            device=dev) / 255.0
    dem = torch.as_tensor(scene.dem, device=dev)
    k, aff = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
              for a in (scene.k, scene.crs_affine))
    zoom = scene.alt_m / scene.k[0, 0] / abs(scene.crs_affine[2, 2])
    zstep = np.log1p(0.10)
    zq = np.float32(np.exp(round(float(np.log(zoom)) / zstep) * zstep))
    h, w = config.image_shape
    cy, cx = (n // 2 for n in scene.ortho.shape)
    gen = torch.Generator(device=dev)
    g_ms, e_ms, ulps, moved = [], [], [], []

    def call(fn, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    for i in cycle:
        angle = np.float32(round(scene.yaws[i] / 15.0) * 15.0)
        a_t, z_t = torch.tensor(angle), torch.tensor(zq)
        got, ms = call(graph, ortho, dem, a_t, z_t)
        g_ms.append(ms)
        want, ms = call(lambda: extract(models, ortho, dem, a_t.cuda(),
                                        z_t.cuda()))
        e_ms.append(ms)
        if not all(torch.equal(a, b) for a, b in zip(
                [*got[0], got[1], got[2]], [*want[0], want[1], want[2]])):
            raise RuntimeError(f"path 1: the graphed refresh of bucket "
                               f"{angle} differs from eager")
        z = torch.tensor(zq)
        host_m = crop_to_original(float(angle), cx, cy, cx - z * (w / 2.0),
                                  cy - z * (h / 2.0), z)
        card_m = got[2].cpu()
        ulps.append(float((card_m - host_m).abs().max()) / float(
            np.spacing(np.float32(host_m.abs().max()))))
        q = torch.as_tensor(scene.frames[i].astype(np.float32),
                            device=dev) / 255.0
        gen.manual_seed(i + 1)
        pose = hot(models, q, *got, k, aff, noise=draw_noise(
            gen, config.num_hypotheses, config.max_keypoints))
        moved.append(_fix_moved(
            geopose_to_wgs84_f64(pose, scene.crs_affine),
            geopose_to_wgs84_f64(pose._replace(m_crop=host_m),
                                 scene.crs_affine)))
    if max(ulps) > 1.0 or max(moved) > 1e-3:
        raise RuntimeError(f"path 1: the card's crop matrix {max(ulps)} "
                           f"ulp from the host's, fix moved {max(moved)} m")
    angles = [torch.tensor(np.float32(round(scene.yaws[i] / 15.0) * 15.0))
              for i in cycle]
    z_t = torch.tensor(zq)
    busy = profile_frames(lambda a: graph(ortho, dem, a, z_t), angles,
                          n=len(angles))
    busy_eager = profile_frames(
        lambda a: extract(models, ortho, dem, a.cuda(), z_t.cuda()), angles,
        n=len(angles))
    g50, e50 = float(np.median(g_ms)), float(np.median(e_ms))
    out = {"refreshes_compared": len(g_ms), "graphed_p50_ms": g50,
           "graphed_p90_ms": float(np.percentile(g_ms, 90)),
           "eager_p50_ms": e50, "eager_p90_ms": float(np.percentile(e_ms, 90)),
           "graphed_busy_ms": busy, "eager_busy_ms": busy_eager,
           "graphed_idle_share": 1.0 - busy / g50,
           "eager_idle_share": 1.0 - busy_eager / e50,
           "m_crop_max_ulp": max(ulps), "host_matrix_fix_move_m": max(moved),
           "replays": graph.replays, "launches_a_replay": graph.launches}
    log("[main refresh] " + json.dumps(out))
    return out


# --- path 14: the library API ----------------------------------------------


def _library_fix(scene, config, i, fq, fr, match, dem_crop, m_crop,
                 seed: int) -> tuple:
    """A fix through the library's pnp entry points from ``match`` of the
    query features ``fq`` against the crop's ``fr``: ``keypoints_to_3d`` on
    the DEM crop in crop-pixel units (as the frame program scales it),
    ``ransac_pnp`` with RANSAC's noise from the generator seeded as the
    runner seeds frame ``seed``, the geopose, and ``project_points`` of the
    inliers. Returns (pose, f64 fix, error m, largest inlier reprojection
    error in px)."""
    from gisnav_tpu_torch.geometry.crs import haversine_m
    from gisnav_tpu_torch.pipeline.geopose import (
        GeoPose,
        assemble_geopose,
        geopose_to_wgs84_f64,
    )
    from gisnav_tpu_torch.pnp import keypoints_to_3d, project_points
    from gisnav_tpu_torch.pnp import ransac_pnp
    from gisnav_tpu_torch.pnp.ransac import draw_noise

    dev = torch.device(API_DEVICE)
    k, aff = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
              for a in (scene.k, scene.crs_affine))
    mvalid = match.matches0 >= 0
    mkp_ref = fr.keypoints[torch.clamp(match.matches0, min=0)]
    z_scale = aff[2, 2] * torch.sqrt(torch.abs(torch.linalg.det(
        m_crop[:2, :2])))
    obj = keypoints_to_3d(mkp_ref, dem_crop / z_scale)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pnp = ransac_pnp(obj, fq.keypoints, k, mvalid, noise=draw_noise(
        gen, config.num_hypotheses, config.max_keypoints),
        num_hypotheses=config.num_hypotheses,
        threshold_px=config.threshold_px, min_inliers=config.min_matches,
        refine_iters=config.refine_iters)
    ecef, quat, lla, cam = assemble_geopose(pnp.r, pnp.t, m_crop, aff)
    n = mvalid.sum()
    pose = GeoPose(ecef, quat, lla, pnp.r, cam, m_crop, n, pnp.num_inliers,
                   pnp.valid & (n >= config.min_matches), fq.keypoints,
                   mkp_ref, mvalid & pnp.inliers)
    fix = geopose_to_wgs84_f64(pose, scene.crs_affine)
    lon, lat = scene.truth_lonlat[i]
    err = haversine_m(lat, lon, fix["lat"], fix["lon"])
    reproj = torch.linalg.norm(project_points(obj, pnp.r, pnp.t, k)
                               - fq.keypoints, dim=1)
    reproj = torch.where(pose.match_mask, reproj, torch.zeros_like(reproj))
    return pose, fix, err, float(reproj.max())


def _same_features(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_api_path(scene=None, path1_frame_p50_ms=None) -> dict:
    """Path 14: the library API on path 1's scene, frames and weights.

    ``load_pretrained(LEARNED_LG9_PATH)`` carried to the card by
    ``params_from_jax``; a bucketed runner of path 1's configuration flies
    each of ``API_FRAMES`` with its graphs run eagerly (``GraphSide``),
    SuperPoint's inputs and outputs and LightGlue's ``matches0`` tapped.
    Then, on the same frame and the bucket's reference crop, with the
    runner's SuperPoint settings: ``extract_features`` (K1 1, K2 8, K3 1
    launches each, the runner's features bit for bit), ``match_features``
    of the two (the fused route: K4 36, no K5; the runner's ``matches0``
    exactly), and of the query against the crop's first ``MODULE_KP``
    keypoints (the module route: K5 72, no K4; its ``matches0`` agree on
    ``API_MODULE_AGREE`` with the same call through K5's plain version,
    which launches no kernel); each match through
    ``keypoints_to_3d``, ``ransac_pnp`` and ``project_points``: valid,
    within 10 m of the truth, the fused one within 1 mm of the runner's
    fix on the same RANSAC draw, every inlier reprojected within the
    RANSAC threshold. Prints the eager p50 ms of each call (CUDA events
    around one call) beside the runner's graphed frame (host clock; and
    path 1's when given)."""
    from gisnav_tpu_torch.features import SuperPointFeatures
    from gisnav_tpu_torch.features import extract_features
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.matching import attention, match_features
    from gisnav_tpu_torch.matching.attention import masked_attention_plain
    from gisnav_tpu_torch.pipeline.runners import (
        LEARNED_LG9_CONFIG,
        make_bucketed_warp_runner,
    )
    from gisnav_tpu_torch.weights import (
        LEARNED_LG9_PATH,
        load_pretrained,
        params_from_jax,
    )

    kernel_attention = attention.masked_attention
    t0 = time.time()
    scene = scene if scene is not None else main_scene()
    tree = load_pretrained(LEARNED_LG9_PATH)
    params = params_from_jax(tree, API_DEVICE)
    config = dataclasses.replace(LEARNED_LG9_CONFIG, image_shape=(H, W),
                                 max_keypoints=MAX_KP, lightglue_depth=9)
    runner = make_bucketed_warp_runner(tree, config, bucket_deg=15.0,
                                       device=API_DEVICE)
    models = runner.models
    sp, lg = models["superpoint"], models["lightglue"]
    sp_taps: list = []
    m0_taps: list = []

    def sp_tapped(image):
        feats = sp(image)
        sp_taps.append((image, feats))
        return feats

    models["superpoint"] = sp_tapped
    tap_programs(models, m0_taps)
    kw = dict(max_keypoints=sp.max_keypoints,
              score_threshold=sp.score_threshold,
              select_tiles=sp.select_tiles, detector_mode=sp.detector_mode,
              device=API_DEVICE)
    lg_kw = dict(depth=config.lightglue_depth,
                 filter_threshold=config.filter_threshold, device=API_DEVICE)
    size = (H, W)
    dev = torch.device(API_DEVICE)
    log(f"[api] weights, scene and runner in {time.time() - t0:.1f} s; "
        f"SuperPoint settings {kw}")

    def counted(fn, *args, **kwargs):
        """``fn``'s result and every kernel's launches in the call."""
        reset_launches()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        return out, dict(LAUNCHES)

    def launched(counts):
        return {k: n for k, n in counts.items() if n}

    extraction = {"stem_stage": 1, "conv_stage": 8, "nms_select": 1}
    out = {"frames": []}
    for i in API_FRAMES:
        sp_taps.clear()
        m0_taps.clear()
        with GraphSide("eager"):
            pose, _, err, fix = _frame(runner, scene, i,
                                       f"[api] runner (eager) frame {i}")
        _gate(pose, err, fix, f"[api] runner frame {i}")
        if len(sp_taps) != 2 or len(m0_taps) != 1:
            raise RuntimeError(f"path 14: frame {i} made {len(sp_taps)} "
                               f"SuperPoint and {len(m0_taps)} LightGlue "
                               f"calls, expected a bucket refresh (2, 1)")
        (crop, r_feats), (_, q_feats) = sp_taps
        seed = runner.stats["frames"]
        _, dem_crop, m_crop = runner.buckets[next(reversed(runner.buckets))]
        query = torch.as_tensor(scene.frames[i], device=dev).float() / 255.0

        fq, lq = counted(extract_features, params["superpoint"], query, **kw)
        fr, lr = counted(extract_features, params["superpoint"], crop, **kw)
        expect_launches(f"path 14 frame {i} extract_features (query)", lq,
                        extraction)
        expect_launches(f"path 14 frame {i} extract_features (crop)", lr,
                        extraction)
        if not (_same_features(fq, q_feats) and _same_features(fr, r_feats)):
            raise RuntimeError(f"path 14: extract_features differs from the "
                               f"runner's SuperPoint on frame {i}")

        fused, lf = counted(match_features, params["lightglue"], fq, size,
                            fr, size, **lg_kw)
        # equal set sizes: the dual block, a self and a cross call a layer
        expect_launches(f"path 14 frame {i} match_features (fused)", lf,
                        {"fused_block": 36})
        if not torch.equal(fused.matches0, m0_taps[0]):
            raise RuntimeError(f"path 14: match_features' matches0 differs "
                               f"from the runner's on frame {i}")
        cut = SuperPointFeatures(*(t[:MODULE_KP] for t in fr))
        module, lm = counted(match_features, params["lightglue"], fq, size,
                             cut, size, **lg_kw)
        expect_launches(f"path 14 frame {i} match_features (module)", lm,
                        {"masked_attention": 72})
        # the same call with K5's plain version in the kernel's place
        attention.masked_attention = masked_attention_plain
        try:
            module_plain, lp = counted(match_features, params["lightglue"],
                                       fq, size, cut, size, **lg_kw)
        finally:
            attention.masked_attention = kernel_attention
        expect_launches(f"path 14 frame {i} match_features (module, "
                        f"plain attention)", lp, {})
        agree = float((module.matches0 == module_plain.matches0).float()
                      .mean())
        log(f"[api] frame {i}: module route with K5 against its plain "
            f"version: matches0 agree on {agree:.4%} (gate "
            f"{API_MODULE_AGREE:.0%})")
        if agree < API_MODULE_AGREE:
            raise RuntimeError(f"path 14: the module route's matches0 with "
                               f"K5 agree with its plain version's on "
                               f"{agree:.4%} of frame {i}'s keypoints")

        row = {"frame": i, "yaw": scene.yaws[i], "runner_error_m": err,
               "launches": {"extract_query": launched(lq),
                            "extract_crop": launched(lr),
                            "match_fused": launched(lf),
                            "match_module": launched(lm)}}
        for name, match, ref in (("fused", fused, fr), ("module", module,
                                                         cut)):
            lpose, lfix, lerr, reproj = _library_fix(
                scene, config, i, fq, ref, match, dem_crop, m_crop, seed)
            _gate(lpose, lerr, lfix, f"[api] library fix ({name}) frame {i}")
            if reproj > config.threshold_px * (1 + 1e-3):
                raise RuntimeError(f"path 14: an inlier reprojects {reproj} "
                                   f"px off ({name}, frame {i})")
            row[name] = {"matches": int(lpose.num_matches),
                         "inliers": int(lpose.num_inliers),
                         "error_m": lerr, "max_inlier_reproj_px": reproj,
                         "moved_from_runner_m": _fix_moved(lfix, fix)}
        if row["fused"]["moved_from_runner_m"] > 1e-3:
            raise RuntimeError(f"path 14: the library's fix is "
                               f"{row['fused']['moved_from_runner_m']} m "
                               f"from the runner's on frame {i}")
        log(f"[api] frame {i}: " + json.dumps(row))
        out["frames"].append(row)

    # the package's own graphs again, for the graphed frame beside the
    # eager library calls
    models["superpoint"], models["lightglue"] = sp, lg
    i = API_FRAMES[-1]
    _frame(runner, scene, i)  # captures the frame program
    graphed = [_frame(runner, scene, i)[1] for _ in range(API_REPS)]
    out["runner_graphed_frame_p50_ms"] = float(np.median(graphed))
    out["path1_graphed_frame_p50_ms"] = path1_frame_p50_ms
    calls = {"extract_features": lambda: extract_features(
                 params["superpoint"], query, **kw),
             "extract_features_crop": lambda: extract_features(
                 params["superpoint"], crop, **kw),
             "match_features_fused": lambda: match_features(
                 params["lightglue"], fq, size, fr, size, **lg_kw),
             "match_features_module": lambda: match_features(
                 params["lightglue"], fq, size, cut, size, **lg_kw)}
    for name, fn in calls.items():
        out[f"{name}_p50_ms"] = time_ms(fn, reps=API_REPS, warmup=1)
    out["card"] = card_label()
    log(f"[api] eager library calls on {out['card']}: extract_features "
        f"{out['extract_features_p50_ms']:.3f} ms (crop "
        f"{out['extract_features_crop_p50_ms']:.3f}), match_features fused "
        f"{out['match_features_fused_p50_ms']:.3f} ms, module "
        f"{out['match_features_module_p50_ms']:.3f} ms; the runner's "
        f"graphed frame {out['runner_graphed_frame_p50_ms']:.3f} ms, path "
        f"1's {path1_frame_p50_ms}")
    # a call of each
    out["launches"] = {**launched(lq), **launched(lf), **launched(lm)}
    log("[api] " + json.dumps(out))
    return out


def demo_render(maps: str) -> dict:
    """Path 15 (a): ``tools/make_demo_geotiff_torch.py`` at its defaults
    into ``maps``, as a process; both GeoTIFFs read back, each array's
    sha256 held to the JAX tool's (``DEMO_DIGESTS``)."""
    from gisnav_tpu_torch.gis.geotiff import read_geotiff

    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "make_demo_geotiff_torch.py")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, tool, "--out", maps],
                          capture_output=True, text=True,
                          timeout=DEMO_TOOL_DEADLINE_S)
    out = {"tool_s": time.perf_counter() - t0}
    if proc.returncode != 0:
        raise RuntimeError(f"demo: the tool exited {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    for layer, (name, dtype, want) in DEMO_DIGESTS.items():
        raster, _ = read_geotiff(os.path.join(maps, layer, name))
        got = hashlib.sha256(np.ascontiguousarray(
            raster, np.dtype(dtype).newbyteorder("<")).tobytes()).hexdigest()
        out[layer] = {"shape": list(raster.shape), "dtype": str(raster.dtype),
                      "sha256": got}
        if raster.dtype != dtype or got != want:
            raise RuntimeError(f"demo: {layer} {out[layer]} is not the JAX "
                               f"tool's ({want})")
    log(f"[demo] tool {out['tool_s']:.2f} s host; digests equal the JAX "
        f"tool's: {json.dumps(out)}")
    return out


def demo_track(world) -> list:
    """Path 15's steps: (lon, lat, altitude, yaw), ``DEMO_STEPS`` steps of
    ``DEMO_STEP_M`` eastward through the extent's centre at ``DEMO_AGL_M``
    above the DEM under the camera, the heading of path 8's track (22.5
    +- 1.5 deg, across a 15-deg bucket edge)."""
    from gisnav_tpu_torch.utils.world_wms import east_of

    lon0, lat0 = world.to_lonlat(world.raster.shape[1] / 2 - 0.5,
                                 world.raster.shape[0] / 2 - 0.5)
    lon0, lat0 = float(lon0), float(lat0)
    half = DEMO_STEP_M * (DEMO_STEPS - 1) / 2
    track = []
    for i in range(DEMO_STEPS):
        lon = east_of(lon0, lat0, DEMO_STEP_M * i - half)
        track.append((lon, lat0, float(world.height_at(lon, lat0))
                      + DEMO_AGL_M, 22.5 + 1.5 * (-1) ** i))
    return track


def demo_getmap(world, url: str, track: list) -> dict:
    """Path 15 (b): the GIS node's GetMap of the first step's map (its
    bbox, the 2208-px side of a 1088x1920 camera, the default format)
    from ``gis-serve``, ``DEMO_GETMAPS`` times: the reply must be JPEG of
    that size; host ms p50 / p90."""
    from gisnav_tpu_torch.geometry.bbox import fov_bounding_box_enu
    from gisnav_tpu_torch.geometry.quaternion import quat_to_matrix
    from gisnav_tpu_torch.gis.jpeg import decode_image
    from gisnav_tpu_torch.gis.wms import (
        DEFAULT_FORMAT,
        WMSClient,
        orthoimage_size_for_camera,
    )
    from gisnav_tpu_torch.utils.world_wms import camera_attitude_quat

    lon, lat, alt, yaw = track[0]
    ground = float(np.mean(world.dem))
    bbox = fov_bounding_box_enu(DEMO_K, DEMO_W, DEMO_H,
                                quat_to_matrix(camera_attitude_quat(yaw)),
                                alt - ground, lon, lat)
    side = orthoimage_size_for_camera(DEMO_W, DEMO_H)
    client = WMSClient(f"{url}/wms")
    query = {"service": "WMS", "request": "GetMap", "version": "1.1.1",
             "layers": "imagery", "styles": "", "srs": "EPSG:4326",
             "bbox": f"{bbox.left},{bbox.bottom},{bbox.right},{bbox.top}",
             "width": str(side[1]), "height": str(side[0]),
             "format": DEFAULT_FORMAT}
    ms = []
    for _ in range(DEMO_GETMAPS):
        t0 = time.perf_counter()
        ctype, body = client._get(query)
        ms.append((time.perf_counter() - t0) * 1e3)
    img = decode_image(body)
    out = {"format": DEFAULT_FORMAT, "content_type": ctype,
           "bytes": len(body), "side": side[0],
           "shape": None if img is None else list(img.shape),
           "grey_std": None if img is None else float(img.std()),
           **_pcts(ms)}
    log(f"[demo] gis-serve GetMap of the demo imagery: {json.dumps(out)}")
    if ctype != "image/jpeg" or out["shape"] != list(side) \
            or not out["grey_std"] > 10.0:
        raise RuntimeError(f"demo: gis-serve's GetMap {out}")
    return out


def demo_relief_error(world, track: list) -> dict:
    """What the DEM's relief alone does to a fix at ``DEMO_AGL_M``: PnP
    (``pnp.ransac_pnp``, on the host) on exact correspondences of a grid of
    frame pixels and the points where their rays meet the relief, once
    with each point at its own height and once flat at the DEM's mean
    height; the camera centre's horizontal distance from the truth, the
    largest and median over the steps."""
    from gisnav_tpu_torch.pnp.ransac import ransac_pnp

    mean_h = float(np.mean(world.dem))
    vv, uu = np.mgrid[0:DEMO_H:64, 0:DEMO_W:64].astype(np.float64) + 0.5
    pix = np.stack([uu.ravel(), vv.ravel()])
    moves: dict = {"relief": [], "flat": []}
    for lon, lat, alt, yaw in track:
        metres, h = world.ground_of(lon, lat, alt, yaw, DEMO_K, pix)
        for name, z in (("relief", -h), ("flat", np.full_like(h, -mean_h))):
            pnp = ransac_pnp(torch.tensor(np.c_[metres.T, z]),
                             torch.tensor(pix.T), torch.tensor(DEMO_K),
                             generator=torch.Generator().manual_seed(0))
            rr, t = pnp.r.double().numpy(), pnp.t.double().numpy()
            moves[name].append(float(np.hypot(*(-rr.T @ t)[:2])))
    out = {f"{n}_{k}_m": float(f(v)) for n, v in moves.items()
           for k, f in (("max", np.max), ("median", np.median))}
    log(f"[demo] PnP on exact correspondences at {DEMO_AGL_M:g} m AGL, "
        f"the camera centre's horizontal miss: {json.dumps(out)}")
    return out


def demo_flight(world, url: str, root: str, track: list, renders: list,
                t_render: float) -> dict:
    """Path 15 (c): the graph ``python -m gisnav_tpu_torch run`` builds
    from its defaults (deep, learned_lg9, warp-bucketed, uorb; the threaded
    bus), with a ``--params`` file as a user writes it: ``gis-serve``'s
    WMS, the main path's 1088x1920 frames and 2048 keypoints, the ground
    at the DEM's mean height and path 8's refresh threshold. It flies
    :func:`demo_track` over frames rendered from the demo maps over the
    DEM's relief (``renders``, futures started at ``t_render`` that run
    while the graph is built), a step a second of stamps and
    ``DEMO_PERIOD_S`` of wall time at least; each step waits for the pose
    and twist nodes to have handled its frame. Gates: at least
    ``DEMO_MIN_FIXES`` ``SensorGps`` fixes (the mock GPS warms up on 10),
    every one within 10 m of its step's truth horizontally and vertically,
    at least 2 maps, and every step's K1-K4 launches a frame's or a bucket
    refresh's."""
    from gisnav_tpu_torch.cli import build_app, build_parser
    from gisnav_tpu_torch.constants import (
        ROS_TOPIC_CAMERA_INFO,
        ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS,
        ROS_TOPIC_MAVROS_GLOBAL_POSITION,
    )
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.nodes.gis_node import TOPIC_ORTHOIMAGE
    from gisnav_tpu_torch.nodes.mock_gps import TOPIC_SENSOR_GPS
    from gisnav_tpu_torch.nodes.pose_node import TOPIC_POSE
    from gisnav_tpu_torch.utils.world_wms import camera_attitude_quat

    ground = float(np.mean(world.dem))
    params = {"gis_node": {"wms_url": f"{url}/wms",
                           "wms_layers": ["imagery"],
                           "wms_dem_layers": ["dem"],
                           "min_map_overlap_update_threshold":
                               GRAPH_OVERLAP},
              "pose_node": {"image_shape": [DEMO_H, DEMO_W],
                            "max_keypoints": DEMO_KP,
                            "ground_altitude_m": ground},
              "twist_node": {"ground_altitude_m": ground},
              "bbox_node": {"ground_altitude_m": ground}}
    path = os.path.join(root, "demo_params.json")
    with open(path, "w") as f:
        json.dump(params, f)
    t0 = time.perf_counter()
    app = build_app(build_parser().parse_args(
        ["run", "--params", path, "--device", DEMO_DEVICE]))
    build_s = time.perf_counter() - t0
    cfg = app.pose._config
    if not (app.bus._async and app.pose._deep_runner is not None
            and cfg.lightglue_depth == 9 and cfg.detector_mode == "learned"
            and cfg.image_shape == (DEMO_H, DEMO_W)
            and cfg.max_keypoints == DEMO_KP):
        raise RuntimeError(f"demo: not run's graph at the main path's "
                           f"width ({cfg})")
    frames = [f.result() for f in renders]
    render_s = time.perf_counter() - t_render
    log(f"[demo] run's graph built in {build_s:.2f} s; {len(frames)} "
        f"frames rendered over the relief by {render_s:.2f} s after the "
        "world was read")
    runner = app.pose._deep_runner
    fixes, arrivals, published, truth, maps = [], {}, {}, {}, []

    def on_fix(msg):  # on the mock-GPS node's worker thread
        arrivals[msg["timestamp_sample"]] = time.perf_counter()
        fixes.append(msg)

    def handled(node) -> int:
        return node.timing_stats().get("_image_cb", {}).get("calls", 0)

    poses: list = []
    app.bus.subscribe(TOPIC_SENSOR_GPS, on_fix)
    app.bus.subscribe(TOPIC_ORTHOIMAGE, lambda m: maps.append(m["stamp_us"]))
    app.bus.subscribe(TOPIC_POSE, poses.append)
    app.bus.publish(ROS_TOPIC_CAMERA_INFO,
                    {"k": DEMO_K, "width": DEMO_W, "height": DEMO_H})
    lon, lat, alt, yaw = track[0]  # the graph fetches its first map
    app.bus.publish(ROS_TOPIC_MAVROS_GLOBAL_POSITION,
                    {"stamp_us": 500_000, "lat": lat, "lon": lon,
                     "alt_ellipsoid": alt})
    app.bus.publish(ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS,
                    {"stamp_us": 500_000,
                     "quat_xyzw": camera_attitude_quat(yaw)})
    deadline = time.monotonic() + DEMO_FRAME_DEADLINE_S[1]
    while app.pose._ortho is None:
        app.gis.tick()
        if time.monotonic() > deadline:
            raise RuntimeError("demo: no map reached the pose node")
        time.sleep(0.05)
    reset_launches()
    ran0, per_step = runner.stats["frames"], []
    try:
        for i, ((lon, lat, alt, yaw), frame) in enumerate(zip(track,
                                                              frames)):
            stamp = 1_000_000 * (i + 1)
            truth[stamp] = (lon, lat, alt)
            before = dict(LAUNCHES)
            published[stamp] = _publish_step(app.bus, stamp, lon, lat, alt,
                                             yaw, frame, app.gis)
            deadline = time.monotonic() + DEMO_FRAME_DEADLINE_S[i > 0]
            while min(handled(app.pose), handled(app.twist)) < i + 1:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"demo: step {i} not handled in "
                                       f"{DEMO_FRAME_DEADLINE_S[i > 0]} s")
                time.sleep(0.002)
            per_step.append({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
            time.sleep(max(0.0, published[stamp] + DEMO_PERIOD_S
                           - time.perf_counter()))
        t_quiet = time.monotonic()
        seen = len(fixes)
        while time.monotonic() - t_quiet < DEPLOY_QUIET_S:
            time.sleep(0.05)
            if len(fixes) != seen:
                seen, t_quiet = len(fixes), time.monotonic()
    finally:
        stats = app.shutdown()
    ran = runner.stats["frames"] - ran0
    launches = dict(LAUNCHES)
    frame = {k: GRAPH_FRAME.get(k, 0) for k in launches}
    refresh = {k: GRAPH_REFRESH.get(k, 0) for k in launches}
    refreshes = sum(n == refresh for n in per_step)
    odd = [(i, n) for i, n in enumerate(per_step)
           if n not in (frame, refresh)]
    if odd or ran != DEMO_STEPS:
        raise RuntimeError(f"demo: {ran} frames ran; steps launching "
                           f"neither a frame's nor a refresh's kernels: "
                           f"{odd}")
    expect_launches("demo", launches, {
        k: ran * frame[k] + refreshes * (refresh[k] - frame[k])
        for k in PATH1_KERNELS})
    unknown = [f["timestamp_sample"] for f in fixes
               if f["timestamp_sample"] not in truth]
    if unknown:
        raise RuntimeError(f"demo: fixes stamped off the steps: {unknown}")
    errors = [_fix_errors(f, *truth[f["timestamp_sample"]]) for f in fixes]
    horiz = [e[0] for e in errors]
    out = {"steps": DEMO_STEPS, "frames_ran": ran, "fixes": len(fixes),
           "maps": len(set(maps)), "bucket_refreshes": int(refreshes),
           "max_horiz_m": max(horiz, default=None),
           "median_horiz_m": float(np.median(horiz)) if horiz else None,
           "max_vert_m": max((e[1] for e in errors), default=None),
           "frame_to_fix": _pcts(_latencies(published, arrivals)),
           "launches": launches, "dropped": app.bus.dropped,
           "render_s": render_s, "build_s": build_s,
           "handlers": {n: {h: {k: v[k] for k in ("calls", "p50_ms",
                                                   "p90_ms")}
                            for h, v in stats[n].items()}
                        for n in ("pose_node", "twist_node")}}
    out["pose_fixes"] = len(poses)
    kind = {1_000_000 * (i + 1): "refresh" if n == refresh else "frame"
            for i, n in enumerate(per_step)}
    pose_errors = [(p["stamp_us"], kind[p["stamp_us"]], *(
        round(e, 2) for e in _fix_errors(
            {"lat": p["lat"] * 1e7, "lon": p["lon"] * 1e7,
             "alt_ellipsoid": p["alt_ellipsoid"] * 1e3},
            *truth[p["stamp_us"]]))) for p in poses]
    out["max_pose_horiz_m"] = max((e[2] for e in pose_errors), default=None)
    log("[demo] pose node fixes (stamp, step, m, m): " + str(pose_errors))
    log("[demo] SensorGps fixes (stamp, m, m): " + str(
        [(f["timestamp_sample"], round(h, 2), round(v, 2))
         for f, (h, v) in zip(fixes, errors)]))
    ftf = out["frame_to_fix"]
    log(f"[demo] frame-to-fix p50 {ftf['p50_ms']} / p90 {ftf['p90_ms']} "
        f"ms; {refreshes} bucket refreshes over {out['maps']} maps; fix "
        f"error max {out['max_horiz_m']} m, median {out['median_horiz_m']} "
        f"m (vertical max {out['max_vert_m']} m); launches {launches}")
    far = [e for e in errors if not (e[0] < 10.0 and e[1] < 10.0)]
    if len(fixes) < DEMO_MIN_FIXES or far or out["maps"] < 2:
        raise RuntimeError(f"demo: {len(fixes)} fixes, {len(far)} over 10 "
                           f"m, {out['maps']} maps")
    return out


def phase_demo_path() -> dict:
    """Path 15: the demo world made by the port's tool (a), served by
    ``gis-serve`` as a process (b), and run's graph flown over it at the
    main path's width (c). The server is stopped before it returns."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from gisnav_tpu_torch.utils.world_wms import GeoWorld

    with tempfile.TemporaryDirectory() as root, \
            ThreadPoolExecutor(4) as pool:
        maps = os.path.join(root, "maps")
        out = {"render": demo_render(maps)}
        world = GeoWorld.read(maps)
        port = _free_port()
        gis = _Proc("gis_serve_demo", ["gis-serve", "--maps", maps,
                                       "--host", "127.0.0.1", "--port",
                                       str(port)], root)
        try:
            track = demo_track(world)
            t_render = time.perf_counter()
            renders = [pool.submit(world.render_frame, lon, lat, alt, yaw,
                                   DEMO_K, (DEMO_H, DEMO_W))
                       for lon, lat, alt, yaw in track]
            out["relief"] = demo_relief_error(world, track)
            gis.wait_for("GIS server on")
            url = f"http://127.0.0.1:{port}"
            out["getmap"] = demo_getmap(world, url, track)
            out["flight"] = demo_flight(world, url, root, track, renders,
                                        t_render)
            gis.stop()
        finally:
            gis.kill()
    out["card"] = card_label()
    log("[demo] " + json.dumps(out))
    return out


# -- path 16: WebP on the replay and WMS paths ---------------------------------

# the WebP fixtures and path 16's flight (tools/make_torch_image_fixtures.py)
WEBP_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "data", "torch_webp")
WEBP_FLIGHT = os.path.join(WEBP_FIXTURES, "flight")
WEBP_MAX_KP = 2048  # the main path's keypoints (the map's: 2 x)
WEBP_MOVE_M = 5.0  # a WebP fix from the PNG one's, at most (PERF.md, PR 19)
WEBP_TWIN_MEAN_ABS = 1.5  # grey levels, the PNG twin from the WebP flight
WEBP_FETCHES = 5  # the GIS node's WebP map fetches timed
WEBP_REPS = (10, 3)  # decodes timed of a frame and of the map


def webp_fixtures() -> dict:
    """Path 16 (a): every committed WebP fixture and flight file decoded by
    ``decode_image`` under both flags (the flight's under the grey flag
    replay reads them with), each pixel digest equal to cv2's."""
    from gisnav_tpu_torch.gis.imgcodecs import (IMREAD_GRAYSCALE,
                                                IMREAD_UNCHANGED,
                                                decode_image)

    with open(os.path.join(WEBP_FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    with open(os.path.join(WEBP_FLIGHT, "flight.json")) as f:
        flight = json.load(f)
    flags = {"unchanged": IMREAD_UNCHANGED, "grayscale": IMREAD_GRAYSCALE}
    cases = [(os.path.join(WEBP_FIXTURES, n), key, want[key])
             for n, want in sorted(digests.items()) for key in flags]
    cases += [(os.path.join(WEBP_FLIGHT, n), "grayscale", want)
              for n, want in sorted(flight["webp_cv2"].items())]
    bad = []
    for path, key, want in cases:
        with open(path, "rb") as f:
            got = image_digest(decode_image(f.read(), flags[key]))
        if got != want:
            bad.append((os.path.relpath(path, WEBP_FIXTURES), key, got))
    out = {"files": len(digests) + len(flight["webp_cv2"]),
           "decodes": len(cases), "mismatches": len(bad)}
    log(f"[webp] fixtures against cv2's digests: {json.dumps(out)}")
    if bad:
        raise RuntimeError(f"webp: fixtures not decoded as cv2: {bad}")
    return out


def webp_png_flight(root: str) -> str:
    """The PNG twin of the WebP flight, written here from its manifest:
    its ``map.json``, ``camera.json`` and ``poses.csv`` must equal the
    committed flight's, and each array lie within ``WEBP_TWIN_MEAN_ABS``
    grey levels (mean) of the WebP file's decode; how many arrays equal the
    fixture tool's bit for bit is printed (the world's float32 noise is
    not bit-reproducible across machines)."""
    from gisnav_tpu_torch.gis.imgcodecs import (IMREAD_GRAYSCALE,
                                                IMREAD_UNCHANGED, read_image)
    from gisnav_tpu_torch.utils.world_wms import World, write_replay_dataset

    with open(os.path.join(WEBP_FLIGHT, "flight.json")) as f:
        manifest = json.load(f)
    png = os.path.join(root, "flight_png")
    write_replay_dataset(World.make(**manifest["world"]), png,
                         frames=manifest["frames"], hw=tuple(manifest["hw"]),
                         coverage=manifest["coverage"])
    bad, same, mean_abs = [], 0, {}
    for name in ("map.json", "camera.json", "poses.csv"):
        with open(os.path.join(png, name)) as a, \
                open(os.path.join(WEBP_FLIGHT, name)) as b:
            if a.read() != b.read():
                bad.append(name)
    for name, want in manifest["png_sha256"].items():
        arr = read_image(os.path.join(png, name), IMREAD_UNCHANGED)
        same += image_digest(arr) == want
        webp = read_image(os.path.join(WEBP_FLIGHT, name), IMREAD_GRAYSCALE)
        if arr.shape != webp.shape:
            bad.append(name)
            continue
        mean_abs[name] = round(float(np.abs(arr.astype(np.int16)
                                            - webp).mean()), 3)
        if mean_abs[name] > WEBP_TWIN_MEAN_ABS:
            bad.append(name)
    log(f"[webp] the PNG twin written here: {same} of "
        f"{len(manifest['png_sha256'])} arrays equal to the fixture tool's; "
        f"mean |PNG - WebP| {json.dumps(mean_abs)}")
    if bad:
        raise RuntimeError(f"webp: the PNG twin is not the WebP flight's: "
                           f"{bad}")
    return png


def _replay_learned(data: str, report: str, tag: str) -> dict:
    """learned_lg9 ``replay`` (the cached runner at the dataset's 1088x1920,
    ``WEBP_MAX_KP`` keypoints) on ``data`` through the CLI in this process:
    gated on exit code 0 (every frame within 10 m), every frame valid and
    K1-K4 launched; then the frame p50 of a second run."""
    from gisnav_tpu_torch.replay import replay

    rc, rep, launches = _replay_cli([data, "--weights", "learned_lg9",
                                     "--max-keypoints", str(WEBP_MAX_KP),
                                     "--out", report])
    s = rep["summary"]
    log(f"[replay {tag}] rc {rc} {json.dumps(s)}; launches {launches}")
    if rc != 0 or s["valid"] != s["frames"]:
        raise RuntimeError(f"replay learned_lg9 {tag}: rc {rc}, {s}")
    idle = [k for k in PATH1_KERNELS if not launches.get(k)]
    if idle:
        raise RuntimeError(f"replay {tag}: {idle} never launched")
    ticks = []
    replay(data, weights="learned_lg9", max_keypoints=WEBP_MAX_KP,
           device=DEPLOY_DEVICE,
           progress=lambda *_: ticks.append(time.perf_counter()))
    return {**s, "launches": launches, "fixes": rep["frames"],
            "frame": _pcts(np.diff(ticks) * 1e3)}


def webp_replay(root: str) -> dict:
    """Path 16 (b): the main path's model replayed over the committed WebP
    flight and over the PNG flight written here; each WebP fix within
    ``WEBP_MOVE_M`` of the PNG one's."""
    png = webp_png_flight(root)
    report = os.path.join(root, "r.json")
    out = {"webp": _replay_learned(WEBP_FLIGHT, report, "WebP"),
           "png": _replay_learned(png, report, "WebP's PNG twin")}
    moved = _moved(out["webp"].pop("fixes"), out["png"].pop("fixes"))
    out["webp_to_png"] = {"max_horiz_m": max(m["horiz_m"] for m in moved),
                          "max_up_m": max(m["up_m"] for m in moved)}
    log(f"[webp replay] each fix's move, WebP -> PNG flight: {moved}")
    if max(out["webp_to_png"].values()) > WEBP_MOVE_M:
        raise RuntimeError(f"webp: a fix moved {out['webp_to_png']} from "
                           f"the PNG flight's")
    return out


def webp_gis_fetch() -> dict:
    """Path 16 (c): the GIS node asking for ``image/webp`` from a loopback
    stub that answers every GetMap with the flight's WebP map: the node's
    raster must be cv2's grey read of those bytes; the fetch timed."""
    with open(os.path.join(WEBP_FLIGHT, "flight.json")) as f:
        want = json.load(f)["webp_cv2"]["map.png"]
    return _gis_fetch("image/webp", WEBP_FLIGHT, want, "webp")


def _gis_fetch(ctype: str, flight: str, want: dict, tag: str) -> dict:
    """The GIS node asking for ``ctype`` from a loopback stub that answers
    every GetMap with ``flight``'s map file: the node's raster must have
    digest ``want`` (cv2's grey read of those bytes); ``WEBP_FETCHES``
    fetches timed."""
    import threading
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from gisnav_tpu_torch.geometry.bbox import BBox
    from gisnav_tpu_torch.nodes.bus import LocalBus
    from gisnav_tpu_torch.nodes.gis_node import GISNode

    with open(os.path.join(flight, "map.png"), "rb") as f:
        body = f.read()
    with open(os.path.join(flight, "map.json")) as f:
        bounds = json.load(f)
    served = []

    class Stub(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server's name)
            served.append(self.path)
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/wms"
        ms, raster = [], None
        for i in range(WEBP_FETCHES):
            node = GISNode(LocalBus(), params={
                "wms_url": url, "wms_format": ctype,
                "wms_layers": ["imagery"], "wms_dem_layers": []})
            node._camera_info_cb({"width": 1920, "height": 1088})
            node._bbox_cb({"stamp_us": 1_000_000 + i, "bbox": BBox(
                bounds["left"], bounds["bottom"], bounds["right"],
                bounds["top"])})
            t0 = time.perf_counter()
            node.tick()
            ms.append((time.perf_counter() - t0) * 1e3)
            raster = node.cache.current.image
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    out = {"bytes": len(body), "requests": len(served),
           "equal": image_digest(raster) == want, **_pcts(ms)}
    log(f"[{tag}] the GIS node's {ctype} fetch: {json.dumps(out)}")
    asked = "format=" + urllib.parse.quote(ctype, safe="")
    if not out["equal"] or asked not in served[0]:
        raise RuntimeError(f"{tag}: the GIS node's raster "
                           f"{image_digest(raster)} is not cv2's {want} "
                           f"(requests {served[:1]})")
    return out


def webp_decode_times(card: str) -> list:
    """Path 16 (d): host ms p50 of ``decode_image`` on the flight's WebP map
    (2208 px) and on one of its 1088x1920 frames (both lossy, cv2 at
    quality 90) beside PNG and JPEG (quality 95) of the same pixels."""
    from gisnav_tpu_torch.gis.imgcodecs import decode_image
    from gisnav_tpu_torch.gis.jpeg import encode_jpeg
    from gisnav_tpu_torch.gis.png import encode_png

    rows = []
    for name, reps in (("map.png", WEBP_REPS[1]),
                       ("frames/1000000.png", WEBP_REPS[0])):
        with open(os.path.join(WEBP_FLIGHT, name), "rb") as f:
            webp = f.read()
        img = decode_image(webp)
        row = {"file": name, "shape": list(img.shape), "webp_bytes": len(webp),
               "webp_ms": host_ms(lambda: decode_image(webp), 1, reps)}
        for fmt, encode in (("png", encode_png), ("jpeg", encode_jpeg)):
            data = encode(img)
            row[f"{fmt}_bytes"] = len(data)
            row[f"{fmt}_ms"] = host_ms(lambda: decode_image(data), 1, reps)
        row["card"] = card
        log(f"[webp] decode {json.dumps(row)}")
        rows.append(row)
    return rows


def phase_webp_path() -> dict:
    """Path 16: WebP read as cv2 reads it, on the card machine (no cv2,
    no libwebp): the fixtures (a), the main path's model replayed over the
    committed WebP flight beside the PNG one (b), the GIS node's WebP
    fetch (c) and decode times (d)."""
    import tempfile

    from gisnav_tpu_torch.native import build_native_lib

    t0 = time.time()
    lib = build_native_lib("webp")
    card = card_label()
    out = {"build_s": round(time.time() - t0, 2), "card": card,
           "fixtures": webp_fixtures()}
    log(f"[webp] decoder {lib} in {out['build_s']} s")
    with tempfile.TemporaryDirectory() as root:
        out["replay"] = webp_replay(root)
    out["gis_fetch"] = webp_gis_fetch()
    out["decode"] = webp_decode_times(card)
    log("[webp] " + json.dumps(out))
    return out


# -- path 17: JPEG 2000 on the replay and WMS paths --------------------------

# the JPEG 2000 fixtures and path 17's flight (tools/make_torch_image_fixtures.py)
JP2_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "data", "torch_jp2")
JP2_FLIGHT = os.path.join(JP2_FIXTURES, "flight")
JP2_FIX_M = 3.0  # every fix over the JPEG 2000 flight within this of truth
JP2_MOVE_M = 5.0  # a JPEG 2000 fix from the PNG one's, at most
JP2_TWIN_MEAN_ABS = 1.5  # grey levels, the PNG twin from the JP2 flight
JP2_TILE = "rgb512_irr_tile.j2k"  # repeated 8 x 8 into a 4096-px image
# HTJ2K (JPEG 2000 Part 15): its fixtures and path 17's HT flight, the JPEG
# 2000 flight's pixels re-coded as HT (tools/make_torch_image_fixtures.py)
HTJ2K_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "data", "torch_htj2k")
HTJ2K_FLIGHT = os.path.join(HTJ2K_FIXTURES, "flight")
JP2_REPS = (10, 3, 1)  # decodes timed of a frame, the map, the 4096 image


def j2k_mosaic(tile: bytes, nx: int, ny: int) -> bytes:
    """A raw codestream of ``nx`` x ``ny`` tiles, each the one tile of
    ``tile`` (a one-tile codestream whose tile size is its image size): the
    main header with ``SIZ``'s image size multiplied, the tile-part
    repeated under each tile index, EOC. A tile whose size is a multiple of
    2^levels codes the same wherever it lies, so this is a valid image."""
    import struct

    siz = tile.index(b"\xff\x51")
    w, h = struct.unpack(">II", tile[siz + 6:siz + 14])
    tw, th = struct.unpack(">II", tile[siz + 22:siz + 30])
    if (tw, th) != (w, h) or tile[-2:] != b"\xff\xd9":
        raise ValueError("j2k_mosaic: not a one-tile codestream")
    sot = tile.index(b"\xff\x90\x00\x0a")
    head = bytearray(tile[:sot])
    head[siz + 6:siz + 14] = struct.pack(">II", w * nx, h * ny)
    part = tile[sot:-2]
    return bytes(head) + b"".join(
        part[:4] + struct.pack(">H", t) + part[6:]
        for t in range(nx * ny)) + b"\xff\xd9"


def jp2_fixtures() -> dict:
    """Path 17 (a): every committed JPEG 2000 and HTJ2K fixture decoded by
    ``decode_image`` under both flags, both flights' maps and frames under
    the grey flag (as replay reads them) and their DEMs unchanged, each
    pixel digest equal to cv2's."""
    from gisnav_tpu_torch.gis.imgcodecs import (IMREAD_GRAYSCALE,
                                                IMREAD_UNCHANGED,
                                                decode_image)

    flags = {"unchanged": IMREAD_UNCHANGED, "grayscale": IMREAD_GRAYSCALE}
    cases, files = [], 0
    for folder, flight_dir, key_cv2 in (
            (JP2_FIXTURES, JP2_FLIGHT, "jp2_cv2"),
            (HTJ2K_FIXTURES, HTJ2K_FLIGHT, "ht_cv2")):
        with open(os.path.join(folder, "digests.json")) as f:
            digests = json.load(f)
        with open(os.path.join(flight_dir, "flight.json")) as f:
            flight = json.load(f)
        cases += [(os.path.join(folder, n), key, want[key])
                  for n, want in sorted(digests.items()) for key in flags]
        cases += [(os.path.join(flight_dir, n), "grayscale", want)
                  for n, want in sorted(flight[key_cv2].items())]
        cases.append((os.path.join(flight_dir, flight["dem"]), "unchanged",
                      flight["dem_cv2"]))
        files += len(digests) + len(flight[key_cv2]) + 1
    bad = []
    for path, key, want in cases:
        with open(path, "rb") as f:
            got = image_digest(decode_image(f.read(), flags[key]))
        if got != want:
            bad.append((os.path.relpath(path, os.path.dirname(JP2_FIXTURES)),
                        key, got))
    out = {"files": files, "decodes": len(cases), "mismatches": len(bad)}
    log(f"[jp2] fixtures against cv2's digests: {json.dumps(out)}")
    if bad:
        raise RuntimeError(f"jp2: fixtures not decoded as cv2: {bad}")
    return out


def jp2_png_flight(root: str) -> str:
    """The PNG twin of the JPEG 2000 flight, written here from its
    manifest, with the flight's DEM (decoded here, equal to cv2's uint16)
    as a 16-bit TIFF: its ``camera.json`` and ``poses.csv`` and its
    ``map.json`` but for the DEM's name must equal the committed flight's,
    each array lie within ``JP2_TWIN_MEAN_ABS`` grey levels (mean) of the
    JPEG 2000 file's decode."""
    from gisnav_tpu_torch.gis.imgcodecs import (IMREAD_GRAYSCALE,
                                                IMREAD_UNCHANGED, read_image)
    from gisnav_tpu_torch.gis.tiff import encode_tiff
    from gisnav_tpu_torch.utils.world_wms import World, write_replay_dataset

    with open(os.path.join(JP2_FLIGHT, "flight.json")) as f:
        manifest = json.load(f)
    png = os.path.join(root, "flight_png")
    write_replay_dataset(World.make(**manifest["world"]), png,
                         frames=manifest["frames"], hw=tuple(manifest["hw"]),
                         coverage=manifest["coverage"])
    dem = read_image(os.path.join(JP2_FLIGHT, manifest["dem"]),
                     IMREAD_UNCHANGED)
    if image_digest(dem) != manifest["dem_cv2"]:
        raise RuntimeError(f"jp2: the DEM {image_digest(dem)} is not cv2's")
    with open(os.path.join(png, "dem.tif"), "wb") as f:
        f.write(encode_tiff(dem, 8, 2))
    with open(os.path.join(png, "map.json")) as f:
        meta = json.load(f)
    meta.update(dem="dem.tif", dem_scale=manifest["dem_scale"])
    with open(os.path.join(png, "map.json"), "w") as f:
        json.dump(meta, f, indent=1)
    bad, same, mean_abs = [], 0, {}
    with open(os.path.join(JP2_FLIGHT, "map.json")) as f:
        if {**json.load(f), "dem": "dem.tif"} != meta:
            bad.append("map.json")
    for name in ("camera.json", "poses.csv"):
        with open(os.path.join(png, name)) as a, \
                open(os.path.join(JP2_FLIGHT, name)) as b:
            if a.read() != b.read():
                bad.append(name)
    for name, want in manifest["png_sha256"].items():
        arr = read_image(os.path.join(png, name), IMREAD_UNCHANGED)
        same += image_digest(arr) == want
        jp2 = read_image(os.path.join(JP2_FLIGHT, name), IMREAD_GRAYSCALE)
        if arr.shape != jp2.shape:
            bad.append(name)
            continue
        mean_abs[name] = round(float(np.abs(arr.astype(np.int16)
                                            - jp2).mean()), 3)
        if mean_abs[name] > JP2_TWIN_MEAN_ABS:
            bad.append(name)
    log(f"[jp2] the PNG twin written here: {same} of "
        f"{len(manifest['png_sha256'])} arrays equal to the fixture tool's; "
        f"mean |PNG - JP2| {json.dumps(mean_abs)}")
    if bad:
        raise RuntimeError(f"jp2: the PNG twin is not the JP2 flight's: "
                           f"{bad}")
    return png


def jp2_dem_reaches_runner(flight: str = JP2_FLIGHT) -> dict:
    """A flight's DEM as ``load_dataset`` hands it to the runner: cv2's
    uint16 (its digest in the manifest) times ``dem_scale``, in float32."""
    from gisnav_tpu_torch.gis.imgcodecs import IMREAD_UNCHANGED, read_image
    from gisnav_tpu_torch.replay import load_dataset

    with open(os.path.join(flight, "flight.json")) as f:
        manifest = json.load(f)
    raw = read_image(os.path.join(flight, manifest["dem"]),
                     IMREAD_UNCHANGED)
    dem = load_dataset(flight)["dem"]
    want = raw.astype(np.float32) * np.float32(manifest["dem_scale"])
    out = {"digest_is_cv2s": image_digest(raw) == manifest["dem_cv2"],
           "dtype": str(raw.dtype), "shape": list(raw.shape),
           "equal": bool(dem.dtype == np.float32
                         and np.array_equal(dem, want)),
           "min_m": float(dem.min()), "max_m": float(dem.max())}
    log(f"[jp2] the DEM of {os.path.basename(os.path.dirname(flight))} "
        f"reaching the runner: {json.dumps(out)}")
    if not (out["digest_is_cv2s"] and out["equal"]):
        raise RuntimeError(f"jp2: the DEM is not cv2's uint16 times "
                           f"dem_scale: {out}")
    return out


def jp2_replay(root: str) -> dict:
    """Path 17 (b, b'): the main path's model replayed over the committed
    JPEG 2000 flight, its PNG twin written here and the HTJ2K flight; every
    JPEG 2000 and HTJ2K fix within ``JP2_FIX_M`` of the truth and
    ``JP2_MOVE_M`` of the PNG one's; both DEMs reaching the runner as cv2
    reads them."""
    png = jp2_png_flight(root)
    report = os.path.join(root, "r.json")
    out = {"dem": jp2_dem_reaches_runner(),
           "jp2": _replay_learned(JP2_FLIGHT, report, "JPEG 2000"),
           "png": _replay_learned(png, report, "JPEG 2000's PNG twin"),
           "htj2k_dem": jp2_dem_reaches_runner(HTJ2K_FLIGHT),
           "htj2k": _replay_learned(HTJ2K_FLIGHT, report, "HTJ2K")}
    png_fixes = out["png"].pop("fixes")
    for kind, tag in (("jp2", "JPEG 2000"), ("htj2k", "HTJ2K")):
        fixes = out[kind].pop("fixes")
        worst = {"max_horiz_m": max(r["horiz_m"] for r in fixes),
                 "max_up_m": max(abs(r["up_m"]) for r in fixes)}
        out[kind]["worst"] = worst
        moved = _moved(fixes, png_fixes)
        out[f"{kind}_to_png"] = {
            "max_horiz_m": max(m["horiz_m"] for m in moved),
            "max_up_m": max(m["up_m"] for m in moved)}
        log(f"[jp2 replay] each fix's move, {tag} -> PNG flight: {moved}")
        if max(worst.values()) > JP2_FIX_M:
            raise RuntimeError(f"jp2: a {tag} fix is {worst} from the "
                               f"truth")
        if max(out[f"{kind}_to_png"].values()) > JP2_MOVE_M:
            raise RuntimeError(f"jp2: a {tag} fix moved "
                               f"{out[f'{kind}_to_png']} from the PNG "
                               f"flight's")
    return out


def jp2_gis_fetch(flight: str = JP2_FLIGHT, key: str = "jp2_cv2") -> dict:
    """Path 17 (c, c'): the GIS node asking for ``image/jp2`` from a
    loopback stub that answers with a flight's map (JPEG 2000 or HTJ2K):
    its raster equal to cv2's grey read of those bytes."""
    with open(os.path.join(flight, "flight.json")) as f:
        want = json.load(f)[key]["map.png"]
    return _gis_fetch("image/jp2", flight, want,
                      "htj2k" if key == "ht_cv2" else "jp2")


_RSS_PROBE = """
import json, resource, sys, time
from gisnav_tpu_torch.gis.imgcodecs import decode_image
from gisnav_tpu_torch.gis.jpeg2000 import _lib


def kb():  # this process's peak resident memory
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


_lib()
data = open(sys.argv[1], "rb").read()
before = kb()
t0 = time.perf_counter()
img = decode_image(data)
ms = (time.perf_counter() - t0) * 1e3
peak = kb()
print(json.dumps({"ms": ms, "shape": list(img.shape),
                  "decode_rss_mb": (peak - before) / 1024}))
"""
# the probe is started by a small Python of its own: a process forked from
# this one would inherit this one's peak as its own (ru_maxrss survives
# fork and exec)
_SPAWN = ("import subprocess, sys; "
          "sys.exit(subprocess.run(sys.argv[1:]).returncode)")


def jp2_decode_split(data: bytes, reps: int) -> dict:
    """Where a JPEG 2000 decode's time goes: the native decoder's timer
    read after each of ``reps`` decodes (off the timed path), medians in
    ms of the library call, its tier 1 (MQ or HT code-blocks), inverse
    wavelet and the rest (tier 2, dequantisation, colour, copies), and the
    Python rules around it."""
    from gisnav_tpu_torch.gis.imgcodecs import decode_image
    from gisnav_tpu_torch.gis.jpeg2000 import last_decode_timing

    parts = []
    for _ in range(max(reps, 3)):
        t0 = time.perf_counter()
        decode_image(data)
        host = time.perf_counter() - t0
        t = last_decode_timing()
        parts.append((host, t["total"], t["tier1"], t["wavelet"]))
    host, total, tier1, wavelet = (float(np.median(v)) * 1e3
                                   for v in zip(*parts))
    return {"library_ms": round(total, 3), "tier1_ms": round(tier1, 3),
            "wavelet_ms": round(wavelet, 3),
            "rest_ms": round(total - tier1 - wavelet, 3),
            "python_ms": round(host - total, 3),
            "tier1_share": round(tier1 / total, 4) if total else None}


def jp2_decode_times(card: str, root: str) -> list:
    """Path 17 (d): host ms p50 of ``decode_image`` on the flight's JPEG
    2000 map (2208 px, 30:1) and one of its 1088x1920 frames (25:1), the
    HTJ2K flight's map and frame (the same pixels re-coded as HT at about
    the same sizes), and a 4096x4096 irreversible RGB image
    (``j2k_mosaic`` of the 512-px fixture tile), beside PNG and JPEG
    (quality 95) of the same pixels, each split by ``jp2_decode_split``;
    the 4096-px decode's peak resident memory in a process of its own."""
    from gisnav_tpu_torch.gis.imgcodecs import decode_image
    from gisnav_tpu_torch.gis.jpeg import encode_jpeg
    from gisnav_tpu_torch.gis.png import encode_png

    with open(os.path.join(JP2_FIXTURES, JP2_TILE), "rb") as f:
        big = j2k_mosaic(f.read(), 8, 8)
    big_path = os.path.join(root, "rgb4096.j2k")
    with open(big_path, "wb") as f:
        f.write(big)
    rows = []
    for flight, name, reps in ((JP2_FLIGHT, "map.png", JP2_REPS[1]),
                               (JP2_FLIGHT, "frames/1000000.png",
                                JP2_REPS[0]),
                               (HTJ2K_FLIGHT, "map.png", JP2_REPS[1]),
                               (HTJ2K_FLIGHT, "frames/1000000.png",
                                JP2_REPS[0]),
                               (None, "rgb4096.j2k", JP2_REPS[2])):
        if name == "rgb4096.j2k":
            data = big
        else:
            with open(os.path.join(flight, name), "rb") as f:
                data = f.read()
        img = decode_image(data)
        row = {"file": name, "shape": list(img.shape),
               "coding": "HT" if flight == HTJ2K_FLIGHT else "MQ",
               "jp2_bytes": len(data),
               "jp2_ms": host_ms(lambda: decode_image(data), 1, reps),
               "split": jp2_decode_split(data, reps)}
        for fmt, encode in (("png", encode_png), ("jpeg", encode_jpeg)):
            coded = encode(img)
            row[f"{fmt}_bytes"] = len(coded)
            row[f"{fmt}_ms"] = host_ms(lambda: decode_image(coded), 1, reps)
        if name == "rgb4096.j2k":
            proc = subprocess.run(
                [sys.executable, "-c", _SPAWN, sys.executable, "-c",
                 _RSS_PROBE, big_path],
                capture_output=True, text=True, timeout=300,
                cwd=os.path.dirname(os.path.abspath(__file__)))
            if proc.returncode != 0:
                raise RuntimeError(f"jp2: the RSS probe failed: "
                                   f"{proc.stderr[-2000:]}")
            row["rss_probe"] = json.loads(proc.stdout.strip().splitlines()
                                          [-1])
        row["card"] = card
        log(f"[jp2] decode {json.dumps(row)}")
        rows.append(row)
    return rows


def phase_jp2_path() -> dict:
    """Path 17: JPEG 2000 and HTJ2K read as cv2 reads them, on the card
    machine (no cv2, no OpenJPEG): the fixtures of both sets (a), the main
    path's model replayed over the committed JPEG 2000 flight beside its
    PNG twin and over the HTJ2K flight (b, b'), the GIS node's JPEG 2000
    and HTJ2K fetches (c, c') and decode times with their split (d)."""
    import tempfile

    from gisnav_tpu_torch.native import build_native_lib

    t0 = time.time()
    lib = build_native_lib("jpeg2000")
    card = card_label()
    out = {"build_s": round(time.time() - t0, 2), "card": card,
           "fixtures": jp2_fixtures()}
    log(f"[jp2] decoder {lib} in {out['build_s']} s")
    with tempfile.TemporaryDirectory() as root:
        out["replay"] = jp2_replay(root)
        out["gis_fetch"] = jp2_gis_fetch()
        out["gis_fetch_htj2k"] = jp2_gis_fetch(HTJ2K_FLIGHT, "ht_cv2")
        out["decode"] = jp2_decode_times(card, root)
    log("[jp2] " + json.dumps(out))
    return out


# -- path 18: lossless and arithmetic-coded JPEG on the replay and WMS paths

# the fixtures and path 18's flight (tools/make_torch_image_fixtures.py)
JPEGX_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "data", "torch_jpegx")
JPEGX_FLIGHT = os.path.join(JPEGX_FIXTURES, "flight")
JPEGX_FIX_M = 10.0  # every fix over the arithmetic-coded flight
# a cached learned_lg9 replay of 8 frames at 2048 keypoints (sets=1): the
# map's extraction and each frame's, and 72 LightGlue blocks a frame
JPEGX_LAUNCHES = {"stem_stage": 9, "conv_stage": 72, "nms_select": 8,
                  "fused_block": 576}
JPEGX_REPS = (10, 5)  # decodes timed of a frame and of the map


def jpegx_lossless_frame() -> tuple:
    """(bytes, manifest entry) of the 1088x1920 grey lossless frame, written
    here by ``tests/torch_image_writers.py`` ``lossless_jpeg`` from the
    first frame's decoded pixels, as the fixture tool wrote it where cv2
    decoded it."""
    from gisnav_tpu_torch.gis.imgcodecs import IMREAD_GRAYSCALE, decode_image

    with open(os.path.join(JPEGX_FLIGHT, "flight.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(JPEGX_FLIGHT, manifest["lossless_from"]),
              "rb") as f:
        pixels = decode_image(f.read(), IMREAD_GRAYSCALE)
    data = image_writers().lossless_jpeg([pixels], [(1, 1)],
                                         psv=manifest["lossless_psv"])
    return data, manifest["lossless_frame"]


def jpegx_fixtures() -> dict:
    """Path 18 (a): every committed lossless and arithmetic-coded fixture
    under both flags, the flight's files under the grey flag (as replay
    reads them), and the lossless frame written here (its bytes the fixture
    tool's) under both flags, each pixel digest equal to cv2's."""
    import hashlib

    from gisnav_tpu_torch.gis.imgcodecs import (IMREAD_GRAYSCALE,
                                                IMREAD_UNCHANGED,
                                                decode_image)

    with open(os.path.join(JPEGX_FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    with open(os.path.join(JPEGX_FLIGHT, "flight.json")) as f:
        flight = json.load(f)
    flags = {"unchanged": IMREAD_UNCHANGED, "grayscale": IMREAD_GRAYSCALE}
    cases = []
    for name, want in sorted(digests.items()):
        with open(os.path.join(JPEGX_FIXTURES, name), "rb") as f:
            data = f.read()
        cases += [(name, data, key, want[key]) for key in flags]
    for name, want in sorted(flight["jpegx_cv2"].items()):
        with open(os.path.join(JPEGX_FLIGHT, name), "rb") as f:
            cases.append((name, f.read(), "grayscale", want))
    lossless, want = jpegx_lossless_frame()
    bad = []
    if hashlib.sha256(lossless).hexdigest() != want["file_sha256"]:
        bad.append(("lossless frame", "bytes", len(lossless)))
    cases += [("lossless frame", lossless, key, want[key]) for key in flags]
    for name, data, key, want in cases:
        got = image_digest(decode_image(data, flags[key]))
        if got != want:
            bad.append((name, key, got))
    out = {"files": len(digests) + len(flight["jpegx_cv2"]) + 1,
           "decodes": len(cases), "mismatches": len(bad)}
    log(f"[jpegx] fixtures against cv2's digests: {json.dumps(out)}")
    if bad:
        raise RuntimeError(f"jpegx: fixtures not decoded as cv2: {bad}")
    return out


def jpegx_replay(report: str) -> dict:
    """Path 18 (b): the main path's model replayed over the committed
    arithmetic-coded flight: every frame valid and within ``JPEGX_FIX_M``
    of the truth, K1-K4 launched ``JPEGX_LAUNCHES`` times."""
    out = _replay_learned(JPEGX_FLIGHT, report, "arithmetic JPEG")
    fixes = out.pop("fixes")
    out["worst"] = {"max_horiz_m": max(r["horiz_m"] for r in fixes),
                    "max_up_m": max(abs(r["up_m"]) for r in fixes)}
    launches = {k: out["launches"].get(k, 0) for k in JPEGX_LAUNCHES}
    log(f"[jpegx replay] worst fix {json.dumps(out['worst'])}, launches "
        f"{launches}")
    if out["worst"]["max_horiz_m"] > JPEGX_FIX_M or len(fixes) != 8:
        raise RuntimeError(f"jpegx: {len(fixes)} fixes, the worst "
                           f"{out['worst']} from the truth")
    if launches != JPEGX_LAUNCHES:
        raise RuntimeError(f"jpegx: launches {launches}, not "
                           f"{JPEGX_LAUNCHES}")
    return out


def jpegx_gis_fetch() -> dict:
    """Path 18 (c): the GIS node asking for ``image/jpeg`` (its default)
    from a loopback stub that answers with the flight's arithmetic-coded
    progressive map: its raster equal to cv2's grey read of those bytes."""
    with open(os.path.join(JPEGX_FLIGHT, "flight.json")) as f:
        want = json.load(f)["jpegx_cv2"]["map.png"]
    return _gis_fetch("image/jpeg", JPEGX_FLIGHT, want, "jpegx")


def _decode_pcts(data: bytes, reps: int) -> dict:
    """Host ms p50 / p90 of ``decode_image`` on ``data`` over ``reps``
    calls after one."""
    from gisnav_tpu_torch.gis.imgcodecs import decode_image

    decode_image(data)
    ms = []
    for _ in range(reps):
        t = time.perf_counter()
        decode_image(data)
        ms.append((time.perf_counter() - t) * 1e3)
    return {"bytes": len(data), **_pcts(ms)}


def jpegx_decode_times(card: str) -> list:
    """Path 18 (d): host ms of ``decode_image`` on the 2208-px map as
    arithmetic-coded sequential and progressive JPEG and on a 1088x1920
    frame as arithmetic sequential, each beside the baseline Huffman file
    of the same pixels that the port's encoder (cv2's bytes, quality 95)
    writes; and on the lossless frame beside a PNG of its pixels."""
    from gisnav_tpu_torch.gis.imgcodecs import decode_image
    from gisnav_tpu_torch.gis.jpeg import encode_jpeg
    from gisnav_tpu_torch.gis.png import encode_png

    def read(name):
        with open(os.path.join(JPEGX_FLIGHT, name), "rb") as f:
            return f.read()

    lossless = jpegx_lossless_frame()[0]
    rows = []
    for name, files, reps in (
            ("map", {"arith_sequential": read("map_sequential.jpg"),
                     "arith_progressive": read("map.png")}, JPEGX_REPS[1]),
            ("frame", {"arith_sequential": read("frames/1000000.png")},
             JPEGX_REPS[0]),
            ("lossless frame", {"lossless": lossless}, JPEGX_REPS[0])):
        img = decode_image(next(iter(files.values())))
        base = (("png", encode_png(img)) if name == "lossless frame"
                else ("huffman_baseline", encode_jpeg(img)))
        row = {"file": name, "shape": list(img.shape), "card": card}
        for kind, data in (*files.items(), base):
            row[kind] = _decode_pcts(data, reps)
        log(f"[jpegx] decode {json.dumps(row)}")
        rows.append(row)
    return rows


def phase_jpegx_path() -> dict:
    """Path 18: lossless and arithmetic-coded JPEG read as cv2 reads them,
    on the card machine (no cv2, no libjpeg): the fixtures (a), the main
    path's model replayed over the committed arithmetic-coded flight (b),
    the GIS node's ``image/jpeg`` fetch of the arithmetic-coded map (c)
    and decode times (d)."""
    import tempfile

    card = card_label()
    out = {"card": card, "fixtures": jpegx_fixtures()}
    with tempfile.TemporaryDirectory() as root:
        out["replay"] = jpegx_replay(os.path.join(root, "r.json"))
    out["gis_fetch"] = jpegx_gis_fetch()
    out["decode"] = jpegx_decode_times(card)
    log("[jpegx] " + json.dumps(out))
    return out


# -- path 19: TIFF variants (CCITT, 10-14 bits, ZSTD) on the WMS path -----

# the fixtures (tools/make_torch_image_fixtures.py --tiffx-out)
TIFFX_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "data", "torch_tiffx")
TIFFX_DEM = "dem_u16_zstd_2208.tif"  # the DEM layer the stub serves
TIFFX_STEPS = 22  # the mock GPS warms up on 10 odometries
TIFFX_MIN_FIXES = 8
TIFFX_PERIOD_S = 0.35
TIFFX_REPS = 5  # decodes timed of each 2208-px file
TIFFX_DEVICE = "cuda"  # path 19's device; a CPU rehearsal sets "cpu"


def tiffx_fixtures() -> dict:
    """Path 19 (a): every committed TIFF variant fixture under both flags,
    each pixel digest equal to cv2's (None where cv2 gives None)."""
    from gisnav_tpu_torch.gis.imgcodecs import (IMREAD_GRAYSCALE,
                                                IMREAD_UNCHANGED,
                                                decode_image)

    with open(os.path.join(TIFFX_FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    flags = {"unchanged": IMREAD_UNCHANGED, "grayscale": IMREAD_GRAYSCALE}
    bad, nones = [], 0
    for name, want in sorted(digests.items()):
        with open(os.path.join(TIFFX_FIXTURES, name), "rb") as f:
            data = f.read()
        for key, flag in flags.items():
            got = image_digest(decode_image(data, flag))
            nones += want[key] is None
            if got != want[key]:
                bad.append((name, key, got))
    out = {"files": len(digests), "decodes": 2 * len(digests),
           "none_verdicts": nones, "mismatches": len(bad)}
    log(f"[tiffx] fixtures against cv2's digests: {json.dumps(out)}")
    if bad:
        raise RuntimeError(f"tiffx: fixtures not decoded as cv2: {bad}")
    return out


def _tiffx_stub(world, dem: bytes):
    """A loopback WMS over ``world`` (a future of the world, made while
    the graph is built): GetMap of the imagery layer a 256-px tiled
    deflate GeoTIFF with predictor 2 of the world's crop, of the DEM layer
    ``dem``. Returns (server, thread, the layers asked)."""
    import threading
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from gisnav_tpu_torch.gis.tiff import encode_tiff

    asked = []

    class Stub(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server's name)
            q = {k.lower(): v[0] for k, v in urllib.parse.parse_qs(
                urllib.parse.urlparse(self.path).query).items()}
            asked.append((q.get("layers"), q.get("format")))
            if q.get("layers") == "dem":
                body = dem
            else:
                left, bottom, right, top = (float(v) for v in
                                            q["bbox"].split(","))
                h, w = int(q["height"]), int(q["width"])
                body = encode_tiff(world.result().crop(
                    (left, bottom, right, top), h, w), 8, 2, tile=(256, 256),
                                   geo=(left, top, (right - left) / w,
                                        (top - bottom) / h))
            self.send_response(200)
            self.send_header("Content-Type", "image/tiff")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, asked


def _fly_behind_stub(tag: str, root: str, url: str, wms_format: str,
                     overlap: float, track: list, made, device: str,
                     period_s: float) -> dict:
    """Fly ``run``'s graph (path 15's, at the main path's width) over
    ``track`` (lon, lat, alt, yaw a step) behind the stub WMS at ``url``:
    the graph built from a params file, each step's frame rendered from
    ``made`` (a future of the world) and published with its position and
    attitude after a GIS tick, paced to ``period_s``. Fails unless every
    step ran a frame's or a refresh's K1-K4 launches. Returns the maps,
    fixes, poses and the GIS ticks' messages (None before a map) with
    each fix's and pose's (horizontal, vertical) error and the times."""
    from concurrent.futures import ThreadPoolExecutor

    from gisnav_tpu_torch.cli import build_app, build_parser
    from gisnav_tpu_torch.constants import (
        ROS_TOPIC_CAMERA_INFO,
        ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS,
        ROS_TOPIC_MAVROS_GLOBAL_POSITION,
    )
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.nodes.gis_node import TOPIC_ORTHOIMAGE
    from gisnav_tpu_torch.nodes.mock_gps import TOPIC_SENSOR_GPS
    from gisnav_tpu_torch.nodes.pose_node import TOPIC_POSE
    from gisnav_tpu_torch.utils.world_wms import camera_attitude_quat

    with open(os.path.join(WEBP_FLIGHT, "camera.json")) as f:
        camera = json.load(f)
    k = np.array(camera["k"])
    hw = (camera["height"], camera["width"])
    lon0, lat0, alt, yaw = track[0]
    t0 = time.perf_counter()
    params = {"gis_node": {"wms_url": url, "wms_format": wms_format,
                           "wms_layers": ["imagery"],
                           "wms_dem_layers": ["dem"],
                           "min_map_overlap_update_threshold": overlap},
              "pose_node": {"image_shape": list(hw),
                            "max_keypoints": DEMO_KP,
                            "ground_altitude_m": 0.0},
              "twist_node": {"ground_altitude_m": 0.0},
              "bbox_node": {"ground_altitude_m": 0.0}}
    path = os.path.join(root, f"{tag}_params.json")
    with open(path, "w") as f:
        json.dump(params, f)
    maps, fixes, poses, ticks = [], [], [], []
    arrivals, published, truth, times = {}, {}, {}, {}
    pool = ThreadPoolExecutor(3)  # the frames, while the graph flies
    try:
        app = build_app(build_parser().parse_args(
            ["run", "--params", path, "--device", device]))
        times["app_s"] = time.perf_counter() - t0
        cfg = app.pose._config
        if not (app.bus._async and app.pose._deep_runner is not None
                and cfg.lightglue_depth == 9 and cfg.image_shape == hw
                and cfg.max_keypoints == DEMO_KP):
            raise RuntimeError(f"{tag}: not run's graph at the main path's "
                               f"width ({cfg})")
        world = made.result()
        times["world_s"] = time.perf_counter() - t0
        frames = [pool.submit(world.render_frame, lon, lat, a, y, k, hw)
                  for lon, lat, a, y in track]
        gis_tick = app.gis.tick

        def tick():  # every GIS tick's published map (None: none yet)
            msg = gis_tick()
            ticks.append(msg)
            return msg

        app.gis.tick = tick

        def on_fix(msg):  # on the mock-GPS node's worker thread
            arrivals[msg["timestamp_sample"]] = time.perf_counter()
            fixes.append(msg)

        def handled(node) -> int:
            return node.timing_stats().get("_image_cb", {}).get("calls", 0)

        runner = app.pose._deep_runner
        app.bus.subscribe(TOPIC_SENSOR_GPS, on_fix)
        app.bus.subscribe(TOPIC_ORTHOIMAGE, maps.append)
        app.bus.subscribe(TOPIC_POSE, poses.append)
        app.bus.publish(ROS_TOPIC_CAMERA_INFO,
                        {"k": k, "width": hw[1], "height": hw[0]})
        app.bus.publish(ROS_TOPIC_MAVROS_GLOBAL_POSITION,
                        {"stamp_us": 500_000, "lat": lat0, "lon": lon0,
                         "alt_ellipsoid": alt})
        app.bus.publish(ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS,
                        {"stamp_us": 500_000,
                         "quat_xyzw": camera_attitude_quat(yaw)})
        deadline = time.monotonic() + DEMO_FRAME_DEADLINE_S[1]
        while app.pose._ortho is None:
            app.gis.tick()
            if time.monotonic() > deadline:
                raise RuntimeError(f"{tag}: no map reached the pose node")
            time.sleep(0.05)
        times["first_map_s"] = time.perf_counter() - t0
        reset_launches()
        ran0, per_step = runner.stats["frames"], []
        try:
            for i, ((lon, lat, a, y), frame) in enumerate(zip(track,
                                                               frames)):
                frame = frame.result()
                stamp = 1_000_000 * (i + 1)
                truth[stamp] = (lon, lat, a)
                before = dict(LAUNCHES)
                published[stamp] = _publish_step(app.bus, stamp, lon, lat,
                                                 a, y, frame, app.gis)
                deadline = time.monotonic() + DEMO_FRAME_DEADLINE_S[i > 0]
                while min(handled(app.pose), handled(app.twist)) < i + 1:
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"{tag}: step {i} not handled")
                    time.sleep(0.002)
                per_step.append({n: LAUNCHES[n] - before[n]
                                 for n in LAUNCHES})
                time.sleep(max(0.0, published[stamp] + period_s
                               - time.perf_counter()))
            t_quiet, seen = time.monotonic(), len(fixes)
            while time.monotonic() - t_quiet < DEPLOY_QUIET_S:
                time.sleep(0.05)
                if len(fixes) != seen:
                    seen, t_quiet = len(fixes), time.monotonic()
        finally:
            app.shutdown()
        ran = runner.stats["frames"] - ran0
        times["flown_s"] = time.perf_counter() - t0
    finally:
        pool.shutdown(cancel_futures=True)
    launches = dict(LAUNCHES)
    frame = {n: GRAPH_FRAME.get(n, 0) for n in launches}
    refresh = {n: GRAPH_REFRESH.get(n, 0) for n in launches}
    refreshes = sum(n == refresh for n in per_step)
    odd = [(i, n) for i, n in enumerate(per_step)
           if n not in (frame, refresh)]
    if odd or ran != len(track):
        raise RuntimeError(f"{tag}: {ran} frames ran; steps launching "
                           f"neither a frame's nor a refresh's kernels: "
                           f"{odd}")
    expect_launches(tag, launches, {
        n: ran * frame[n] + refreshes * (refresh[n] - frame[n])
        for n in PATH1_KERNELS})
    return {"world": world, "maps": maps, "fixes": fixes, "poses": poses,
            "ticks": ticks, "ran": ran, "launches": launches,
            "refreshes": int(refreshes), "times": times,
            "dropped": app.bus.dropped,
            "frame_to_fix": _pcts(_latencies(published, arrivals)),
            "errors": [_fix_errors(f, *truth[f["timestamp_sample"]])
                       for f in fixes],
            "pose_errors": [_fix_errors(
                {"lat": p["lat"] * 1e7, "lon": p["lon"] * 1e7,
                 "alt_ellipsoid": p["alt_ellipsoid"] * 1e3},
                *truth[p["stamp_us"]]) for p in poses]}


def tiffx_flight(root: str) -> dict:
    """Path 19 (b): run's graph (path 15's, at the main path's width) flown
    ``TIFFX_STEPS`` steps over path 16's flat world behind a stub WMS whose
    DEM layer is a uint16 ZSTD GeoTIFF, which cv2 reads as None: every map
    published with a zero DEM and the world's crop as its image, at least
    ``TIFFX_MIN_FIXES`` uORB fixes, each within 10 m of the truth (the pose
    node's fixes printed), every step's K1-K4 launches a frame's or a
    bucket refresh's."""
    from concurrent.futures import ThreadPoolExecutor

    from gisnav_tpu_torch.utils.world_wms import World

    with open(os.path.join(WEBP_FLIGHT, "flight.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(WEBP_FLIGHT, "poses.csv")) as f:
        first = next(csv.DictReader(f))
    with open(os.path.join(TIFFX_FIXTURES, TIFFX_DEM), "rb") as f:
        dem = f.read()
    lon0, lat0 = float(first["lon"]), float(first["lat"])
    alt, yaw = float(first["alt_ellipsoid_m"]), float(first["yaw_deg"])
    track = [(lon0 + 1e-4 * i, lat0 + 5e-5 * i, alt, yaw)
             for i in range(TIFFX_STEPS)]
    pool = ThreadPoolExecutor(1)  # the world, while the graph is built
    made = pool.submit(World.make, **manifest["world"])
    server, thread, asked = _tiffx_stub(made, dem)
    try:
        flown = _fly_behind_stub(
            "tiffx", root, f"http://127.0.0.1:{server.server_address[1]}"
            "/wms", "image/tiff", GRAPH_OVERLAP, track, made, TIFFX_DEVICE,
            TIFFX_PERIOD_S)
    finally:
        pool.shutdown(cancel_futures=True)
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    maps, fixes, errors = flown["maps"], flown["fixes"], flown["errors"]
    dem_asks = [fmt for layer, fmt in asked if layer == "dem"]
    zero_dem = all(not np.asarray(m["dem"]).any() for m in maps)
    first_map = maps[0] if maps else None
    crop_equal = first_map is not None and np.array_equal(
        first_map["image"], flown["world"].crop(
            (first_map["bbox"].left, first_map["bbox"].bottom,
             first_map["bbox"].right, first_map["bbox"].top),
            *first_map["image"].shape))
    out = {"steps": TIFFX_STEPS, "frames_ran": flown["ran"],
           "maps": len(maps), "dem_requests": len(dem_asks),
           "zero_dem": zero_dem, "map_is_crop": bool(crop_equal),
           "fixes": len(fixes), "pose_fixes": len(flown["poses"]),
           "max_horiz_m": max((e[0] for e in errors), default=None),
           "max_vert_m": max((e[1] for e in errors), default=None),
           "max_pose_horiz_m": max((e[0] for e in flown["pose_errors"]),
                                   default=None),
           "bucket_refreshes": flown["refreshes"],
           "launches": flown["launches"],
           "frame_to_fix": flown["frame_to_fix"],
           **{k: round(v, 2) for k, v in flown["times"].items()},
           "dropped": flown["dropped"]}
    log(f"[tiffx] flight {json.dumps(out, default=str)}")
    log("[tiffx] SensorGps fixes (stamp, m, m): " + str(
        [(f["timestamp_sample"], round(h, 2), round(v, 2))
         for f, (h, v) in zip(fixes, errors)]))
    far = [e for e in errors if not (e[0] < 10.0 and e[1] < 10.0)]
    if (not maps or not zero_dem or not crop_equal or not dem_asks
            or len(fixes) < TIFFX_MIN_FIXES or far):
        raise RuntimeError(f"tiffx: {len(maps)} maps (zero DEM {zero_dem}, "
                           f"the crop {crop_equal}), {len(dem_asks)} DEM "
                           f"requests, {len(fixes)} fixes, {len(far)} over "
                           f"10 m")
    return out


def tiffx_decode_times(card: str) -> list:
    """Path 19 (c): host ms p50 / p90 of ``decode_image`` on the 2208-px
    map as bilevel Group 4 and Group 3 2-D, beside PNG of the same
    pixels (the port's encoder)."""
    from gisnav_tpu_torch.gis.imgcodecs import decode_image
    from gisnav_tpu_torch.gis.png import encode_png

    rows = []
    for name in ("map_2208_g4.tif", "map_2208_g3_2d.tif"):
        with open(os.path.join(TIFFX_FIXTURES, name), "rb") as f:
            data = f.read()
        img = decode_image(data)
        png = encode_png(img)
        if not np.array_equal(decode_image(png), img):
            raise RuntimeError(f"tiffx: the PNG of {name} is not its pixels")
        row = {"file": name, "shape": list(img.shape), "card": card,
               "tiff": _decode_pcts(data, TIFFX_REPS),
               "png": _decode_pcts(png, TIFFX_REPS)}
        log(f"[tiffx] decode {json.dumps(row)}")
        rows.append(row)
    return rows


def phase_tiffx_path() -> dict:
    """Path 19: TIFF read as cv2 5.0's libtiff reads it, on the card
    machine (no cv2, no libtiff): the fixtures (a), run's graph flown over
    a WMS whose DEM is a ZSTD GeoTIFF (b) and fax decode times (c)."""
    import tempfile

    from gisnav_tpu_torch.native import build_native_lib

    t0 = time.time()
    lib = build_native_lib("fax3")
    card = card_label()
    out = {"build_s": round(time.time() - t0, 2), "card": card,
           "fixtures": tiffx_fixtures()}
    log(f"[tiffx] CCITT decoder {lib} in {out['build_s']} s")
    with tempfile.TemporaryDirectory() as root:
        out["flight"] = tiffx_flight(root)
    out["decode"] = tiffx_decode_times(card)
    log("[tiffx] " + json.dumps(out, default=str))
    return out


DAMAGED_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "data")
DAMAGED_STEPS, DAMAGED_STEP_M = 16, 30.0  # path 21's flight east
# a map asked on every GIS tick that sees the bbox move (a 30 m step
# keeps over 0.98 of it), so that the damage schedule meets every kind
# of reply
DAMAGED_OVERLAP = 0.999
# of 16 steps the mock GPS fixes the last 6 (it warms up on 10 odometries);
# one may come after the flight's quiet wait
DAMAGED_MIN_FIXES = 5
DAMAGED_PERIOD_S = 0.35
DAMAGED_DEM_M = 2  # the stub's flat DEM (uint8 metres)
DAMAGED_DEVICE = "cuda"  # path 21's device; a CPU rehearsal sets "cpu"


def damaged_fixtures() -> dict:
    """Path 21 (a): every seeded damage of every committed fixture
    (``tests/torch_image_writers.py`` ``damage_ops`` over
    ``damage_fixtures``), remade here from the fixtures and the seed and
    decoded under both flags, each outcome equal to cv2's digest in
    ``tests/data/torch_damaged/digests.json`` (an array's sha256, None, or
    cv2's raise on its size limits: the port's ``ValueError``)."""
    from gisnav_tpu_torch.gis.imgcodecs import decode_image

    writers = image_writers()
    with open(os.path.join(DAMAGED_DATA, "torch_damaged",
                           "digests.json")) as f:
        want = json.load(f)
    fixtures = writers.damage_fixtures(DAMAGED_DATA)
    if sorted(fixtures) != sorted(want["files"]):
        raise RuntimeError("damaged: the digests' fixtures are not the "
                           "checkout's")
    kinds = {"array": 0, "None": 0, "raises": 0}
    bad, t0 = [], time.perf_counter()
    for name, data in fixtures.items():
        ops = dict(writers.damage_ops(name, data))
        for op, digests in want["files"][name].items():
            for flag, digest in zip(want["flags"], digests):
                try:
                    got = writers.damage_digest(decode_image(ops[op], flag))
                except ValueError as err:
                    if "cv2.imdecode raises cv2.error" not in str(err):
                        raise
                    got = "raises"
                kinds["None" if digest is None else digest
                      if digest == "raises" else "array"] += 1
                if got != digest:
                    bad.append((name, op, flag, digest, got))
    out = {"files": len(fixtures), "decodes": sum(kinds.values()),
           **kinds, "mismatches": len(bad),
           "decode_s": round(time.perf_counter() - t0, 2)}
    log(f"[damaged] fixtures against cv2's digests: {json.dumps(out)}")
    if bad:
        raise RuntimeError(f"damaged: not decoded as cv2: {bad[:20]}")
    return out


def _damaging_stub(world, dem: "concurrent.futures.Future"):
    """A loopback WMS over ``world`` (a future) that damages its replies on
    a fixed schedule: imagery is PNG, every 4th reply with an IDAT byte
    flipped (cv2: None, so the GIS node keeps its map); the DEM layer an
    LZW GeoTIFF (``dem``, a future of its bytes), every 3rd reply cut in
    half (None: a zero DEM) and the 2nd with a corrupt strip (cv2's
    partial DEM). Returns (server, thread, log of (layer, reply, damage))."""
    import threading
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from gisnav_tpu_torch.gis.png import encode_png

    writers = image_writers()
    log_ = []
    counts = {"imagery": 0, "dem": 0}
    lock = threading.Lock()

    class Stub(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server's name)
            q = {k.lower(): v[0] for k, v in urllib.parse.parse_qs(
                urllib.parse.urlparse(self.path).query).items()}
            layer = "dem" if q.get("layers") == "dem" else "imagery"
            with lock:
                counts[layer] += 1
                n = counts[layer]
            if layer == "dem":
                body, ctype = dem.result(), "image/tiff"
                damage = "cut" if n % 3 == 0 else "lzw" if n == 2 else ""
                if damage == "cut":
                    body = body[:len(body) // 2]
                elif damage:
                    body = writers.strip_corrupted(body)
            else:
                left, bottom, right, top = (float(v) for v in
                                            q["bbox"].split(","))
                h, w = int(q["height"]), int(q["width"])
                body = encode_png(world.result().crop(
                    (left, bottom, right, top), h, w))
                ctype = "image/png"
                damage = "idat" if n % 4 == 0 else ""
                if damage:
                    body = writers.idat_flipped(body)
            with lock:
                log_.append((layer, n, damage))
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, log_


def _damaged_dem(size: int) -> bytes:
    """The stub's DEM: flat ``DAMAGED_DEM_M`` over ``size`` px, an LZW
    GeoTIFF of 64-row strips (``tests/torch_image_writers.py``)."""
    return image_writers().write_tiff(
        np.full((size, size), DAMAGED_DEM_M, np.uint8), compression=5,
        rows_per_strip=64)


def _dem_outcome(dem: np.ndarray) -> str:
    """How a published DEM was read: the full flat DEM, zeros (a cut reply:
    cv2's None), or partial (a strip zero after its damage)."""
    if not dem.any():
        return "cut"
    if (dem == DAMAGED_DEM_M).all():
        return ""
    return "lzw"


def damaged_flight(root: str) -> dict:
    """Path 21 (b): run's graph (path 19's: learned_lg9, bucketed, 1088x1920,
    2048 keypoints, uORB) flown ``DAMAGED_STEPS`` steps of
    ``DAMAGED_STEP_M`` east over path 8's world behind ``_damaging_stub``.
    Gates: every uORB fix within 10 m; the GIS node publishes a map on
    every tick after its first; the maps it kept and the DEMs it published
    are the schedule's (a damaged image keeps the map and asks no DEM, a
    cut DEM gives zeros, the corrupt strip a partial DEM); K1-K4 launches
    a frame's or a bucket refresh's each step, as in path 19."""
    from concurrent.futures import ThreadPoolExecutor

    from gisnav_tpu_torch.gis.wms import orthoimage_size_for_camera
    from gisnav_tpu_torch.utils.world_wms import World, east_of

    with open(os.path.join(WEBP_FLIGHT, "camera.json")) as f:
        camera = json.load(f)
    with open(os.path.join(WEBP_FLIGHT, "poses.csv")) as f:
        first = next(csv.DictReader(f))
    lon0, lat0 = float(first["lon"]), float(first["lat"])
    alt, yaw = float(first["alt_ellipsoid_m"]), float(first["yaw_deg"])
    track = [(east_of(lon0, lat0, DAMAGED_STEP_M * i), lat0, alt, yaw)
             for i in range(DAMAGED_STEPS)]
    pool = ThreadPoolExecutor(2)  # the world and the DEM, while it builds
    made = pool.submit(World.make, **GRAPH_WORLD)
    dem = pool.submit(_damaged_dem, orthoimage_size_for_camera(
        camera["width"], camera["height"])[0])
    server, thread, served = _damaging_stub(made, dem)
    try:
        dem.result()
        flown = _fly_behind_stub(
            "damaged", root, f"http://127.0.0.1:{server.server_address[1]}"
            "/wms", "image/png", DAMAGED_OVERLAP, track, made,
            DAMAGED_DEVICE, DAMAGED_PERIOD_S)
    finally:
        pool.shutdown(cancel_futures=True)
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    maps, ticks, fixes = flown["maps"], flown["ticks"], flown["fixes"]
    errors = flown["errors"]
    # the schedule: each imagery reply either updated the map (and asked
    # the DEM whose reply it published) or was damaged and kept the map
    first = next(i for i, m in enumerate(ticks) if m is not None)
    silent = [i for i, m in enumerate(ticks[first:]) if m is None]
    updates, last = [], None  # the published maps, one per update
    for m in maps:
        if m["stamp_us"] != last:
            updates.append(m)
            last = m["stamp_us"]
    images = [d for layer, _, d in served if layer == "imagery"]
    dems = [d for layer, _, d in served if layer == "dem"]
    kept = sum(d == "idat" for d in images)
    asked_after_damage = [served[i + 1][0] for i, (layer, _, d) in
                          enumerate(served[:-1])
                          if layer == "imagery" and d == "idat"]
    published_dems = [_dem_outcome(np.asarray(m["dem"])) for m in updates]
    schedule_ok = (len(updates) == len(images) - kept == len(dems)
                   and published_dems == dems
                   and "dem" not in asked_after_damage
                   and kept >= 1 and "cut" in dems and "lzw" in dems)
    out = {"steps": DAMAGED_STEPS, "frames_ran": flown["ran"],
           "ticks": len(ticks), "silent_ticks": len(silent),
           "maps": len(maps), "map_updates": len(updates),
           "imagery_replies": len(images), "kept_maps": kept,
           "dem_replies": dems, "published_dems": published_dems,
           "schedule_ok": schedule_ok, "fixes": len(fixes),
           "pose_fixes": len(flown["poses"]),
           "max_horiz_m": max((e[0] for e in errors), default=None),
           "max_vert_m": max((e[1] for e in errors), default=None),
           "max_pose_horiz_m": max((e[0] for e in flown["pose_errors"]),
                                   default=None),
           "bucket_refreshes": flown["refreshes"],
           "launches": flown["launches"],
           "frame_to_fix": flown["frame_to_fix"],
           **{k: round(v, 2) for k, v in flown["times"].items()},
           "dropped": flown["dropped"]}
    log(f"[damaged] flight {json.dumps(out, default=str)}")
    log("[damaged] WMS replies (layer, n, damage): " + str(served))
    log("[damaged] SensorGps fixes (stamp, m, m): " + str(
        [(f["timestamp_sample"], round(h, 2), round(v, 2))
         for f, (h, v) in zip(fixes, errors)]))
    far = [e for e in errors if not (e[0] < 10.0 and e[1] < 10.0)]
    if (silent or not schedule_ok or len(fixes) < DAMAGED_MIN_FIXES
            or far):
        raise RuntimeError(f"damaged: {len(silent)} ticks without a map, "
                           f"schedule {schedule_ok} (DEMs {dems} published "
                           f"as {published_dems}), {len(fixes)} fixes, "
                           f"{len(far)} over 10 m")
    return out


def phase_damaged_path() -> dict:
    """Path 21: damaged images read as cv2 5.0 reads them, on the card
    machine (no cv2): the committed fixtures' seeded damage against cv2's
    digests (a) and run's graph flown behind a WMS that damages its
    replies (b)."""
    import tempfile

    t0 = time.time()
    out = {"card": card_label(), "fixtures": damaged_fixtures()}
    with tempfile.TemporaryDirectory() as root:
        out["flight"] = damaged_flight(root)
    out["s"] = round(time.time() - t0, 1)
    log("[damaged] " + json.dumps(out, default=str))
    return out


BENCH_OVER_PATH1 = 1.1  # bench's bucketed p50 / path 1's graphed frame p50


def phase_bench_path(path1_frame_p50_ms=None) -> dict:
    """Path 20: ``python -m gisnav_tpu_torch bench`` (``cli.main``, in this
    process so that the counts see it), its JSON line printed and gated."""
    import contextlib
    import io

    from gisnav_tpu_torch import bench, cli
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches

    t0 = time.time()
    reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["bench"])
    launches = dict(LAUNCHES)
    text = out.getvalue().strip()
    if rc != 0 or not text:
        raise RuntimeError(f"path 20: bench exited {rc}: {text[-500:]}")
    line = json.loads(text.splitlines()[-1])
    log("[bench] " + json.dumps(line))
    for name, st in bench.LAST.items():
        event = (f"{np.median(st['event_ms']):.2f}" if st["event_ms"]
                 else "not measured")
        capture = ("no capture" if st["capture_s"] is None else
                   f"capture {st['capture_s']:.2f} s, graph pool "
                   f"{st['pool_mib']:.1f} MiB")
        what = (f"{st['frames']} frames" if st["frames"] else
                f"{bench.REFRESH_SCAN} extractions")
        log(f"[bench] {name}: one replay of {what}, host ms "
            f"{', '.join(f'{t:.2f}' for t in st['host_ms'])}, CUDA-event "
            f"ms p50 {event}, {capture}, launches {st['launches']}")
    rows = {"bucketed_warp_mode": line["bucketed_warp_mode"],
            "warp_exact_mode": line["warp_exact_mode"],
            "cached_mode": line["cached_mode"],
            "small_config": line["small_config"] or {}}
    bad = [k for k, row in rows.items()
           if not (np.isfinite(row.get("fps", np.nan)) and row["fps"] > 0)]
    if bad or "error" in rows["small_config"]:
        raise RuntimeError(f"path 20: rows without a finite positive fps "
                           f"{bad}, small_config {line['small_config']}")
    for k in ("bucketed_warp_mode", "warp_exact_mode"):
        if rows[k]["valid_fraction"] != 1.0:
            raise RuntimeError(f"path 20: {k} valid_fraction "
                               f"{rows[k]['valid_fraction']}, not 1.0")
    b = bench.LAST["bucketed"]
    frames = b["frames"] * len(b["host_ms"])
    per_frame = {k: b["launches"].get(k, 0) / frames for k in LAUNCHES}
    want = {k: float(GRAPH_FRAME.get(k, 0)) for k in LAUNCHES}
    if per_frame != want:
        raise RuntimeError(f"path 20: bucketed replays launched "
                           f"{per_frame} a frame, expected {want}")
    p50 = rows["bucketed_warp_mode"]["p50_latency_ms"]
    if path1_frame_p50_ms is not None and \
            p50 > BENCH_OVER_PATH1 * path1_frame_p50_ms:
        raise RuntimeError(f"path 20: bucketed p50 {p50} ms over "
                           f"{BENCH_OVER_PATH1} x path 1's graphed frame "
                           f"{path1_frame_p50_ms:.2f} ms")
    path1 = ("not run" if path1_frame_p50_ms is None
             else f"{path1_frame_p50_ms:.2f} ms")
    log(f"[bench] bucketed p50 {p50} ms against path 1's graphed frame "
        f"{path1}; {time.time() - t0:.1f} s with the fixtures and "
        f"captures; launches over the command {launches}")
    return {"line": line, "launches": launches}


ENVELOPE_DEVICE = "cuda"  # path 22's device; a CPU rehearsal sets "cpu"
ENVELOPE_SWEEP = ["--alts", "500", "--world-gsd", "0.417"]
ENVELOPE_BUCKET_YAWS = [7.5 + 45.0 * k for k in range(8)]  # bucket edges
ENVELOPE_WARP_YAWS = [45.0 * k for k in range(8)]
# the JAX repository's card records of the same sweeps, quoted (files
# benchmarks/sweep_headline_bucketed.json, sweep_headline_warp.json and
# sweep_cached_prior30.json): valid, within 10 m, mean and max metres
ENVELOPE_JAX_RECORDS = {
    "bucketed": {"valid": 8, "pass_10m": 8, "mean_horiz_m": 0.96,
                 "max_horiz_m": 1.49},
    "warp": {"valid": 8, "pass_10m": 8, "mean_horiz_m": 0.73,
             "max_horiz_m": 1.75},
    "cached_prior30": {"valid": 6, "pass_10m": 3, "mean_horiz_m": 15.84,
                       "max_horiz_m": 35.57},
}


def _sweep_tool():
    """``tools/sweep_headline_torch.py`` as a module of this process."""
    import importlib.util

    name = "sweep_headline_torch"
    if name not in sys.modules:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tools", name + ".py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _envelope_sweep(tool, tag: str, argv: list, world=None,
                    per_frame: dict = None) -> dict:
    """One sweep of the tool in this process: its summary, the launches of
    each frame (the counts read after each pose), host seconds; with
    ``per_frame`` every frame must launch exactly those kernels."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches

    args = tool.parse_args(argv + ["--device", ENVELOPE_DEVICE])
    t0 = time.time()
    reset_launches()
    frames, frame_ms, last = [], [], dict(LAUNCHES)

    def on_frame(row, ms):
        frames.append({k: LAUNCHES[k] - last[k] for k in LAUNCHES})
        frame_ms.append(ms)
        last.update(LAUNCHES)

    summary = tool.sweep(args, world, on_frame)
    out = {"summary": summary, "launches": dict(LAUNCHES),
           "frame_launches": frames, "frame_ms": frame_ms,
           "s": round(time.time() - t0, 1)}
    jax_rec = ENVELOPE_JAX_RECORDS[tag]
    log(f"[envelope] {tag}: {summary['valid']}/{summary['poses']} valid, "
        f"{summary['pass_10m']} within 10 m, mean "
        f"{summary['mean_horiz_m']} m, max {summary['max_horiz_m']} m "
        f"(the JAX repository's record: {jax_rec['valid']} valid, "
        f"{jax_rec['pass_10m']} within 10 m, mean "
        f"{jax_rec['mean_horiz_m']} m, max {jax_rec['max_horiz_m']} m); "
        f"{_frame_ms_text(frame_ms)}; {out['s']} s on the host clock with "
        f"the renders and the runner's captures")
    if per_frame is not None:
        want = {k: per_frame.get(k, 0) for k in LAUNCHES}
        odd = [(i, n) for i, n in enumerate(frames) if n != want]
        if odd:
            raise RuntimeError(f"path 22 {tag}: frames launched {odd}, "
                               f"expected {want} each")
    return out


def _frame_ms_text(ms: list) -> str:
    """The first frame's host ms (its graph captures) and the others'."""
    rest = ms[1:] or ms
    return (f"frame host ms: first {ms[0]:.1f}, then p50 "
            f"{np.median(rest):.2f} / max {max(rest):.2f}")


def _envelope_fly(runner, ortho, dem, aff, k, frames, tag: str,
                  **kw) -> list:
    """Each (yaw, lon, lat, frame) through ``runner``: rows of (yaw, valid,
    inliers, horizontal error m, host ms of the synchronised call),
    logged."""
    from gisnav_tpu_torch.geometry.crs import haversine_m
    from gisnav_tpu_torch.pipeline.geopose import geopose_to_wgs84_f64

    rows = []
    for yaw, lon, lat, frame in frames:
        t0 = time.perf_counter()
        pose = runner(frame, ortho, dem, yaw, k, aff, **kw)
        if ENVELOPE_DEVICE != "cpu":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        fix = geopose_to_wgs84_f64(pose, np.asarray(aff, np.float64))
        horiz = haversine_m(lat, lon, fix["lat"], fix["lon"])
        rows.append((yaw, bool(pose.valid), int(pose.num_inliers),
                     round(float(horiz), 2), round(ms, 2)))
        log(f"[envelope] {tag} yaw {yaw:6.1f}: valid={bool(pose.valid)} "
            f"inliers={int(pose.num_inliers)} error={horiz:.2f} m "
            f"{ms:.2f} ms")
    return rows


def _envelope_gate(tag: str, rows: list) -> None:
    bad = [r for r in rows if not r[1] or not r[3] < 10.0]
    if bad:
        raise RuntimeError(f"path 22 {tag}: fixes invalid or over 10 m: "
                           f"{bad} of {rows}")


def phase_envelope_path() -> dict:
    """Path 22: the JAX repository's accuracy battery on the port (see the
    module docstring): the headline sweeps through the tool, then the
    appearance, fractal and field-boundary gates through the runners."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.runners import (make_cached_deep_runner,
                                                   make_deep_runner)
    from gisnav_tpu_torch.utils import envelope
    from gisnav_tpu_torch.weights import load_bundled

    t_path = time.time()
    card = card_label()
    tool = _sweep_tool()
    out = {"card": card, "host_s": {}}
    # (a) and (b): one render of the 0.417 m/px world
    t0 = time.time()
    world = tool.make_world(tool.parse_args(ENVELOPE_SWEEP))
    out["host_s"]["matched_world"] = round(time.time() - t0, 1)
    log(f"[envelope] matched world {world.img.shape} at {world.gsd_m} m/px "
        f"rendered on the host in {out['host_s']['matched_world']} s")
    refresh = {k: GRAPH_REFRESH.get(k, 0) for k in PATH1_KERNELS}
    out["bucketed"] = _envelope_sweep(
        tool, "bucketed", ENVELOPE_SWEEP + [
            "--mode", "warp-bucketed", "--yaws",
            *map(str, ENVELOPE_BUCKET_YAWS)], world, refresh)
    # the exact warp's pair: SuperPoint twice, the dual LightGlue once
    out["warp"] = _envelope_sweep(
        tool, "warp", ENVELOPE_SWEEP + [
            "--mode", "warp", "--yaws", *map(str, ENVELOPE_WARP_YAWS)],
        world, refresh)
    del world
    for tag in ("bucketed", "warp"):
        sm = out[tag]["summary"]
        if not (sm["poses"] == sm["valid"] == sm["pass_10m"] == 8):
            raise RuntimeError(f"path 22 {tag}: {sm['valid']} valid and "
                               f"{sm['pass_10m']} within 10 m of "
                               f"{sm['poses']}: {sm['rows']}")
    # (c) cached with a 30 m prior on the legacy world: printed only
    t0 = time.time()
    out["cached_prior30"] = _envelope_sweep(
        tool, "cached_prior30", ["--alts", "500", "--mode", "cached",
                                 "--prior-m", "30"])
    out["host_s"]["cached_prior30"] = round(time.time() - t0, 1)
    # (d) the appearance battery
    t0 = time.time()
    ortho, dem, aff = envelope.appearance_map()
    k_app = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]],
                     np.float32)
    runner = make_deep_runner(*load_bundled("learned_lg9"),
                              device=ENVELOPE_DEVICE)
    reset_launches()
    appearance = {}
    for name in sorted(envelope.APPEARANCE):
        frames = envelope.appearance_frames(envelope.APPEARANCE[name],
                                            np.random.default_rng(42))
        appearance[name] = _envelope_fly(
            runner, ortho, dem, aff, k_app, frames, f"appearance {name}",
            map_stamp=1, altitude_agl=envelope.ALT_M)
    harris = make_cached_deep_runner(*load_bundled("harris_lg5"),
                                     device=ENVELOPE_DEVICE)
    frames = envelope.appearance_frames(envelope.sun_shadows,
                                        np.random.default_rng(42))
    out["appearance"] = {"rows": appearance, "harris_cached_sun_shadows":
                         _envelope_fly(harris, ortho, dem, aff, k_app, frames,
                                       "harris_lg5 cached sun_shadows "
                                       "(printed only)", map_stamp=1,
                                       altitude_agl=envelope.ALT_M),
                         "launches": dict(LAUNCHES)}
    out["host_s"]["appearance"] = round(time.time() - t0, 1)
    del runner, harris
    log("[envelope] appearance: " + _frame_ms_text(
        [r[4] for rows in appearance.values() for r in rows]))
    for name, rows in appearance.items():
        _envelope_gate(f"appearance {name}", rows)
    # (e) the fractal world at make_deep_runner()'s defaults (harris_lg5)
    t0 = time.time()
    ortho, dem, aff, frames = envelope.fractal_scene(envelope.fractal_world())
    out["host_s"]["fractal_world"] = round(time.time() - t0, 1)
    reset_launches()
    rows = _envelope_fly(make_deep_runner(device=ENVELOPE_DEVICE), ortho,
                         dem, aff, envelope.K_CAM, frames, "fractal",
                         altitude_agl=envelope.ALT_M)
    out["fractal"] = {"rows": rows, "launches": dict(LAUNCHES)}
    out["host_s"]["fractal"] = round(time.time() - t0, 1)
    _envelope_gate("fractal", rows)
    # (f) the field-boundary world, learned_lg9 exact warp
    t0 = time.time()
    ortho, dem, aff, k, frames = envelope.field_scene(envelope.field_world())
    out["host_s"]["field_world"] = round(time.time() - t0, 1)
    reset_launches()
    rows = _envelope_fly(make_deep_runner(*load_bundled("learned_lg9"),
                                          device=ENVELOPE_DEVICE),
                         ortho, dem, aff, k, frames, "field", map_stamp=1,
                         altitude_agl=500.0)
    out["field"] = {"rows": rows, "launches": dict(LAUNCHES)}
    out["host_s"]["field"] = round(time.time() - t0, 1)
    _envelope_gate("field", rows)
    if "cv2" in sys.modules:
        raise RuntimeError("path 22 imported cv2")
    out["launches"] = {k: sum(out[tag]["launches"].get(k, 0) for tag in (
        "bucketed", "warp", "cached_prior30", "appearance", "fractal",
        "field")) for k in LAUNCHES}
    out["s"] = round(time.time() - t_path, 1)
    log(f"[envelope] {card}: host s {out['host_s']}, sweeps "
        f"{ {t: out[t]['s'] for t in ('bucketed', 'warp', 'cached_prior30')} }"
        f", {out['s']} s in all; launches {out['launches']}")
    log("[envelope] " + json.dumps(out, default=str))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only, no timing")
    ap.add_argument("--kernels", action="store_true",
                    help="build, check and time the kernels, drive no path "
                         "(to compare two sources of a kernel in one call)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile paths 2-8 (torch.profiler; paths 1 "
                         "and 12 always are)")
    ap.add_argument("--seed-spread", action="store_true",
                    help="only print how the cached runner's fixes move "
                         "over RANSAC seeds")
    ap.add_argument("--digest", action="store_true",
                    help="only print the sha256 of the stem's, NMS "
                         "kernels' and shear's outputs on seeded inputs")
    ap.add_argument("--graph", action="store_true",
                    help="only drive path 8, the node graph")
    ap.add_argument("--train", action="store_true",
                    help="only check the gradients and drive path 9, "
                         "training")
    ap.add_argument("--deploy", action="store_true",
                    help="only drive paths 10 (the deployed constellation) "
                         "and 11 (replay)")
    ap.add_argument("--multistream", action="store_true",
                    help="only drive path 12 (multistream, one graph a "
                         "tick)")
    ap.add_argument("--jpeg", action="store_true",
                    help="only run the JPEG codec phase")
    ap.add_argument("--mesh", action="store_true",
                    help="only drive paths 12 and 13 (the mesh over every "
                         "card there is)")
    ap.add_argument("--api", action="store_true",
                    help="only drive path 14 (the library API)")
    ap.add_argument("--demo", action="store_true",
                    help="only drive path 15 (the demo maps, gis-serve and "
                         "run's graph at full width over them)")
    ap.add_argument("--webp", action="store_true",
                    help="only drive path 16 (WebP: fixtures, the main "
                         "path's model replayed over a WebP flight, the GIS "
                         "node's WebP fetch, decode times)")
    ap.add_argument("--jp2", action="store_true",
                    help="only drive path 17 (JPEG 2000: fixtures, the main "
                         "path's model replayed over a JPEG 2000 flight "
                         "with a 16-bit DEM, the GIS node's JPEG 2000 "
                         "fetch, decode times)")
    ap.add_argument("--jpegx", action="store_true",
                    help="only drive path 18 (lossless and arithmetic-coded "
                         "JPEG: fixtures, the main path's model replayed "
                         "over an arithmetic-coded flight, the GIS node's "
                         "image/jpeg fetch, decode times)")
    ap.add_argument("--tiffx", action="store_true",
                    help="only drive path 19 (TIFF variants: fixtures, "
                         "run's graph over a WMS whose DEM is a ZSTD "
                         "GeoTIFF, CCITT decode times)")
    ap.add_argument("--bench", action="store_true",
                    help="only drive path 20 (python -m gisnav_tpu_torch "
                         "bench, the JAX package's headline rows)")
    ap.add_argument("--damaged", action="store_true",
                    help="only drive path 21 (damaged images: the seeded "
                         "damage of every fixture against cv2's digests, "
                         "run's graph behind a WMS that damages its "
                         "replies)")
    ap.add_argument("--envelope", action="store_true",
                    help="only drive path 22 (the JAX repository's accuracy "
                         "battery: the headline bucket-edge sweep, exact "
                         "warp, appearance, fractal and field worlds)")
    args = ap.parse_args(argv)

    t_start = time.time()
    device = phase_device()
    from gisnav_tpu_torch.device import strict_fp32

    strict_fp32()
    phase_build()
    if args.seed_spread:
        phase_seed_spread()
        return 0
    if args.digest:
        phase_digest()
        return 0
    if args.graph:
        phase_graph_path(args.profile)
        return 0
    if args.jpeg:
        phase_jpeg()
        log(f"[phase] jpeg done at {time.time() - t_start:.1f} s")
        return 0
    if args.multistream or args.mesh:
        path12 = phase_multistream_path()
        log(f"[phase] path 12 done at {time.time() - t_start:.1f} s")
        if args.mesh:
            phase_mesh_path(path12)
            log(f"[phase] path 13 done at {time.time() - t_start:.1f} s")
        return 0
    if args.api:
        phase_api_path()
        log(f"[phase] path 14 done at {time.time() - t_start:.1f} s")
        return 0
    if args.demo:
        phase_demo_path()
        log(f"[phase] path 15 done at {time.time() - t_start:.1f} s")
        return 0
    if args.webp:
        phase_webp_path()
        log(f"[phase] path 16 done at {time.time() - t_start:.1f} s")
        return 0
    if args.jp2:
        phase_jp2_path()
        log(f"[phase] path 17 done at {time.time() - t_start:.1f} s")
        return 0
    if args.jpegx:
        phase_jpegx_path()
        log(f"[phase] path 18 done at {time.time() - t_start:.1f} s")
        return 0
    if args.tiffx:
        phase_tiffx_path()
        log(f"[phase] path 19 done at {time.time() - t_start:.1f} s")
        return 0
    if args.bench:
        phase_bench_path()
        log(f"[phase] path 20 done at {time.time() - t_start:.1f} s")
        return 0
    if args.damaged:
        phase_damaged_path()
        log(f"[phase] path 21 done at {time.time() - t_start:.1f} s")
        return 0
    if args.envelope:
        phase_envelope_path()
        log(f"[phase] path 22 done at {time.time() - t_start:.1f} s")
        return 0
    if args.deploy:
        phase_deploy_path()
        log(f"[phase] path 10 done at {time.time() - t_start:.1f} s")
        phase_replay_path()
        log(f"[phase] path 11 done at {time.time() - t_start:.1f} s")
        return 0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if args.train:
        check_gradients(gen, False, [])
        log(f"[phase] gradients done at {time.time() - t_start:.1f} s")
        phase_train_path()
        log(f"[phase] path 9 done at {time.time() - t_start:.1f} s")
        return 0
    results: list = []
    check_conv(gen, args.quick, results)
    check_nms(gen, args.quick, results)
    check_block(gen, args.quick, results)
    check_attention(gen, args.quick, results)
    check_shear(gen, args.quick, results, ab=args.kernels)
    check_cellmax(gen, args.quick, results)
    check_gradients(gen, args.quick, results)
    torch.cuda.synchronize()
    log(json.dumps({"kernels_checked": [r["name"] for r in results]}))
    if args.quick:
        return 0
    if args.kernels:
        log(json.dumps({"kernel_times": [
            {k: r[k] for k in ("name", "ms", "plain_ms", "library_ms",
                               "bound_ms", "max_abs_err", *EXTRA_KEYS)
             if k in r}
            for r in results]}))
        return 0
    log(f"[phase] kernels done at {time.time() - t_start:.1f} s")
    phase_jpeg()
    log(f"[phase] jpeg done at {time.time() - t_start:.1f} s")
    main_path = phase_main_path()
    params, config = main_path["params"], main_path["config"]
    log(f"[phase] path 1 done at {time.time() - t_start:.1f} s")
    cached = phase_cached_path(params, config, args.profile)
    log(f"[phase] path 2 done at {time.time() - t_start:.1f} s")
    exact = phase_exact_warp_path(params, config, main_path["scene"],
                                  args.profile)
    log(f"[phase] path 3 done at {time.time() - t_start:.1f} s")
    harris = phase_harris_path(args.profile)
    log(f"[phase] path 4 done at {time.time() - t_start:.1f} s")
    phase_semidense_path(args.profile)
    log(f"[phase] path 5 done at {time.time() - t_start:.1f} s")
    classical = phase_classical_path(args.profile)
    log(f"[phase] path 6 done at {time.time() - t_start:.1f} s")
    phase_vo_path(args.profile)
    log(f"[phase] path 7 done at {time.time() - t_start:.1f} s")
    graph = phase_graph_path(args.profile)
    log(f"[phase] path 8 done at {time.time() - t_start:.1f} s")
    training = phase_train_path()
    log(f"[phase] path 9 done at {time.time() - t_start:.1f} s")
    phase_deploy_path(graph["flight"]["frame_to_fix"])
    log(f"[phase] path 10 done at {time.time() - t_start:.1f} s")
    replays = phase_replay_path()
    log(f"[phase] path 11 done at {time.time() - t_start:.1f} s")
    path12 = phase_multistream_path()
    log(f"[phase] path 12 done at {time.time() - t_start:.1f} s")
    mesh = phase_mesh_path(path12, training["cli"]["steps_per_s"])
    del path12
    torch.cuda.empty_cache()  # the paths' graph pools
    log(f"[phase] path 13 done at {time.time() - t_start:.1f} s")
    api = phase_api_path(main_path["scene"], main_path["frame_p50_ms"])
    log(f"[phase] path 14 done at {time.time() - t_start:.1f} s")
    demo = phase_demo_path()
    log(f"[phase] path 15 done at {time.time() - t_start:.1f} s")
    webp = phase_webp_path()
    log(f"[phase] path 16 done at {time.time() - t_start:.1f} s")
    jp2 = phase_jp2_path()
    log(f"[phase] path 17 done at {time.time() - t_start:.1f} s")
    jpegx = phase_jpegx_path()
    log(f"[phase] path 18 done at {time.time() - t_start:.1f} s")
    tiffx = phase_tiffx_path()
    log(f"[phase] path 19 done at {time.time() - t_start:.1f} s")
    benched = phase_bench_path(main_path["frame_p50_ms"])
    log(f"[phase] path 20 done at {time.time() - t_start:.1f} s")
    damaged = phase_damaged_path()
    log(f"[phase] path 21 done at {time.time() - t_start:.1f} s")
    envelope = phase_envelope_path()
    log(f"[phase] path 22 done at {time.time() - t_start:.1f} s")
    # each kernel's count comes from the path that runs it
    counts = dict(main_path["launches"])
    counts["masked_attention"] = cached["module"]["launches"][
        "masked_attention"]
    for name in ("shear_last_axis", "shear_first_axis"):
        counts[name] = exact["zoomless"]["launches"][name]
    counts["nms_cellmax"] = phase_cellmax_stage()
    for r in results:
        r["launches"] = counts[r["name"]]
        if not r["launches"] > 0:
            raise RuntimeError(f"{r['name']} was launched on no path")
        if r["name"] in api["launches"]:
            r["path14_launches"] = api["launches"][r["name"]]
        if r["name"] in PATH1_KERNELS:
            r["path15_launches"] = demo["flight"]["launches"][r["name"]]
            r["path16_launches"] = webp["replay"]["webp"]["launches"][
                r["name"]]
            r["path17_launches"] = jp2["replay"]["jp2"]["launches"][
                r["name"]]
            r["path18_launches"] = jpegx["replay"]["launches"][r["name"]]
            r["path19_launches"] = tiffx["flight"]["launches"][r["name"]]
            r["path20_launches"] = benched["launches"][r["name"]]
            r["path21_launches"] = damaged["flight"]["launches"][r["name"]]
            r["path22_launches"] = envelope["launches"][r["name"]]
            r["path4_launches"] = sum(harris[m]["launches"][r["name"]]
                                      for m in ("cached", "bucketed",
                                                "exact"))
            r["path8_launches"] = graph["flight"]["launches"][r["name"]]
            r["path11_launches"] = replays["harris"]["launches"][r["name"]]
            r["path13_launches"] = mesh["feeds"]["model2"]["launches"][
                r["name"]]
        if r["name"] in ("shear_last_axis", "shear_first_axis"):
            r["path6_launches"] = classical["launches"][r["name"]]
            r["path11_launches"] = replays["classical"]["launches"][
                r["name"]]
        if r["name"] == "masked_attention":
            r["path9_launches"] = (
                training["cli"]["launches"][r["name"]]
                + training["finetune"]["launches"][r["name"]])
            r["step_backward_device_ms"] = training["cli"][
                "k5_backward_device_ms"]
            r["path13_launches"] = mesh["train"]["launches_10_steps"][
                r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"[phase] all done: {time.time() - t_start:.1f} s in total")
    print(card_label(), flush=True)
    print(json.dumps({"kernels": [
        {**{k: r.get(k) for k in keys},
         **{k: r[k] for k in EXTRA_KEYS if k in r}}
        for r in results]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
