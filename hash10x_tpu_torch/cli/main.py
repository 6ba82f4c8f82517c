"""hash10x-compatible sequential command-language CLI for the torch port.

Each flag is a command executed immediately, in order, against shared state
(``hash10x.c:~main``, SURVEY.md §3.1 #1); parameters must precede the
commands that use them.  Output matches ``python -m hash10x_tpu`` byte for
byte on the flags below, except the number after ``table slots``, which
follows each package's own table growth.

Usage: python -m hash10x_tpu_torch [commands...]

Parameters (take effect for later commands):
  --device <cuda|cpu>  device to run on (default cuda; there is no fallback:
                       without a CUDA device, pass --device cpu).  With
                       --hosts, process i runs on cuda:(i mod device count)
  -k <int>             k-mer size (default 21)
  -w <int>             minimizer window / modimizer modulus (default 11)
  -r <int>             hash seed (default 17)
  -B | --tableBits <b> count table starts with 2^b slots (default 22)
  --hosts <n>          multi-process run over n processes (each loads its
                       rows of every batch; the shards spread over the
                       processes, joined by torch.distributed over gloo);
                       pair with --hostId and --coordinator (or the
                       H10X_NUM_PROCESSES, H10X_PROCESS_ID and
                       H10X_COORDINATOR variables); stdout and output files
                       are written by process 0 only
  --hostId <i>         this process's id in [0, hosts)
  --coordinator <a:p>  address of process 0 (host:port, a free port)
  --minimizer | --modimizer | --allKmers | --syncmer <s>   sketch mode
  --minCount <n> --maxCount <n>   count band for good k-mers
  --minShare <n>       pair-mode support threshold (default 2)
  --friendShare <n>    friend-mode barcode share threshold
  --clusterMode <pair|friend>   clustering contract (default friend)
  --maxFriends <n>     friend mode: keep each barcode's top n friends
                       (default 0 = uncapped, the sparse pipeline)
  --countMode <barcodes|occurrences>
  --batchReads <n>
  --shards <n>         shard count, incidence and friend clustering over n
                       shards (a power of two; with --hosts the default is
                       the process count); one process holds n / hosts
                       shards on its device
  --laneCapacity <n>   sharded paths: send-lane slots per destination shard
                       (0 = auto-size to expected load; a pass that
                       overflows its lanes runs again with doubled lanes)
  --labelBlocks <n>    sharded clustering: propagate labels in
                       barcode-aligned blocks of ~n pairs (full-lane scale)
  --errorFixReads <m>  rescue threshold for --errorFix (0 = drop-only)
  --metrics <file>     append per-command JSONL metrics (set before the
                       first command that creates the engine); each record
                       adds "spans" ({name: {host_s, device_s, n}} of the
                       spans inside the command; device_s on CUDA, for the
                       flush and clustering spans) and "counters" (steps,
                       flushes, graph captures, sorted keys, lane bytes)
  --devMem             add the device memory torch holds to the
                       per-command lines (CUDA only)
  --profile <dir>      torch.profiler trace (CPU + CUDA) of all later
                       commands, written for TensorBoard into <dir>
  -t <n>               thread count (accepted for compatibility; ignored)

Commands (executed in order):
  --readFastq <fq>     parse FASTQ (16bp GEM barcode prefix) and run the count pass
  --readFastqPair <r1> <r2>   paired lane: R1 = barcode+genomic, R2 = genomic
  --readFQB <fqb>      load packed reads and run the count pass
  --readFQBShard <fqb> multi-process: each process loads only its own
                       barcode-disjoint shard file ("{host}" -> process id)
  --simulate <spec>    generate a simulated lane (key=val,...)
  --writeFQB <out>     write the last-read lane as packed fqb
  --hashInfo           table summary to stdout
  --hashDist           count histogram to stdout
  --errorFix <max>     drop error-band k-mers with count <= max; with
                       --errorFixReads and loaded reads (barcodes mode),
                       error-band k-mers occurring in >= that many reads are
                       rescued
  --writeHash <out>    save the analysis state (the JAX package's .npz)
  --readHash <in>      load a saved state, replacing the current one
  --writeCounts <f>    dump (hash, count) table as text
  --writeClusters <f>  dump (code, kmer hash, cluster) assignments as text
  --cluster | --codeClusters   count-band filter + incidence + per-barcode
                       clusters (after --readHash with no reads: cluster the
                       loaded incidence)
  --clusterSplit       remap (code, cluster) -> new molecule codes
  --clusterReport      per-code cluster report to stdout
  --cribBuild <fa> [<fa2>]   build truth labels from one or two haplotype
                       FASTAs (the second path is taken iff it is a file)
  --cribReport         cluster purity vs the crib to stdout
  --help

Every command is followed by a timing/RSS line on stderr.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

__all__ = ["main", "run"]


def _bootstrap_multihost(argv: List[str]):
    """Take --hosts/--hostId/--coordinator out of ``argv`` (defaults: the
    H10X_* variables) and join the process group for more than one process.
    Returns (the other arguments, number of processes, this process's id)."""
    hosts = int(os.environ.get("H10X_NUM_PROCESSES", "1"))
    host_id = int(os.environ.get("H10X_PROCESS_ID", "0"))
    coord = os.environ.get("H10X_COORDINATOR")
    rest = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("--hosts", "--hostId", "--coordinator"):
            if i + 1 >= len(argv):
                raise SystemExit(f"{a} requires an argument")
            v = argv[i + 1]
            if a == "--hosts":
                hosts = int(v)
            elif a == "--hostId":
                host_id = int(v)
            else:
                coord = v
            i += 2
            continue
        rest.append(a)
        i += 1
    if hosts > 1:
        import torch
        from ..dist import multihost
        multihost.initialize(coord, hosts, host_id)
        # processes sharing a host share its cores: without a share each,
        # their thread pools and gloo's polling oversubscribe the host
        # (a two-process CPU run measured ~30x slower)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // hosts))
        return rest, hosts, host_id
    return rest, 1, 0


class _State:
    def __init__(self, err):
        self.err = err
        self.device = "cuda"
        self.k = 21
        self.w = 11
        self.seed = 17
        self.table_bits = 22
        self.mode = "minimizer"
        self.syncmer_s = 0
        self.count_mode = "barcodes"
        self.min_count = 2
        self.max_count = 64
        self.cluster_mode = "friend"
        self.min_share = 2
        self.min_friend_share = 8
        self.max_friends = 0
        self.batch_reads = 4096
        self.n_shards = 1
        self.lane_capacity = 0
        self.label_blocks = 0
        self.error_fix_min_reads = 0
        self.hosts = 1
        self.host_id = 0
        self.is_coord = True
        self.metrics_path = None
        self.device_mem = False
        self.engine = None
        self.fqb = None
        self.fqb_is_local = False
        self.crib = None
        self.profiler = None
        self.profile_dir = None

    def get_engine(self):
        from ..engine import Engine, EngineConfig
        from ..hashspec import HashSpec
        if self.engine is None:
            import torch
            dev = torch.device(self.device)
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise SystemExit(
                    "--device cuda: no CUDA device is available; pass "
                    "--device cpu to run the plain torch path on the CPU")
            if dev.type == "cuda" and self.hosts > 1 and dev.index is None:
                dev = torch.device("cuda", self.host_id
                                   % torch.cuda.device_count())
            cfg = EngineConfig(
                spec=HashSpec(k=self.k, w=self.w, seed=self.seed),
                mode=self.mode, syncmer_s=self.syncmer_s,
                table_bits=self.table_bits, batch_reads=self.batch_reads,
                count_mode=self.count_mode, min_count=self.min_count,
                max_count=self.max_count, cluster_mode=self.cluster_mode,
                min_share=self.min_share,
                min_friend_share=self.min_friend_share,
                max_friends=self.max_friends, n_shards=self.n_shards,
                lane_capacity=self.lane_capacity,
                cluster_label_blocks=self.label_blocks,
                error_fix_min_reads=self.error_fix_min_reads)
            self.engine = Engine(cfg, dev, log=self.err)
            if self.metrics_path or self.device_mem:
                from ..utils.timing import StageTimer
                self.engine.timer = StageTimer(
                    self.err, self.metrics_path, device_mem=self.device_mem,
                    device=dev)
        else:
            # tunables may change between commands; hash, table and device
            # parameters are guarded instead
            cfg = self.engine.cfg
            cfg.min_count = self.min_count
            cfg.max_count = self.max_count
            cfg.cluster_mode = self.cluster_mode
            cfg.min_share = self.min_share
            cfg.min_friend_share = self.min_friend_share
            cfg.max_friends = self.max_friends
            cfg.batch_reads = self.batch_reads
            cfg.cluster_label_blocks = self.label_blocks
            cfg.error_fix_min_reads = self.error_fix_min_reads
        return self.engine

    def param_change_guard(self):
        if self.engine is not None and self.engine.n_reads_counted > 0:
            raise SystemExit("hash parameters must be set before reading data "
                             "(tables are only comparable with identical k/w/seed)")
        self.engine = None


def _parse_sim(spec: str):
    from ..io.sim import SimConfig
    kwargs = {}
    if spec:
        for kv in spec.split(","):
            key, val = kv.split("=")
            kwargs[key] = float(val) if "." in val else int(val)
    return SimConfig(**kwargs)


def _start_profiler(directory: str):
    """Start a torch.profiler over the CPU and, where present, CUDA that
    writes a TensorBoard trace into ``directory`` when stopped."""
    import torch
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(directory))
    prof.start()
    return prof


def main(argv: Optional[List[str]] = None, out=None, err=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    out = out or sys.stdout
    if not argv or "--help" in argv or "-h" in argv:
        out.write(__doc__)
        return 0
    run(argv, out, err or sys.stderr)
    return 0


def run(argv: List[str], out, err):
    """Execute the commands of ``argv`` in order; returns the engine they
    ran on (None if no command needed one).  With --hosts > 1 the process
    joins the process group first and leaves it at the end; processes other
    than 0 write nothing to ``out`` and no file.  A profiler started by
    ``--profile`` is stopped, and the metrics file closed, however the
    commands end."""
    argv, hosts, host_id = _bootstrap_multihost(list(argv))
    st = _State(err)
    st.hosts, st.host_id = hosts, host_id
    st.is_coord = host_id == 0
    if hosts > 1:
        st.n_shards = hosts
    sink = None
    if not st.is_coord:
        # every process enters every collective; only process 0 reports
        out = sink = open(os.devnull, "w")
    try:
        _execute(argv, out, st)
    finally:
        if st.profiler is not None:
            st.profiler.stop()
        if st.engine is not None:
            st.engine.timer.close()
        if sink is not None:
            sink.close()
        if hosts > 1:
            from ..dist import multihost
            multihost.shutdown()
    if st.profiler is not None:
        err.write(f"[profile] trace written to {st.profile_dir}\n")
    return st.engine


def _execute(argv: List[str], out, st: _State) -> None:
    from ..io import fqb as FB
    from ..io.sim import simulate

    modes = {"--minimizer": "minimizer", "--modimizer": "modimizer",
             "--allKmers": "kmer"}
    i = 0

    def need(n: int, flag: str) -> List[str]:
        nonlocal i
        if i + n > len(argv) - 1:
            raise SystemExit(f"{flag} requires {n} argument(s)")
        args = argv[i + 1:i + 1 + n]
        i += n
        return args

    while i < len(argv):
        a = argv[i]
        # ---- parameters ----
        if a == "--device":
            st.param_change_guard(); st.device = need(1, a)[0]
        elif a == "-k":
            st.param_change_guard(); st.k = int(need(1, a)[0])
        elif a == "-w":
            st.param_change_guard(); st.w = int(need(1, a)[0])
        elif a == "-r":
            st.param_change_guard(); st.seed = int(need(1, a)[0])
        elif a in ("-B", "--tableBits"):
            st.param_change_guard(); st.table_bits = int(need(1, a)[0])
        elif a in modes:
            st.param_change_guard(); st.mode = modes[a]
        elif a == "--syncmer":
            st.param_change_guard(); st.mode = "syncmer"
            st.syncmer_s = int(need(1, a)[0])
        elif a == "--countMode":
            st.param_change_guard(); st.count_mode = need(1, a)[0]
        elif a == "--minCount":
            st.min_count = int(need(1, a)[0])
        elif a == "--maxCount":
            st.max_count = int(need(1, a)[0])
        elif a == "--clusterMode":
            st.cluster_mode = need(1, a)[0]
        elif a == "--minShare":
            st.min_share = int(need(1, a)[0])
        elif a == "--friendShare":
            st.min_friend_share = int(need(1, a)[0])
        elif a == "--maxFriends":
            st.max_friends = int(need(1, a)[0])
        elif a == "--batchReads":
            st.batch_reads = int(need(1, a)[0])
        elif a == "--shards":
            st.param_change_guard(); st.n_shards = int(need(1, a)[0])
        elif a == "--laneCapacity":
            # a lane capacity grown by an overflow retry stays until this
            # flag sets another
            st.lane_capacity = int(need(1, a)[0])
            if st.engine is not None:
                st.engine.cfg.lane_capacity = st.lane_capacity
        elif a == "--labelBlocks":
            st.label_blocks = int(need(1, a)[0])
        elif a == "--errorFixReads":
            st.error_fix_min_reads = int(need(1, a)[0])
        elif a == "--metrics":
            path = need(1, a)[0]
            if st.is_coord:
                st.metrics_path = path
        elif a == "--devMem":
            st.device_mem = True
        elif a == "--profile":
            # a torch.profiler trace of everything after this flag; a
            # second --profile is accepted and ignored
            directory = need(1, a)[0]
            if st.profiler is None and st.is_coord:
                st.profiler = _start_profiler(directory)
                st.profile_dir = directory
        elif a == "-t":
            need(1, a)  # accepted for compatibility; the device runs batches
        # ---- commands ----
        elif a == "--readFastq":
            st.fqb = FB.fastq_to_fqb(need(1, a)[0])
            st.get_engine().count(st.fqb)
        elif a == "--readFastqPair":
            r1, r2 = need(2, a)
            st.fqb = FB.paired_fastq_to_fqb(r1, r2)
            st.get_engine().count(st.fqb)
        elif a == "--readFQB":
            st.fqb = FB.load_fqb(need(1, a)[0])
            st.fqb_is_local = False
            st.get_engine().count(st.fqb)
        elif a == "--readFQBShard":
            # each process loads only its own barcode-disjoint shard file
            path = need(1, a)[0].replace("{host}", str(st.host_id))
            st.fqb = FB.load_fqb(path)
            st.fqb_is_local = True
            st.get_engine().count(st.fqb, local_shard=True)
        elif a == "--simulate":
            sim = simulate(_parse_sim(need(1, a)[0]))
            st.fqb = FB.from_read_batch(sim.reads)
            st.get_engine().count(st.fqb)
        elif a == "--writeFQB":
            if st.fqb is None:
                raise SystemExit("--writeFQB: no reads loaded")
            path = need(1, a)[0]
            if st.is_coord:
                FB.save_fqb(path, st.fqb)
        elif a == "--writeHash":
            path = need(1, a)[0]
            eng = st.get_engine()
            eng.host_materialize()  # collectives: every process enters
            if st.is_coord:
                eng.save(path)
        elif a == "--readHash":
            st.get_engine().load(need(1, a)[0])
        elif a == "--errorFix":
            st.get_engine().error_fix(int(need(1, a)[0]), fqb=st.fqb)
        elif a == "--hashInfo":
            st.get_engine().info(out)
        elif a == "--hashDist":
            st.get_engine().write_histogram(out)
        elif a in ("--writeCounts", "--writeClusters"):
            path = need(1, a)[0]
            eng = st.get_engine()
            eng.host_materialize()  # collectives: every process enters
            if st.is_coord:
                with open(path, "w") as f:
                    if a == "--writeCounts":
                        eng.write_counts(f)
                    else:
                        eng.write_clusters(f)
        elif a in ("--cluster", "--codeClusters"):
            eng = st.get_engine()
            if st.fqb is not None:
                eng.filter(st.min_count, st.max_count)
                eng.incidence(st.fqb, local_shard=st.fqb_is_local)
            elif eng.inc is None:
                raise SystemExit("--codeClusters: no reads loaded for "
                                 "incidence (and no incidence in a loaded "
                                 "checkpoint)")
            eng.cluster()
        elif a == "--clusterSplit":
            st.get_engine().split()
        elif a == "--clusterReport":
            st.get_engine().report(out)
        elif a == "--cribBuild":
            from ..crib.crib import build_crib
            paths = [need(1, a)[0]]
            # the second haplotype is taken iff the next token is a file
            if i + 1 < len(argv) and os.path.isfile(argv[i + 1]):
                paths.append(need(1, a)[0])
            eng = st.get_engine()
            if eng.retained_hashes is None:
                eng.filter(st.min_count, st.max_count)
            st.crib = build_crib(eng.cfg.spec, eng.retained_hashes, paths)
            eng.timer.stage(f"cribBuild: {len(paths)} haplotype(s)")
        elif a == "--cribReport":
            from ..crib.crib import crib_report
            eng = st.get_engine()
            if st.crib is None or eng.cluster_labels is None:
                raise SystemExit("--cribReport requires --cribBuild and "
                                 "--codeClusters")
            n = crib_report(eng.inc, eng.cluster_labels, st.crib, out)
            eng.timer.stage(f"cribReport: {n} clusters")
        else:
            raise SystemExit(f"unknown argument {a!r} (see --help)")
        i += 1


if __name__ == "__main__":
    sys.exit(main())
