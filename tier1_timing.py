"""Time the tier-1 test run file by file, and the files that set its end
alone.

    python3 tier1_timing.py full OUT
    python3 tier1_timing.py solo OUT tests/test_pallas.py tests/test_soft_pallas.py
    python3 tier1_timing.py report OUT

``full`` runs ROADMAP.md's tier-1 command (6 xdist workers, ``--dist
loadfile``) with ``-v --durations=0`` in place of ``-q`` and a limit of
``LIMIT`` s in place of 1,470 s; ``solo`` runs each named file alone in its
own pytest process, all of them side by side, at the same limit.  Both stamp
every output line with the time (OUT/log_*.txt), keep the junit XML
(OUT/junit_*.xml) and sample every 30 s the CPU share of each of this user's
python processes over the interval, with its nice value (OUT/load.txt).
``report`` prints each file's worker, the seconds from the start at which it
began (when the file before it on its worker ended), its first and last
reported item and its seconds (the junit ``time`` of its cases, summed);
for each file of more than 300 s, the CPU of the niced processes (the
helpers of the port's tests, tests/torch_jobs.py, and nothing else) and of
the other python processes while it ran; then the samples.

xdist reports a worker's last item of a file only when the scheduler next
acts, so a file's last line can come late; its junit seconds do not.
"""

import collections
import json
import os
import re
import subprocess
import sys
import threading
import time
import xml.etree.ElementTree as ET
from pathlib import Path

LIMIT = 3000  # seconds, for ``full`` and for ``solo``
EVERY = 30  # seconds between samples
PYTEST = ["-m", "pytest", "-v", "--durations=0", "-m", "not slow", "-p", "no:cacheprovider",
          "-p", "no:randomly"]
FULL = ["tests/", "--continue-on-collection-errors", "-p", "xdist", "-n", "6", "--dist", "loadfile"]
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "ALLOW_MULTIPLE_LIBTPU_LOAD": "1"}
ITEM = re.compile(r"([\d.]+) (?:\[(gw\d+)\] \[\s*\d+%\] (?:PASSED|FAILED|ERROR|SKIPPED) (tests/[^:]+)"
                  r"|(tests/[^:]+)::\S+ (?:PASSED|FAILED|ERROR|SKIPPED))")


def _sample(path, stop):
    """Every EVERY s until ``stop`` is set, one JSON line: the time, the
    load, and (nice, CPU %) of each of this user's python processes."""
    hz, uid, prev, t_prev = os.sysconf("SC_CLK_TCK"), os.getuid(), {}, time.time()
    with open(path, "w") as out:
        while not stop.wait(EVERY):
            now, cur, procs = time.time(), {}, []
            for pid in filter(str.isdigit, os.listdir("/proc")):
                try:
                    if os.stat(f"/proc/{pid}").st_uid != uid:
                        continue
                    stat = Path(f"/proc/{pid}/stat").read_text()
                    cmd = Path(f"/proc/{pid}/cmdline").read_bytes()
                except OSError:
                    continue
                f = stat[stat.rindex(")") + 2:].split()
                cur[pid] = int(f[11]) + int(f[12])
                if b"python" in cmd:
                    cpu = 100 * (cur[pid] - prev.get(pid, 0)) / hz / (now - t_prev)
                    procs.append((int(f[16]), round(cpu, 1)))
            out.write(json.dumps({"t": now, "load": os.getloadavg()[0], "procs": procs}) + "\n")
            out.flush()
            prev, t_prev = cur, now


def _run(cmds, out):
    """Run each of ``cmds`` (name, argv) side by side, stamping its output
    lines into out/log_<name>.txt, and sample meanwhile."""
    out.mkdir(parents=True, exist_ok=True)
    # raytpu's native library builds at first use; six workers collecting at
    # once in a fresh checkout can load a half-written one
    subprocess.run([sys.executable, "-c", "from raytpu.native import runtime; runtime.available()"],
                   check=True, env=ENV)
    stop = threading.Event()
    sampler = threading.Thread(target=_sample, args=(out / "load.txt", stop))
    (out / "start.txt").write_text(repr(time.time()))
    sampler.start()

    def stamp(name, argv):
        with open(out / f"log_{name}.txt", "w") as log:
            proc = subprocess.Popen(["timeout", "-k", "10", str(LIMIT), sys.executable, *argv],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                    env=ENV)
            for line in proc.stdout:
                log.write(f"{time.time():.1f} {line}")
                log.flush()
            log.write(f"{time.time():.1f} RC={proc.wait()}\n")

    threads = [threading.Thread(target=stamp, args=c) for c in cmds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    sampler.join()


def report(out):
    out = Path(out)
    start = float((out / "start.txt").read_text())
    files, secs = {}, collections.Counter()
    for log in sorted(out.glob("log_*.txt")):
        for line in log.read_text(errors="replace").splitlines():
            m = ITEM.match(line)
            if m:
                t, path = float(m[1]) - start, m[3] or m[4]
                d = files.setdefault(path, {"worker": m[2] or log.stem[4:], "first": t, "n": 0})
                d["last"], d["n"] = t, d["n"] + 1
            elif " RC=" in line or re.search(r"\d+ passed", line):
                print(log.stem, line[line.index(" ") + 1:])
    for xml in out.glob("junit_*.xml"):
        for case in ET.parse(xml).getroot().iter("testcase"):
            secs[case.get("classname", "").replace(".", "/") + ".py"] += float(case.get("time", 0))
    samples = [json.loads(s) for s in (out / "load.txt").read_text().splitlines()]

    def cpu(s, niced):
        return sum(c for n, c in s["procs"] if (n > 0) == niced)

    print(f"{'file':38s} {'worker':16s} {'began':>7s} {'first':>7s} {'last':>7s} {'seconds':>8s}"
          " items  CPU % while it ran: niced, other python")
    began, worker = 0.0, None
    for path, d in sorted(files.items(), key=lambda kv: (kv[1]["worker"], kv[1]["first"])):
        began = began if d["worker"] == worker else 0.0
        worker = d["worker"]
        line = (f"{path:38s} {worker:16s} {began:7.1f} {d['first']:7.1f} {d['last']:7.1f} "
                f"{secs[path]:8.1f} {d['n']:5d}")
        during = [s for s in samples if began <= s["t"] - start <= d["last"]]
        if secs[path] > 300 and during:
            line += "  " + ", ".join(f"{sum(cpu(s, n) for s in during) / len(during):.0f}"
                                     for n in (True, False))
        print(line)
        began = d["last"]
    print("samples (s, load, CPU %: niced, other python):")
    for s in samples:
        print(f"  {s['t'] - start:7.0f} {s['load']:6.2f} {cpu(s, True):6.0f} {cpu(s, False):6.0f}")


def main(argv):
    cmd, out, *paths = argv
    if cmd == "full":
        _run([("full", PYTEST + FULL + [f"--junitxml={Path(out).resolve()}/junit_full.xml"])],
             Path(out))
    elif cmd == "solo":
        _run([(Path(f).stem, PYTEST + [f, "-p", "no:xdist",
                                       f"--junitxml={Path(out).resolve()}/junit_{Path(f).stem}.xml"])
              for f in paths], Path(out))
    report(out)


if __name__ == "__main__":
    main(sys.argv[1:])
