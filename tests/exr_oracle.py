"""OpenCV's OpenEXR codec as the oracle of gd3d_torch/data/exr.py.

The system's Python 3.11 (Debian's) has OpenCV 4.6, built against OpenEXR
3.1, which reads and writes EXR when OPENCV_IO_ENABLE_OPENEXR=1; the
project's own environment has a cv2 with no EXR writer, and the card's
machine has no cv2. This file is both sides:

  * run by that interpreter, it imports cv2 and numpy only (numpy 1.24, no
    torch, nothing of this repo) and works through a JSON job file:

        OPENCV_IO_ENABLE_OPENEXR=1 python3.11 tests/exr_oracle.py JOBS.json

    each job is {"op": "read", "path": P, "out": NPY}, which saves
    cv2.imread(P, IMREAD_ANYDEPTH) as a float32 .npy, or writes no file
    where cv2 returns None (the index of the job under way is kept in
    JOBS.json.at, so that a job that kills the process is known); or
    {"op": "write", "npy": NPY, "path": P, "compression": "PIZ",
    "type": "HALF"}, which calls cv2.imwrite with
    IMWRITE_EXR_COMPRESSION_<compression> and IMWRITE_EXR_TYPE_<type>;
  * imported by the tests, `find()` finds the interpreter (the
    EXR_ORACLE_PYTHON variable, else python3.11 on the PATH), probes once that
    its cv2 writes and reads a 2x2 EXR, and returns an `Oracle` whose
    `read(paths)` and `write(jobs)` run one subprocess per batch (and one
    more past each file that kills it: `read` gives CRASH for that file);
    `find()` gives (None, the reason to skip) where the interpreter or its
    codec is absent.
"""
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile

PYTHON = os.environ.get("EXR_ORACLE_PYTHON") or shutil.which("python3.11") or "python3.11"
CRASH = "crash"


def _serve(jobs_file, start):
    import cv2
    import numpy as np

    for i, job in enumerate(json.load(open(jobs_file))[start:], start):
        with open(jobs_file + ".at", "w") as f:
            f.write(str(i))
        if job["op"] == "read":
            a = cv2.imread(job["path"], cv2.IMREAD_ANYDEPTH)
            if a is not None:
                np.save(job["out"], np.asarray(a, np.float32))
        else:
            params = [cv2.IMWRITE_EXR_COMPRESSION,
                      getattr(cv2, "IMWRITE_EXR_COMPRESSION_" + job["compression"]),
                      cv2.IMWRITE_EXR_TYPE, getattr(cv2, "IMWRITE_EXR_TYPE_" + job["type"])]
            if not cv2.imwrite(job["path"], np.load(job["npy"]), params):
                raise SystemExit(f"cv2.imwrite refused {job['path']}")


class Oracle:
    def __init__(self, python=PYTHON):
        self.python = python

    def run(self, jobs):
        """Runs the jobs; returns the indices of those that killed the
        process (a read of a file OpenCV crashes on)."""
        env = dict(os.environ, OPENCV_IO_ENABLE_OPENEXR="1")
        for k in ("PYTHONPATH", "PYTHONHOME", "VIRTUAL_ENV"):
            env.pop(k, None)
        crashed, start = [], 0
        with tempfile.TemporaryDirectory() as tmp:
            name = os.path.join(tmp, "jobs.json")
            with open(name, "w") as f:
                json.dump(jobs, f)
            while start < len(jobs):
                r = subprocess.run([self.python, os.path.abspath(__file__), name, str(start)],
                                   env=env, capture_output=True, timeout=300)
                if r.returncode == 0:
                    break
                at = int(open(name + ".at").read())
                if r.returncode > 0 or jobs[at]["op"] != "read":
                    raise RuntimeError(f"the EXR oracle failed on job {jobs[at]}: "
                                       f"{r.stderr.decode()[-2000:]}")
                crashed.append(at)
                start = at + 1
        return crashed

    def read(self, paths):
        """cv2.imread(p, IMREAD_ANYDEPTH) of each path: a float32 array,
        None where OpenCV returns None, or CRASH where it kills the process."""
        import numpy as np

        with tempfile.TemporaryDirectory() as tmp:
            outs = [os.path.join(tmp, f"{i}.npy") for i in range(len(paths))]
            crashed = self.run([{"op": "read", "path": str(p), "out": o}
                                for p, o in zip(paths, outs)])
            return [CRASH if i in crashed else np.load(o) if os.path.exists(o) else None
                    for i, o in enumerate(outs)]

    def write(self, jobs):
        """cv2.imwrite of each (array, path, compression, type)."""
        import numpy as np

        with tempfile.TemporaryDirectory() as tmp:
            todo = []
            for i, (a, path, comp, typ) in enumerate(jobs):
                npy = os.path.join(tmp, f"{i}.npy")
                np.save(npy, a)
                todo.append({"op": "write", "npy": npy, "path": str(path),
                             "compression": comp, "type": typ})
            self.run(todo)


@functools.lru_cache(maxsize=None)
def find():
    """(the Oracle, "") or (None, why) where the system interpreter or its
    OpenCV's EXR codec is absent. Probed once per process."""
    import numpy as np

    if not shutil.which(PYTHON):
        return None, f"no {PYTHON} (the interpreter of the OpenCV 4.6 EXR oracle)"
    o = Oracle()
    with tempfile.TemporaryDirectory() as tmp:
        a = np.array([[1.5, -2.0], [0.25, 3.0]], np.float32)
        path = os.path.join(tmp, "probe.exr")
        try:
            o.write([(a, path, "ZIP", "FLOAT")])
            back = o.read([path])[0]
        except (subprocess.SubprocessError, OSError, RuntimeError) as e:
            return None, f"{PYTHON}'s cv2 cannot write EXR: {e}"
    if isinstance(back, np.ndarray) and np.array_equal(back, a):
        return o, ""
    return None, f"{PYTHON}'s cv2 does not read back its own EXR"


if __name__ == "__main__":
    _serve(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 0)
