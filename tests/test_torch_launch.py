"""parallel/launch.run leaves no process behind, on the CPU.

The ``spawn`` method starts a resource tracker beside the ranks. On a Python
whose tracker has no finalizer, it lives until the caller exits, and then
nothing reaps it. So ``run`` stops and reaps it itself. Each case runs in a
fresh interpreter, so no other test's tracker or ranks are in the way.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import gc, json, os, sys
    sys.path.insert(0, {root!r})
    from multiprocessing import resource_tracker
    from ministark_tpu_torch.parallel import launch

    def ok(mesh):
        return mesh.rank

    def bad(mesh):
        raise ValueError("rank " + str(mesh.rank))

    def children():
        me, out = str(os.getpid()), []
        for pid in filter(str.isdigit, os.listdir("/proc")):
            try:
                with open(f"/proc/{{pid}}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            if stat.rsplit(")", 1)[1].split()[1] == me:
                out.append(int(pid))
        return out

    if __name__ == "__main__":
        try:
            got = launch.run({fn}, 2, "gloo", "cpu", 60)
        except RuntimeError as e:
            got = str(e).splitlines()[0]
        after = children()
        gc.collect()
        print(json.dumps({{"got": got, "children": after,
                          "children_after_gc": children(),
                          "tracker": resource_tracker._resource_tracker._pid}}))
""")


@pytest.mark.parametrize("fn", ["ok", "bad"])
def test_run_leaves_no_process(tmp_path, fn):
    script = tmp_path / "run.py"
    script.write_text(SCRIPT.format(root=ROOT, fn=fn))
    res = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    if fn == "bad":        # either rank may be the first to report
        assert out["got"].startswith("rank ") and out["got"].endswith(" of 2 failed:")
    else:
        assert out["got"] == [0, 1]
    assert out["children"] == [] and out["children_after_gc"] == []
    assert out["tracker"] is None
