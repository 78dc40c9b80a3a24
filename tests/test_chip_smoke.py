"""chip_smoke.py refuses to run anywhere but on a GPU, in a checkout."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

SCRIPT = pathlib.Path(__file__).resolve().parents[1] / 'chip_smoke.py'


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env.pop('PYTHONPATH', None)
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    return r.returncode, json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('where', ['checkout', 'alone'])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    script = SCRIPT
    if where == 'alone':           # no package next to the script
        script = tmp_path / 'chip_smoke.py'
        shutil.copy(SCRIPT, script)
    rc, last = _run(tmp_path, script)
    assert rc != 0
    assert last['ok'] is False
