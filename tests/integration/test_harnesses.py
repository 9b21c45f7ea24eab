"""
Smoke tests for the CLI harnesses: the benchmark harness and the example
scripts run end-to-end at tiny sizes.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_script(args, cwd=None, timeout=600):
    env = dict(os.environ)
    env['JAX_PLATFORMS'] = 'cpu'
    # replace (not extend) PYTHONPATH: site customizations in the ambient
    # environment may pin an accelerator platform
    env['PYTHONPATH'] = REPO
    result = subprocess.run(
        [sys.executable] + args, cwd=cwd, env=env, timeout=timeout,
        capture_output=True, text=True)
    assert result.returncode == 0, result.stderr[-3000:]
    return result.stdout


def test_benchmark_harness():
    out = run_script(
        [os.path.join(REPO, 'benchmarks', 'benchmark.py'),
         '-L', '8', '-H', 'MBL', '--evolve', '--mult', '--mult_count', '3',
         '--rdm', '--check-conserves'])
    assert '---RESULTS---' in out
    assert 'do_evolve' in out
    assert 'avg_mult_time' in out
    assert 'Gb_memory' in out


def test_benchmark_subspace():
    out = run_script(
        [os.path.join(REPO, 'benchmarks', 'benchmark.py'),
         '-L', '8', '-H', 'heisenberg', '--subspace', 'spinconserve',
         '--eigsolve'])
    assert 'do_eigsolve' in out


def test_bench_json():
    """bench.py measures on the GPU only: on the CPU each stage reports its
    failure, the headline says nothing completed and the exit is non-zero.
    The stage's measurement itself is checked by calling it directly."""
    import json
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, 'bench.py'), 'full_L8'],
        env=env, timeout=600, capture_output=True, text=True)
    assert proc.returncode != 0
    lines = [l for l in proc.stdout.splitlines() if l.startswith('{')]
    # incremental stage line(s), then exactly one final headline line
    data = json.loads(lines[-1])
    assert set(data) == {'metric', 'value', 'unit', 'vs_baseline', 'error'}
    assert data['value'] == 0.0
    stage = json.loads(lines[0])
    assert stage['stage'] == 'full_L8'
    assert stage['ok'] is False
    assert "no 'cuda' device" in stage['tail'] and 'card' in stage

    out = run_script(['-c', (
        'import json, bench\n'
        'from dynamite_tpu import config\n'
        "config.precision = 'single'\n"
        'config._initialize()\n'
        'print(json.dumps(bench.stage_full(8, 2)))\n')], cwd=REPO)
    result = json.loads(out.strip().splitlines()[-1])
    assert result['ms_per_apply'] > 0 and result['nnz_per_sec'] > 0
    assert result['engine'] == 'sweep' and result['dim'] == 256


def test_tutorial_notebook_executes(tmp_path):
    """The tutorial notebooks run under nbconvert --execute (spot-check one
    light one; the full set is executed when built,
    examples/tutorial/build_notebooks.py)."""
    import shutil
    src = os.path.join(REPO, 'examples', 'tutorial', '2-States.ipynb')
    dst = tmp_path / '2-States.ipynb'
    shutil.copy(src, dst)
    run_script(['-m', 'jupyter', 'nbconvert', '--execute', '--to',
                'notebook', '--inplace', str(dst)],
               cwd=os.path.join(REPO, 'examples', 'tutorial'))


def test_example_mbl():
    out = run_script(
        [os.path.join(REPO, 'examples/scripts/mbl/run_mbl.py'),
         '-L', '6', '--iters', '1', '--h-points', '1', '--nev', '3',
         '--energy-points', '3', '--seed', '7'])
    assert 'h,energy_point,entropy,ratio' in out


def test_example_floquet(tmp_path):
    out = run_script(
        [os.path.join(REPO, 'examples/scripts/floquet/run_floquet.py'),
         '-L', '6', '--n-cycles', '4', '--checkpoint-every', '2',
         '--checkpoint-path', str(tmp_path)])
    assert out.count('\n') >= 5
    # resume from the checkpoint
    out2 = run_script(
        [os.path.join(REPO, 'examples/scripts/floquet/run_floquet.py'),
         '-L', '6', '--n-cycles', '6', '--checkpoint-every', '2',
         '--checkpoint-path', str(tmp_path)])
    assert out2.count('\n') >= 2


def test_example_syk():
    out = run_script(
        [os.path.join(REPO, 'examples/scripts/syk/run_syk.py'),
         '-N', '8', '-b', '0.3', '-t', '0.2', '--seed', '5'])
    assert 'beta,t,C' in out


def test_example_kagome():
    out = run_script(
        ['run_kagome.py', '12'],
        cwd=os.path.join(REPO, 'examples/scripts/kagome'))
    assert 'E0 = ' in out
    # known 12-site kagome Heisenberg ground state energy per site
    checked = False
    for line in out.splitlines():
        if line.startswith('E0 = '):
            e0n = float(line.split('E0/N =')[1].rstrip(')'))
            assert abs(e0n - (-0.45374)) < 1e-4
            checked = True
    assert checked
