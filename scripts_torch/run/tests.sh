#!/usr/bin/env bash
# The port's tests; the counterpart of scripts/run/tests.sh.
#
# Usage:
#   scripts_torch/run/tests.sh [cpu] [pytest args...]   # tests/test_torch_port_*.py
#   scripts_torch/run/tests.sh cuda [pytest args...]    # the kernel tests on the card
#
# cpu holds the port against the JAX package on the CPU, so it needs JAX and
# pandas; with >1 CPU, pytest-xdist shards by file as scripts/run/tests.sh
# does. cuda runs tests/test_torch_port_cuda.py without tests/conftest.py
# (--noconftest: that file imports jax), so it needs neither JAX nor pandas
# and runs on the card's machine.
set -euo pipefail
ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="${ROOT}${PYTHONPATH:+:${PYTHONPATH}}"
cd "${ROOT}"

MODE="${1:-cpu}"
if [ $# -gt 0 ]; then shift; fi

case "${MODE}" in
    cpu)
        # the CPUs this process may run on (nproc would read OMP_NUM_THREADS)
        NPROC=$(env -u OMP_NUM_THREADS -u OMP_THREAD_LIMIT nproc)
        XDIST=()
        if [ "${NPROC}" -gt 1 ]; then
            XDIST=(-n "${NPROC}" --dist loadfile)
        fi
        exec python3 -m pytest tests/test_torch_port_*.py -q "${XDIST[@]}" "$@"
        ;;
    cuda)
        exec python3 -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py "$@"
        ;;
    *)
        echo "usage: $0 [cpu|cuda] [pytest args...]" >&2
        exit 2
        ;;
esac
