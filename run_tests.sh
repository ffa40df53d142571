#!/bin/bash
# CPU test runner (JAX's CPU backend; tests/conftest.py adds a virtual
# 8-device mesh). GPU-only tests: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
set -e
cd "$(dirname "$0")"

# Build (for this host) and load the native runtime FIRST, and fail loudly if
# it doesn't — a silent native.available()=False must never masquerade as a
# green run (reference bar: the whole runtime compiles or nothing ships).
JAX_PLATFORMS=cpu GXZ_REQUIRE_NATIVE=1 \
    python -c "from genozip_tpu import native; native.get()" \
    || { echo "FATAL: native runtime failed to build or load" >&2; exit 2; }

exec env JAX_PLATFORMS=cpu python -m pytest tests/ -q "$@"
