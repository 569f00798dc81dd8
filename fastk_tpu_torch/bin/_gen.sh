#!/bin/sh
# regenerate the port's CLI launchers (from the repo root:
# sh fastk_tpu_torch/bin/_gen.sh)
set -e
cd "$(dirname "$0")"
for t in histex tabex profex fastrm fastmv fastcp logex symmex \
         fastmerge fastcat vennex haplex homex; do
  cat > "$t" <<SCRIPT
#!/bin/sh
# $t — host-only CLI launcher of the port: pure host code that never
# imports torch, so start-up is the interpreter and numpy.
# FASTK_PYTHON overrides the interpreter.
d=\$(CDPATH= cd -- "\$(dirname -- "\$0")/../.." && pwd)
PYTHONPATH="\$d\${PYTHONPATH:+:\$PYTHONPATH}" \\
  exec "\${FASTK_PYTHON:-python3}" -m fastk_tpu_torch.tools.$t "\$@"
SCRIPT
  chmod +x "$t"
done
for t in fastk kmermap; do
  cat > "$t" <<SCRIPT
#!/bin/sh
# $t — device-path CLI launcher of the port (counts on the CUDA card).
# FASTK_PYTHON overrides the interpreter.
d=\$(CDPATH= cd -- "\$(dirname -- "\$0")/../.." && pwd)
PYTHONPATH="\$d\${PYTHONPATH:+:\$PYTHONPATH}" \\
  exec "\${FASTK_PYTHON:-python3}" -m fastk_tpu_torch.tools.$t "\$@"
SCRIPT
  chmod +x "$t"
done
