"""``python -m jubatus_tpu_torch.codegen <file.idl> ...`` (emit.main)."""

import sys

from jubatus_tpu_torch.codegen.emit import main

if __name__ == "__main__":
    sys.exit(main())
