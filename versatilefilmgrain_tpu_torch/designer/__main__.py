from .app import main
import sys

sys.exit(main())
