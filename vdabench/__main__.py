from .run import main

raise SystemExit(main())
