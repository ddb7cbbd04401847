from vloam.cli import main

raise SystemExit(main())
