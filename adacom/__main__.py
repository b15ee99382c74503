from adacom.shell import main

raise SystemExit(main())
