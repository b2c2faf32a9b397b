from metal_pathtracer.viewer.server import main

raise SystemExit(main())
